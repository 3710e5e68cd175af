"""The yardstick: published H100 SXM peaks and the work of each call.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): HBM
3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s; integer and
float64 instructions at 64 lanes an SM a clock over 132 SMs at the
1,980 MHz boost clock. They are frozen here, so a share is read against
the same peak whatever card or clock a run gets; the run prints the
card's power limit beside them.

A call's least time is the larger of its bytes over the bandwidth and,
for each kind of work, its operations over that kind's rate. Work is
counted from shapes alone, so a share reads the same work whatever
implements it: each input byte read once, each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SMS = 132
BOOST_HZ = 1.98e9
INT32_OPS_PER_S = 64 * SMS * BOOST_HZ
F64_OPS_PER_S = 64 * SMS * BOOST_HZ
#: integer instructions of one Threefry-2x32 hash (two key-schedule
#: XORs, 17 adds of key injections, 20 rounds of an add, a rotate and
#: an XOR) and of a float32 uniform from it (an XOR, a shift, an OR)
HASH_INT_OPS = 79
UNIFORM_INT_OPS = HASH_INT_OPS + 3
#: float64 instructions of a Poisson step's log (conversion in, about 20
#: on the path of libdevice's log, rounding out)
LOG_F64_OPS = 22


def least_s(nbytes: float, int_ops: float = 0.0, f32_flops: float = 0.0,
            f64_ops: float = 0.0) -> float:
    """The least seconds of work: its bytes or its slowest kind of
    operation at the peak rates."""
    return max(nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S,
               f32_flops / F32_FLOPS_PER_S, f64_ops / F64_OPS_PER_S)


def hist_s(n: int, n_feat: int, n_bins: int, n_slots: int,
           bin_bytes: int) -> float:
    """`hist_accumulate` over n rows: the bins, a slot id and the three
    float32 row values (g, h, w) read once, the (F*B, S*3) float32
    histogram written once; each row's two products and three float64
    adds for each of its F cells."""
    nbytes = n * (n_feat * bin_bytes + 16) + n_feat * n_bins * n_slots * 12
    return least_s(nbytes, f64_ops=n * (2 + 3 * n_feat))


def scan_s(n_feat: int, n_bins: int, width: int) -> float:
    """`split_scan` of an (F, B, W, 3) float32 histogram: it, the (W, F)
    mask and the (W,) least weights read once, the (6, W) pack written
    once; about 16 float32 operations a candidate (three prefix adds,
    two squares, two divisions, seven adds, two compares)."""
    nbytes = 12 * n_feat * n_bins * width + 4 * width * n_feat \
        + 4 * width + 24 * width
    return least_s(nbytes, f32_flops=16 * n_feat * n_bins * width)


def row_weights_s(rounds: int, elements: int, n_pad: int, mode: str,
                  rate: float) -> float:
    """`fit_row_weights`: a float32 weight a row written and a key pair a
    (round, element) read; a Bernoulli row one uniform and a compare; a
    Poisson row rate + 1 Knuth steps on average, each a uniform, a
    float64 log and a float32 add and compare."""
    rows = rounds * elements * n_pad
    nbytes = 4 * rows + 8 * rounds * elements
    if mode == "bernoulli":
        return least_s(nbytes, int_ops=rows * UNIFORM_INT_OPS,
                       f32_flops=2 * rows)
    steps = rows * (rate + 1.0)
    return least_s(nbytes, int_ops=steps * UNIFORM_INT_OPS,
                   f32_flops=3 * steps, f64_ops=steps * LOG_F64_OPS)


def fit_s(n: int, n_feat: int, n_bins: int, depth: int, trees: int,
          boosting: bool, weighted: bool) -> float:
    """The least seconds of a whole fit's necessary work, from the
    shapes alone: at every level of every tree the bins, each row's
    gradient, Hessian and node id (and weight, when rows are weighted)
    read once, three float64 adds a row and feature, and the level's
    float32 histogram of every node written once; every boosted round the
    labels and the margin read and the margin written once."""
    bin_bytes = 1 if n_bins <= 256 else (2 if n_bins <= 65536 else 4)
    row_bytes = 12 + (4 if weighted else 0)
    total = 0.0
    for level in range(depth):
        nbytes = n * (n_feat * bin_bytes + row_bytes) \
            + n_feat * n_bins * (2 ** level) * 12
        total += least_s(nbytes, f64_ops=3 * n * n_feat)
    if boosting:
        total += least_s(12 * n)
    return trees * total
