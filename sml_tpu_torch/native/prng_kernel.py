"""The sampled fits' two draw kernels, a whole fit at a time: the row
weights of every round and the feature subspace of every level of every
round, for E elements at once.

`fit_row_weights` and `fit_feature_masks` wrap the CUDA kernels of
`sml_tpu_torch/csrc/threefry.cu`, which replace the `jax.random` calls
that XLA compiles into the JAX package's fit program
(`sml_tpu/ml/tree_impl.py:551-553` and `:785-796`, and the grid-fused
program's `:1318-1350`). Both give jax 0.9.0's bits (`utils/prng.py`),
except that a Poisson count may differ from jax's where a row's f32
log-sum lies within an ulp or two of -rate (the port takes the log in
float64 and rounds it to f32).

A fit serves E elements (the (grid point x fold) fits of a fused tuning
fit; a sequential fit is E = 1) and draws R rounds at once under keys
derived on the host (`tree_impl.fit_keys`) and copied to the device with
the fit's other keys: round r's (E, 2) uint32 weight keys, and its
(D, E, 2) level keys. Each round's keys must be contiguous; the rounds
may lie apart (any stride), so rounds t0..T-1 of a fit are a view of its
key tensor. Per element a mode, rate and row count (`weight_table`) or a
feature count k. Element e draws over its own flat indices, so its
values are those of its own one-element draw.

The operands' device decides where a draw runs: the CPU runs the plain
PyTorch version (`fit_row_weights_plain`, `fit_feature_masks_plain`,
round by round and level by level over `row_weights_plain` and
`feature_mask_plain`), a CUDA device launches the kernel on its current
stream or raises. Nothing falls back. The launch plans (`draw_plan`,
`mask_plan`) come from the shapes and, for the weights, the card's SM
count.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence

import torch

from ..utils import prng
from . import build

#: kernel launches made by each wrapper in this process
LAUNCHES = {"row_weights": 0, "feature_mask": 0}
_count_lock = threading.Lock()
_fns = {}
_SMS = {}     # device index -> SM count

#: the row-weight samplers, by their code in the kernel
MODES = {"bernoulli": 0, "poisson": 1, "ones": 2}
#: threads of a row-weights block
_DRAW_THREADS = 256
#: rows a row-weights thread may draw, most first (the kernel is built
#: for each): `draw_plan` takes the most that still leaves the grid
#: 1,024 threads an SM. More rows share a thread's walk of the key
#: chain; fewer threads would leave SMs idle over a round or two
#: (`scripts/torch_draw_rows_sweep.py`, `PERF.md` §6)
_DRAW_ROWS = (8, 4, 2, 1)
_DRAW_THREADS_PER_SM = 1024
#: (round, element) rows of one row-weights launch: the grid's y extent
MAX_ROUND_ELEMENTS = 65535
#: warps (nodes) of a feature-mask block, and a block's shared memory
#: past 32 features (a warp holds its node's F uniforms, within the 48 KB
#: a block has without opting in)
_MASK_WARPS = 8
_MASK_SMEM = 48 * 1024


class DrawPlan(NamedTuple):
    threads: int      # per block
    rows: int         # per thread, strided by the block's width
    blocks: int       # per (round, element)


class MaskPlan(NamedTuple):
    warps: int        # per block, one node each
    blocks: int
    smem: int         # dynamic shared memory of a block, in bytes


def draw_plan(n: int, lines: int, sms: int) -> DrawPlan:
    """The launch of `fit_row_weights` over `lines` (round, element) rows
    of n rows each on a card of `sms` SMs: blocks of 256 threads, a row
    of them per (round, element), each thread over the most rows (8, 4,
    2 or 1) that still leaves 1,024 threads an SM, else over one."""
    for rows in _DRAW_ROWS:
        blocks = max(1, -(-n // (_DRAW_THREADS * rows)))
        if rows == 1 or lines * blocks * _DRAW_THREADS \
                >= sms * _DRAW_THREADS_PER_SM:
            return DrawPlan(_DRAW_THREADS, rows, blocks)


def mask_plan(n_nodes: int, n_features: int) -> MaskPlan:
    """The launch of `fit_feature_masks` over `n_nodes` nodes (every
    (round, element, node) of every level): a warp a node, 8 a block (up
    to 48 KB of shared memory past 32 features, so fewer past 1,536).
    Raises ValueError past 12,288 features."""
    if n_features > _MASK_SMEM // 4:
        raise ValueError(f"feature_mask holds a node's uniforms in 48 KB of "
                         f"shared memory: at most {_MASK_SMEM // 4} "
                         f"features, got {n_features}")
    warps = _MASK_WARPS if n_features <= 32 \
        else min(_MASK_WARPS, _MASK_SMEM // (4 * n_features))
    smem = 4 * warps * n_features if n_features > 32 else 0
    return MaskPlan(warps, max(1, -(-n_nodes // warps)), smem)


def weight_table(modes: Sequence[str], rates: Sequence[float],
                 counts: Sequence[int], device):
    """The per-element operands of `fit_row_weights` on `device`, checked
    on the host and copied once: (modes int32, rates f32, counts int32).
    `modes` are "ones", "bernoulli" (1 where the row's uniform is below
    the rate) or "poisson" (a Knuth count, rate in [0, 10)); an element's
    rows at or past its count weigh 0."""
    if not len(modes) == len(rates) == len(counts) >= 1:
        raise ValueError("one mode, rate and row count an element")
    for mode, rate, n in zip(modes, rates, counts):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                             f"{mode!r}")
        if mode == "poisson" and not 0.0 <= rate < prng.KNUTH_MAX_RATE:
            raise ValueError(f"Poisson rates are drawn by Knuth's loop only "
                             f"in [0, {prng.KNUTH_MAX_RATE}), got {rate}")
        if not 0 <= n < 2 ** 31:
            raise ValueError(f"row count must be in [0, 2^31), got {n}")
    dev = _device(device, "row_weights")
    return (torch.tensor([MODES[m] for m in modes], dtype=torch.int32,
                         device=dev),
            torch.tensor(list(rates), dtype=torch.float32, device=dev),
            torch.tensor(list(counts), dtype=torch.int32, device=dev))


# ------------------------------------------------------------ plain
def row_weights_plain(keys: torch.Tensor, modes: torch.Tensor,
                      rates: torch.Tensor, counts: torch.Tensor,
                      n_pad: int) -> torch.Tensor:
    """The (E * n_pad,) f32 weights of one round, element by element:
    ones, Bernoulli(rate) as 0/1 or Poisson(rate) counts
    (`prng.bernoulli`, `prng.poisson_knuth`) over the element's n_pad
    rows, 0 past its row count."""
    dev = keys.device
    out = []
    for key, mode, rate, n in zip(keys.tolist(), modes.tolist(),
                                  rates.tolist(), counts.tolist()):
        if mode == MODES["ones"]:
            w = torch.ones(n_pad, dtype=torch.float32, device=dev)
        elif mode == MODES["bernoulli"]:
            w = prng.bernoulli(key, rate, n_pad, dev).to(torch.float32)
        else:
            w = prng.poisson_knuth(key, rate, n_pad, dev).to(torch.float32)
        w[n:] = 0.0
        out.append(w)
    return torch.cat(out)


def feature_mask_plain(keys: torch.Tensor, ks: torch.Tensor, width: int,
                       n_features: int) -> torch.Tensor:
    """The (E * width, F) f32 mask of a level, element by element: 1
    where a feature's rank among its node's uniforms is below the
    element's k (`prng.feature_mask`)."""
    return torch.cat([
        prng.feature_mask(key, width, n_features, k, keys.device)
        for key, k in zip(keys.tolist(), ks.tolist())]).to(torch.float32)


def fit_row_weights_plain(keys: torch.Tensor, modes: torch.Tensor,
                          rates: torch.Tensor, counts: torch.Tensor,
                          n_pad: int) -> torch.Tensor:
    """The (R, E * n_pad) f32 weights of R rounds, round by round
    (`row_weights_plain` under each round's (E, 2) keys)."""
    return torch.stack([row_weights_plain(k, modes, rates, counts, n_pad)
                        for k in keys]) if keys.shape[0] else \
        torch.empty((0, keys.shape[1] * n_pad), dtype=torch.float32,
                    device=keys.device)


def fit_feature_masks_plain(keys: torch.Tensor, ks: torch.Tensor,
                            n_features: int) -> torch.Tensor:
    """The (R, E * (2^D - 1), F) f32 masks of R rounds of D levels,
    round by round and level by level (`feature_mask_plain` of level L's
    2^L nodes under its (E, 2) keys), level-major inside a round."""
    R, D, E = keys.shape[:3]
    if R == 0:
        return torch.empty((0, E * (2 ** D - 1), n_features),
                           dtype=torch.float32, device=keys.device)
    return torch.stack([
        torch.cat([feature_mask_plain(keys[r, level], ks, 2 ** level,
                                      n_features) for level in range(D)])
        for r in range(R)])


# ------------------------------------------------------------ launches
_ARGTYPES = {
    "row_weights": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "feature_mask": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p] + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("threefry"), f"sml_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _device(device, name: str) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


def _round_stride(keys: torch.Tensor) -> int:
    """The uint32 words from one round's keys to the next."""
    return keys.stride(0) if keys.shape[0] > 1 else keys[0].numel()


def _check_keys(keys: torch.Tensor, name: str, n_lead: int,
                *per_elem) -> tuple:
    """The leading dims (R, ...) and E of an (R, ..., E, 2) uint32 key
    tensor whose rounds are each contiguous, with its per-element
    operands: (E,) tensors of the given dtypes, contiguous, on its
    device."""
    if keys.dim() != n_lead + 2 or keys.shape[-1] != 2 \
            or keys.dtype != torch.uint32:
        dims = ", ".join(["R", "D"][:n_lead] + ["E", "2"])
        raise TypeError(f"{name} keys must be an ({dims}) uint32 tensor, "
                        f"got {tuple(keys.shape)} {keys.dtype}")
    E = keys.shape[-2]
    for t, dtype in per_elem:
        if tuple(t.shape) != (E,) or t.dtype != dtype:
            raise TypeError(f"{name}: per-element operands must be ({E},) "
                            f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    ts = [t for t, _ in per_elem]
    inner = keys.shape[1:]
    packed = keys.numel() == 0 or (
        keys.stride()[1:] == torch.empty(inner, device="meta").stride()
        and (keys.shape[0] == 1 or keys.stride(0) >= inner.numel()))
    if len({t.device for t in ts + [keys]}) != 1 or not packed \
            or not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} operands must be on one device, each "
                         f"round's keys and the per-element operands "
                         f"contiguous")
    _device(keys.device, name)
    if not 1 <= E <= MAX_ROUND_ELEMENTS:
        raise ValueError(f"{name} draws for 1 to {MAX_ROUND_ELEMENTS} "
                         f"elements, got {E}")
    return tuple(keys.shape[:n_lead]), E


def fit_row_weights(keys: torch.Tensor, modes: torch.Tensor,
                    rates: torch.Tensor, counts: torch.Tensor,
                    n_pad: int) -> torch.Tensor:
    """The (R, E * n_pad) f32 row weights of R rounds of E elements, on
    the operands' device: round r's row under `keys[r]` ((R, E, 2), each
    round contiguous), element e's rows from e * n_pad, drawn by
    `modes[e]` at `rates[e]` (`weight_table` makes and checks the
    per-element operands), 0 at or past `counts[e]`. R * E is at most
    `MAX_ROUND_ELEMENTS`.

    On a CUDA device one launch draws every round (`draw_plan` for the
    card's SM count); on the CPU `fit_row_weights_plain` runs."""
    (R,), E = _check_keys(keys, "row_weights", 1, (modes, torch.int32),
                          (rates, torch.float32), (counts, torch.int32))
    if not 0 <= n_pad < 2 ** 31 or E * n_pad >= 2 ** 31:
        raise ValueError(f"row count must be in [0, 2^31), got {E} x "
                         f"{n_pad}")
    if R * E > MAX_ROUND_ELEMENTS:
        raise ValueError(f"row_weights draws at most {MAX_ROUND_ELEMENTS} "
                         f"(round, element) rows a launch, got {R} x {E}")
    dev = keys.device
    if dev.type == "cpu":
        return fit_row_weights_plain(keys, modes, rates, counts, n_pad)
    out = torch.empty((R, E * n_pad), dtype=torch.float32, device=dev)
    if R == 0 or n_pad == 0:
        return out
    _launch_row_weights(out, keys, modes, rates, counts, n_pad,
                        draw_plan(n_pad, R * E, _sm_count(dev)),
                        record=True)
    _count("row_weights")
    return out


def _sm_count(dev: torch.device) -> int:
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _launch_row_weights(out: torch.Tensor, keys: torch.Tensor,
                        modes: torch.Tensor, rates: torch.Tensor,
                        counts: torch.Tensor, n_pad: int,
                        plan: DrawPlan, record: bool = False) -> None:
    """One launch of the row-weights kernel under `plan` into `out`, on
    operands `fit_row_weights` has checked (a sweep over plans calls it
    too: `scripts/torch_draw_rows_sweep.py`). `record` puts the launch
    into the prewarm manifest (`fit_row_weights`' own)."""
    R, E = keys.shape[:2]
    err = build.launch_on_stream(
        out.device, _kernel("row_weights"), out.data_ptr(), keys.data_ptr(),
        _round_stride(keys), modes.data_ptr(), rates.data_ptr(),
        counts.data_ptr(), R, E, n_pad, plan.threads, plan.rows,
        plan.blocks,
        record=("row_weights", plan, [keys, modes, rates, counts],
                {"n_pad": int(n_pad)}) if record else None)
    if err != 0:
        raise RuntimeError(f"row_weights launch failed: CUDA error {err} "
                           f"(R={R}, E={E}, n_pad={n_pad}, {plan})")


def fit_feature_masks(keys: torch.Tensor, ks: torch.Tensor,
                      n_features: int) -> torch.Tensor:
    """The (R, E * (2^D - 1), n_features) f32 feature masks of R rounds
    of D levels of E elements, on the operands' device. Within a round
    level L's E * 2^L rows start at row E * (2^L - 1), element-major,
    then node: row E * (2^L - 1) + e * 2^L + j is node j of element e,
    1 where a feature's rank among the node's uniforms under
    `keys[r, L, e]` ((R, D, E, 2), each round contiguous; ties to the
    lower index) is below `ks[e]`.

    On a CUDA device one launch draws every node, a warp a node
    (`mask_plan`); on the CPU `fit_feature_masks_plain` runs."""
    (R, D), E = _check_keys(keys, "feature_mask", 2, (ks, torch.int32))
    if D < 1 or n_features < 1 or \
            E * (2 ** D - 1) * n_features >= 2 ** 31:
        raise ValueError(f"empty or oversized mask ({E} x {D} levels, "
                         f"{n_features})")
    dev = keys.device
    if dev.type == "cpu":
        return fit_feature_masks_plain(keys, ks, n_features)
    out = torch.empty((R, E * (2 ** D - 1), n_features),
                      dtype=torch.float32, device=dev)
    if R == 0:
        return out
    plan = mask_plan(R * E * (2 ** D - 1), n_features)
    err = build.launch_on_stream(
        dev, _kernel("feature_mask"), out.data_ptr(), keys.data_ptr(),
        _round_stride(keys), ks.data_ptr(), R, E, D, n_features, plan.warps,
        plan.blocks,
        record=("feature_mask", plan, [keys, ks],
                {"n_features": int(n_features)}))
    if err != 0:
        raise RuntimeError(f"feature_mask launch failed: CUDA error {err} "
                           f"(R={R}, E={E}, D={D}, F={n_features}, {plan})")
    _count("feature_mask")
    return out
