"""The port's histogram kernels (`sml_tpu_torch.native.hist_kernel`)
against the JAX package's: the plain PyTorch versions, which the wrappers
run on CPU tensors, are held against the Pallas kernels `hist_accumulate`
and `split_scan` of `sml_tpu/native/hist_kernel.py`, run in interpret
mode as `tests/test_hist_kernel.py` runs them. Inputs come from numpy
with a seed.

Tolerances:
- `hist_accumulate`: |port - jax| <= 1e-5 * (the same cell summed over
  |contributions|) + 1e-30. The two sum each cell's f32 products in
  another order (the JAX body in one f32 dot, the plain version in
  float64 rounded once), so they agree to f32 summation error relative
  to the cell's absolute mass, not to its possibly cancelled sum. The
  port's float64 sums are deliberately above the JAX package's f32 ones:
  they make the card's kernel and this plain version give the same bits.
- `split_scan`: exact, on histograms of dyadic values. Every prefix sum
  of such values is exact in f32, so both packages see the same GL, HL
  and WL, and every later operation is one rounded f32 operation in the
  same association.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu_torch.native import hist_kernel as hk


def _rows(rng, n, n_feat, n_bins, n_slots, dtype, zero_share=0.2):
    binned = rng.integers(0, n_bins, size=(n, n_feat)).astype(dtype)
    lid = rng.integers(0, n_slots, size=n).astype(np.int32)
    lid[:n_slots] = np.arange(n_slots)            # a row in every slot
    grad = rng.normal(0, 2.0, n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    weight = rng.integers(1, 4, n).astype(np.float32)
    weight[rng.random(n) < zero_share] = 0.0       # rows left out
    weight[:n_slots] = 1.0
    return binned, lid, grad, hess, weight


def _jax_hist(binned, lid, grad, hess, weight, n_bins, n_slots):
    from sml_tpu.native.hist_kernel import hist_accumulate
    return np.asarray(hist_accumulate(
        jnp.asarray(binned), jnp.asarray(lid), jnp.asarray(grad),
        jnp.asarray(hess), jnp.asarray(weight), n_bins=n_bins,
        n_slots=n_slots, interpret=True))


def _port_hist(binned, lid, grad, hess, weight, n_bins, n_slots):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (binned, lid, grad, hess, weight)]
    return hk.hist_accumulate(*t, n_bins=n_bins, n_slots=n_slots).numpy()


@pytest.mark.parametrize("dtype, n_bins", [(np.uint8, 32), (np.uint16, 300)])
@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_hist_accumulate_matches_jax(dtype, n_bins, n_slots):
    rng = np.random.default_rng([n_bins, n_slots])
    rows = _rows(rng, 3000, 5, n_bins, n_slots, dtype)
    got = _port_hist(*rows, n_bins, n_slots)
    want = _jax_hist(*rows, n_bins, n_slots)
    binned, lid, grad, hess, weight = rows
    scale = _port_hist(binned, lid, np.abs(grad), np.abs(hess), weight,
                       n_bins, n_slots)
    assert got.shape == want.shape == (5 * n_bins, n_slots * 3)
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-30).all()
    # the count channel is integer-valued and exact in both
    np.testing.assert_array_equal(got[:, 2::3], want[:, 2::3])
    # every weighted row lands in one cell per feature
    assert got[:, 2::3].sum() == pytest.approx(5 * weight.sum())


def test_hist_accumulate_drops_out_of_range_slots_and_bins():
    """A row whose slot or bin lies outside [0, S) or [0, B) adds
    nothing, as its one-hot row is zero in the JAX body."""
    rng = np.random.default_rng(3)
    binned, lid, grad, hess, weight = _rows(rng, 500, 3, 16, 4, np.int32)
    lid[::7] = 4          # past the last slot
    lid[::11] = -1
    binned[::5, 1] = 16   # past the last bin
    binned[::9, 2] = -3
    got = _port_hist(binned, lid, grad, hess, weight, 16, 4)
    want = _jax_hist(binned, lid, grad, hess, weight, 16, 4)
    np.testing.assert_array_equal(got[:, 2::3], want[:, 2::3])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _dyadic_hist(rng, n_feat, n_bins, width):
    """Histogram cells of multiples of 1/8 (G), 1/4 (H) and whole counts
    (W): every sum of them is exact in f32."""
    h = np.zeros((n_feat, n_bins, width, 3), np.float32)
    h[..., 0] = rng.integers(-64, 64, size=h.shape[:3]) / 8.0
    h[..., 2] = rng.integers(0, 6, size=h.shape[:3])
    h[..., 1] = h[..., 2] * rng.integers(1, 5, size=h.shape[:3]) / 4.0
    # feature 1 repeats feature 0: its candidates tie exactly with
    # feature 0's, so the lower flat index must win
    h[1] = h[0]
    # node 1: one bin holds all rows, so no candidate keeps both sides
    h[:, :, 1] = 0.0
    h[:, 2, 1] = [1.0, 2.0, 4.0]
    # node 2: zero Hessian everywhere (the lambda = 0 case)
    h[:, :, 2, 1] = 0.0
    # node 3: huge gradients and no Hessian, so squared sums overflow
    # and inf - inf makes NaN scores
    h[:, :, 3, 0] = np.where(np.arange(n_bins) % 2 == 0, 2.0 ** 70, 0.0)
    h[:, :, 3, 1] = 0.0
    return h


def _jax_scan(hist, fmask, mi, lam, gamma):
    from sml_tpu.native.hist_kernel import split_scan
    return np.asarray(split_scan(
        jnp.asarray(hist), jnp.asarray(fmask),
        jnp.asarray(np.full((1, 1), mi, np.float32)), reg_lambda=lam,
        gamma=gamma, interpret=True))


def _port_scan(hist, fmask, mi, lam, gamma):
    """The port's scan with `mi` for every node (a sequential fit's
    broadcast minimum)."""
    return hk.split_scan(torch.from_numpy(hist), torch.from_numpy(fmask),
                         torch.full((hist.shape[2],), float(mi)),
                         reg_lambda=lam, gamma=gamma).numpy()


@pytest.mark.parametrize("lam, gamma, mi, masked", [
    (1.0, 0.0, 1.0, False),
    (0.0, 0.0, 1.0, False),     # lambda 0: only the 1e-12 guard
    (1.0, 0.25, 3.0, False),    # gamma > 0, min_inst > 1
    (0.5, 0.0, 1.0, True),      # feature masks, one node all masked
])
def test_split_scan_matches_jax_exactly(lam, gamma, mi, masked):
    rng = np.random.default_rng([int(lam * 4), int(mi), int(masked)])
    n_feat, n_bins, width = 4, 12, 6
    hist = _dyadic_hist(rng, n_feat, n_bins, width)
    fmask = np.ones((width, n_feat), np.float32)
    if masked:
        fmask[0, [0, 2]] = 0.0
        fmask[4] = 0.0          # a node with every feature masked
        fmask[5, 0] = 0.0
    got = _port_scan(hist, fmask, mi, lam, gamma)
    want = _jax_scan(hist, fmask, mi, lam, gamma)
    assert got.shape == want.shape == (6, width)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(want[2, 3])                 # the first NaN won
    assert want[2, 1] == -np.inf and want[:2, 1].tolist() == [0.0, 0.0]
    if masked:
        assert want[2, 4] == -np.inf and want[:2, 4].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("lam, gamma", [(0.0, 0.0), (1.0, 0.25)])
def test_split_scan_per_node_min_inst_matches_vmapped_jax(lam, gamma):
    """A fused fit's scan: the nodes of E elements side by side, node
    e * width + j held to element e's least child weight. The JAX
    package gets the same by vmapping its scan over the elements, each
    with a (1, 1) minimum (`sml_tpu/ml/tree_impl.py:567`); exact on
    dyadic histograms."""
    import jax
    from sml_tpu.native.hist_kernel import split_scan
    rng = np.random.default_rng([7, int(lam), int(gamma * 4)])
    n_feat, n_bins, width = 4, 12, 6
    mins = np.asarray([1.0, 2.0, 5.0, 1.0, 3.0], np.float32)
    E = len(mins)
    hists = np.stack([_dyadic_hist(rng, n_feat, n_bins, width)
                      for _ in range(E)])             # (E, F, B, w, 3)
    fmasks = (rng.random((E, width, n_feat)) > 0.3).astype(np.float32)
    want = np.asarray(jax.vmap(lambda h, m, mi: split_scan(
        h, m, mi, reg_lambda=lam, gamma=gamma, interpret=True))(
            jnp.asarray(hists), jnp.asarray(fmasks),
            jnp.asarray(mins.reshape(E, 1, 1))))      # (E, 6, w)
    hist = np.ascontiguousarray(
        hists.transpose(1, 2, 0, 3, 4).reshape(n_feat, n_bins, E * width, 3))
    got = hk.split_scan(torch.from_numpy(hist),
                        torch.from_numpy(fmasks.reshape(E * width, n_feat)),
                        torch.from_numpy(np.repeat(mins, width)),
                        reg_lambda=lam, gamma=gamma).numpy()
    np.testing.assert_array_equal(
        got, want.transpose(1, 0, 2).reshape(6, E * width))
    # the minimum matters: a single broadcast one gives another pack
    one = _port_scan(hist, fmasks.reshape(E * width, n_feat), 1.0, lam,
                     gamma)
    assert not np.array_equal(np.nan_to_num(one), np.nan_to_num(got))


def test_split_scan_uses_each_features_own_totals():
    """The score takes each feature's own totals; the pack's G, H and W
    are feature 0's. Feature 2 here sums to other totals than feature 0
    (as a subtraction-derived histogram may, by rounding), and both
    packages score it against its own."""
    rng = np.random.default_rng(11)
    hist = _dyadic_hist(rng, 3, 8, 4)
    hist[2, :, :, 0] += 0.125                 # feature 2: other totals
    fmask = np.ones((4, 3), np.float32)
    got = _port_scan(hist, fmask, 1.0, 1.0, 0.0)
    want = _jax_scan(hist, fmask, 1.0, 1.0, 0.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], hist[0, :, :, 0].sum(axis=0))


def test_wrappers_refuse_bad_operands():
    n = 8
    b = torch.zeros((n, 2), dtype=torch.uint8)
    lid = torch.zeros(n, dtype=torch.int32)
    f = torch.ones(n)
    with pytest.raises(TypeError):
        hk.hist_accumulate(b.to(torch.int64), lid, f, f, f, n_bins=4,
                           n_slots=1)
    with pytest.raises(TypeError):
        hk.hist_accumulate(b, lid.to(torch.int64), f, f, f, n_bins=4,
                           n_slots=1)
    with pytest.raises(ValueError):
        hk.hist_accumulate(b, lid, f[:-1], f, f, n_bins=4, n_slots=1)
    with pytest.raises(ValueError):
        hk.hist_accumulate(b, lid, f, f, torch.ones(n, device="meta"),
                           n_bins=4, n_slots=1)
    hist = torch.zeros((2, 4, 3, 3))
    fm = torch.ones((3, 2))
    mi = torch.ones(3)
    with pytest.raises(TypeError):
        hk.split_scan(hist.double(), fm, mi, reg_lambda=1.0, gamma=0.0)
    with pytest.raises(ValueError):
        hk.split_scan(hist, fm.T.contiguous(), mi, reg_lambda=1.0, gamma=0.0)
    with pytest.raises(ValueError):
        hk.split_scan(hist, fm, torch.ones(3, device="meta"),
                      reg_lambda=1.0, gamma=0.0)
    with pytest.raises(ValueError, match="one a node"):
        hk.split_scan(hist, fm, torch.ones((1, 1)), reg_lambda=1.0,
                      gamma=0.0)


#: the benchmark cell's level shapes (HIGGS: 10.5M x 28 uint8 rows, 256
#: bins; 1, 2, 4, 8 and 16 slots with histogram subtraction), and the
#: course's: ML 11's XGBoost (80,000 rows, 64 bins, up to 32 slots) and
#: the fused ML 07 grid's last level (640,008 rows, 40 bins, 96 slots)
HIGGS_LEVELS = [(10_500_000, 28, 256, s, 1, 8) for s in (1, 2, 4, 8, 16)]
COURSE_LEVELS = [(80_000, 10, 64, s, 1, 8) for s in (1, 2, 4, 8, 16, 32)] \
    + [(640_008, 10, 40, 96, 1, 8)]
#: shapes whose plans read the rows in several passes of tile-split
#: clusters, with ranks that own no tile (`chip_smoke.HIST_PASS_SHAPES`)
PASS_SHAPES = [(1_000_000, 220, 256, 2, 1, 8), (2_000_000, 250, 256, 1, 1, 8)]


@pytest.mark.parametrize("n, n_feat, n_bins, n_slots, bin_bytes, acc_bytes", [
    (80_000, 10, 64, 1, 1, 8), (80_000, 10, 64, 16, 1, 8),
    (80_000, 10, 64, 32, 1, 8), (64_000, 10, 40, 16, 1, 8),
    (80_000, 10, 300, 32, 2, 8), (50_000, 4, 70_000, 2, 4, 8),
    (5, 3, 8, 1, 1, 8), (1_000_000, 10, 256, 64, 1, 8),
    (80_000, 10, 64, 16, 1, 4), (80_001, 10, 64, 8, 1, 8),
    (3_001, 400, 16, 4, 4, 8), (16_000, 10, 64, 4, 1, 8)]
    + HIGGS_LEVELS + COURSE_LEVELS + PASS_SHAPES)
def test_hist_plan_fits_shared_memory_and_covers_every_row(
        n, n_feat, n_bins, n_slots, bin_bytes, acc_bytes):
    """The launch of `hist_accumulate` fits the card (shared memory of a
    block and of an SM, threads and registers, cluster size, every
    cluster of a tile-split plan resident at once, grid limits), gives
    every cell of the histogram to exactly one tile, covers every row
    exactly once a pass, stages rows with bulk copies whose addresses and
    sizes are multiples of 16 bytes, and keeps the partials within their
    bound. The benchmark cell's levels of up to 4 slots read their rows
    once, for every tile; its deeper levels and the course's small calls
    take clusters that split a tile's rows."""
    p = hk.hist_plan(n, n_feat, n_bins, n_slots, bin_bytes=bin_bytes,
                     acc_bytes=acc_bytes)
    assert 1 <= p.bt <= n_bins and 1 <= p.st <= n_slots
    assert 1 <= p.ft <= n_feat
    # one warp per (feature, slot group), one lister per group, the
    # producer; within a block's threads and 64 registers a thread
    assert 1 <= p.groups <= p.st
    assert 32 * ((p.ft + 1) * p.groups + 1) <= p.threads <= 1024
    assert p.threads % 32 == 0 and p.split_rows in (0, 1)
    assert p.threads * hk._REGS <= 65536
    # the slot groups (ceil(st / groups) slots each) cover the tile's slots
    gs = -(-p.st // p.groups)
    assert (p.groups - 1) * gs < p.st <= p.groups * gs
    # shared memory: the kernel's layout, a block's limit, and at least
    # one resident block per SM with its reserved kilobyte
    row_bins = n_feat * bin_bytes if p.stage_bins else 0
    stages = hk._RS_STAGES if p.split_rows else hk._STAGES
    assert p.smem == hk.hist_smem(acc_bytes, p.ft, p.bt, p.st, p.groups,
                                  p.sub_rows, row_bins, stages)
    assert p.smem <= 227 * 1024
    per_sm = min((228 * 1024) // (p.smem + 1024), 2048 // p.threads)
    assert per_sm >= 1
    assert p.sub_rows * row_bins <= hk._STAGE_BIN_BYTES
    assert p.sub_rows in hk._SUB_ROWS or p.sub_rows == p.chunk_rows
    assert p.sub_rows < 2 ** 16          # row lists hold uint16
    # tiles: a cluster's blocks hold `cluster` of them a pass, and every
    # cell lies in exactly one tile
    tiles = -(-n_feat // p.ft) * -(-n_bins // p.bt) * -(-n_slots // p.st)
    assert 1 <= p.cluster <= 8
    if p.split_rows:      # a tile a cluster, its rows over the blocks
        assert p.passes == tiles and p.n_chunks % p.cluster == 0
        parts = p.n_chunks // p.cluster
    else:                 # `cluster` tiles a cluster, its rows read once
        assert p.passes == -(-tiles // p.cluster)
        assert (p.passes - 1) * p.cluster < tiles <= p.passes * p.cluster
        parts = p.n_chunks
    owned = np.zeros((n_feat, n_bins, n_slots), np.int8) \
        if n_feat * n_bins * n_slots <= 10 ** 7 else None
    if owned is not None:
        n_bt, n_st = -(-n_bins // p.bt), -(-n_slots // p.st)
        for t in range(tiles):
            f0, b0, s0 = (t // (n_bt * n_st) * p.ft, t // n_st % n_bt * p.bt,
                          t % n_st * p.st)
            owned[f0:f0 + p.ft, b0:b0 + p.bt, s0:s0 + p.st] += 1
        assert (owned == 1).all()
    # every cluster of every pass of a tile-split plan resident at once
    # (the clusters an H100 SXM holds) unless the passes alone outnumber
    # them, within the grid's limits
    if not p.split_rows:
        assert p.passes * p.n_chunks \
            <= max(p.passes, hk._CLUSTER_SLOTS[p.cluster - 1] * per_sm)
    assert p.n_chunks * p.cluster < 2 ** 31 and p.passes <= 65535
    if parts > 1:
        assert parts * n_feat * n_bins * n_slots * 3 * acc_bytes \
            <= hk._SCRATCH_BYTES
    shape = (n, n_feat, n_bins, n_slots, bin_bytes, acc_bytes)
    if shape in HIGGS_LEVELS:
        assert (p.split_rows, p.passes) == ((0, 1) if n_slots <= 4
                                            else (1, tiles))
    if shape in COURSE_LEVELS:
        assert p.split_rows == 1
    if shape in PASS_SHAPES:
        assert not p.split_rows and p.passes >= 2
    # rows: row ranges and their staged sub-chunks cover [0, n) exactly
    # once (a pass), at 16-byte-aligned offsets, in bulk copies of
    # multiples of 16 bytes
    assert p.chunk_rows % 32 == 0 and p.sub_rows % 32 == 0
    assert p.sub_rows <= p.chunk_rows
    assert n <= p.n_chunks * p.chunk_rows    # trailing ranges may be empty
    if not p.split_rows:
        assert (p.n_chunks - 1) * p.chunk_rows < n
    edges = np.zeros(n + 1, np.int64)   # +1 where a sub-chunk starts,
    for c in range(p.n_chunks):         # -1 where it ends
        begin, end = c * p.chunk_rows, min((c + 1) * p.chunk_rows, n)
        r = np.arange(begin, end, p.sub_rows)
        cnt = np.minimum(p.sub_rows, end - r)
        np.add.at(edges, r, 1)
        np.add.at(edges, r + cnt, -1)
        bulk = cnt & ~15
        assert ((r * n_feat * bin_bytes) % 16 == 0).all()
        assert ((r * 4) % 16 == 0).all()
        assert ((bulk * n_feat * bin_bytes) % 16 == 0).all()
        # only the matrix's last rows are left to plain loads
        assert ((cnt == bulk) | (r + cnt == n)).all()
    assert (np.cumsum(edges[:n]) == 1).all()


#: the launches the course's calls took before tile-split clusters came
#: in (chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
#: stage_bins): ML 11 at each slot count, the fused ML 07 grid's last
#: level, and the float64-output shapes of a mesh's ranks
BEFORE = {
    (80_000, 10, 64, 1): (384, 224, 10, 64, 1, 1, 8, 256, 1),
    (80_000, 10, 64, 2): (384, 224, 10, 64, 2, 1, 8, 256, 1),
    (80_000, 10, 64, 4): (384, 224, 5, 64, 4, 1, 8, 256, 1),
    (80_000, 10, 64, 8): (736, 112, 4, 64, 8, 1, 8, 256, 1),
    (80_000, 10, 64, 16): (1280, 64, 2, 64, 16, 2, 8, 256, 1),
    (80_000, 10, 64, 32): (2528, 32, 1, 64, 32, 4, 8, 256, 1),
    (640_008, 10, 40, 96): (4224, 152, 1, 40, 48, 4, 8, 256, 1),
    (40_000, 10, 64, 16): (640, 64, 2, 64, 16, 2, 8, 256, 1),
    (20_000, 10, 64, 16): (384, 56, 2, 64, 16, 2, 8, 256, 1),
    (160_008, 10, 40, 96): (4032, 40, 1, 40, 48, 4, 8, 256, 1),
}


@pytest.mark.parametrize("shape", sorted(BEFORE))
def test_course_plans_keep_their_row_split_launches(shape):
    """The course's calls keep the row-split launches they had before
    tile-split clusters: the same row ranges, tiles, slot groups, staged
    sub-chunks and clusters (a block's ring of `_RS_STAGES` sub-chunks
    leaves room for as many blocks an SM), with one more warp a block,
    the producer's."""
    p = hk.hist_plan(*shape)
    assert p.split_rows == 1
    assert (p.chunk_rows, p.n_chunks, p.ft, p.bt, p.st, p.groups, p.cluster,
            p.sub_rows, p.stage_bins) == BEFORE[shape]
    assert p.threads == 32 * max((p.ft + 1) * p.groups + 1, 8)


def test_hist_plan_reads_a_higgs_tree_in_88_passes():
    """The benchmark cell's six histogram levels (1, 1, 2, 4, 8 and 16
    slots) read their 10.5M rows 88 times a tree, where one pass a tile
    read them 113 times: once at each of the four levels of up to 4
    slots, once a tile at the two deeper ones."""
    plans = [hk.hist_plan(10_500_000, 28, 256, s) for s in (1, 1, 2, 4, 8, 16)]
    assert [p.passes for p in plans] == [1, 1, 1, 1, 28, 56]
    assert [p.split_rows for p in plans] == [0, 0, 0, 0, 1, 1]


def test_row_passes_count_each_launch_plan(monkeypatch):
    """`ROW_PASSES` advances by the plan's passes with each launch (and
    `LAUNCHES` by one), through the wrapper's launch path with the
    kernel's call stubbed."""
    launched = []
    monkeypatch.setattr(hk, "_kernel", lambda name, entry="": name + entry)
    monkeypatch.setattr(hk.build, "launch_on_stream",
                        lambda dev, fn, *args, record=None:
                        launched.append((fn, args)) or 0)
    passes0 = hk.ROW_PASSES["hist_accumulate"]
    launches0 = hk.LAUNCHES["hist_accumulate"]
    want = 0
    for n, n_feat, n_bins, n_slots, dtype in [
            (80_000, 10, 64, 16, torch.uint8), (50_000, 4, 70_000, 2,
                                                torch.int32),
            (3_001, 400, 16, 4, torch.int32), (5, 3, 8, 1, torch.uint8)]:
        binned = torch.zeros((n, n_feat), dtype=dtype)
        lid = torch.zeros(n, dtype=torch.int32)
        f = torch.ones(n)
        out = hk._launch_level(binned, lid, f, f, f, n_bins, n_slots,
                               torch.float32)
        assert out.shape == (n_feat * n_bins, n_slots * 3)
        plan = hk.hist_plan(n, n_feat, n_bins, n_slots,
                            bin_bytes=binned.element_size())
        want += plan.passes
        assert launched[-1][0] == "hist_accumulate"
        assert hk.ROW_PASSES["hist_accumulate"] - passes0 == want
    assert want > 4     # some plans take more than one pass
    assert hk.LAUNCHES["hist_accumulate"] - launches0 == 4


@pytest.mark.parametrize("n_feat, n_bins, width", [
    (10, 64, 1), (10, 64, 2), (10, 64, 4), (10, 64, 8), (10, 64, 16),
    (10, 64, 32), (10, 40, 16), (10, 300, 32), (10, 5000, 4), (40, 64, 8)])
def test_scan_plan_fits_shared_memory(n_feat, n_bins, width):
    """The launch of `split_scan` at every shape `chip_smoke.py` checks,
    the 5,000-bin node past 48 KB included: a block per node within 48
    KB of shared memory (static included), one warp per feature up to the limit, and bin
    segments that cover every bin of a feature."""
    p = hk.scan_plan(n_feat, n_bins)
    assert p.warps == min(n_feat, hk._SCAN_MAX_WARPS) <= 32
    # dynamic within 47 KB, so that with its 256 static bytes the block
    # stays within 48 KB without opting in
    assert p.smem == 12 * p.seg * p.warps <= 47 * 1024
    assert 1 <= p.seg <= n_bins
    # a feature is staged whole (one pass) whenever the block's warps
    # can hold their features whole
    assert (p.seg == n_bins) == (12 * p.warps * n_bins <= 47 * 1024)
    starts = range(0, n_bins, p.seg)
    assert sum(min(p.seg, n_bins - b0) for b0 in starts) == n_bins
    assert width < 2 ** 31   # one block per node on the grid's x axis


def test_hist_wrapper_refuses_unaligned_operands():
    """Bulk copies need 16-byte-aligned operands: a view at an odd offset
    raises instead of being copied."""
    w = torch.ones(33)
    hk.check_aligned(w[:32], torch.zeros((4, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="16-byte"):
        hk.check_aligned(w[1:])
