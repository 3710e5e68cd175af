"""The port's traversal (`sml_tpu_torch.native.traverse_kernel`) against
the JAX package's: the plain PyTorch version, which the wrapper runs on
CPU tensors, is held against `sml_tpu.ml.inference._forest_margin` and
against the Pallas kernel `forest_traverse` in interpret mode, on
ensembles fitted by the JAX package (DT, RF, boosted), with uint8,
uint16 (maxBins 300) and int32 bin matrices, rows with NaN features,
and early leaves.

Tolerance: the leaf each tree picks is exact in both packages; only the
f32 sum over trees may be ordered differently, so margins agree to
rtol=1e-5 and atol=1e-5*max|margin|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu_torch.native import traverse_kernel as tk

# the suite runs in several worker processes: a worker's torch may not
# take every core from the serving tests beside it
torch.set_num_threads(2)

RTOL = 1e-5


def _toy(n=2000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[::17, 2] = np.nan  # NaN features land in bin 0
    y = (2 * X[:, 0] - np.nan_to_num(X[:, 1]) ** 2
         + rng.normal(0, 0.3, n)).astype(np.float32)
    return X.astype(np.float32), y


def _fit(kind, X, y, max_bins):
    from sml_tpu.ml._tree_models import _fit_ensemble
    common = dict(categorical={}, max_bins=max_bins, min_instances=1,
                  min_info_gain=0.0, seed=7)
    if kind == "dt":
        return _fit_ensemble(X, y, max_depth=5, n_trees=1, feature_k=None,
                             bootstrap=False, subsample=1.0,
                             loss="squared", **common)
    if kind == "rf":
        return _fit_ensemble(X, y, max_depth=4, n_trees=6, feature_k=3,
                             bootstrap=True, subsample=1.0,
                             loss="squared", **common)
    return _fit_ensemble(X, y, max_depth=4, n_trees=5, feature_k=None,
                         bootstrap=False, subsample=1.0, loss="squared",
                         boosting=True, reg_lambda=1.0, **common)


@pytest.fixture(scope="module")
def fitted(spark):
    """JAX-package fits shared by the module, with their bin matrices
    from the JAX package's own `bin_with`."""
    from sml_tpu.ml.tree_impl import bin_with
    X, y = _toy()
    out = {}
    for name, kind, max_bins in (("dt", "dt", 32), ("rf", "rf", 32),
                                 ("xgb", "xgb", 32),
                                 ("xgb_u16", "xgb", 300)):
        spec = _fit(kind, X, y, max_bins)
        binned = bin_with(np.asarray(X, np.float64), spec.binning)
        sf, sb, lv, w = (np.asarray(a) for a in spec.stacked())
        out[name] = (binned, sf, sb, lv, w, spec.depth)
    binned, sf, sb, lv, w, depth = out["xgb"]
    out["xgb_i32"] = (binned.astype(np.int32), sf, sb, lv, w, depth)
    # early leaves: internal nodes on every level above the last turned
    # into leaves, so rows stop before `depth` and keep that node's value
    sf_e = sf.copy()
    sf_e[:, [1, 5, 9, 12]] = -1
    out["xgb_early"] = (binned, sf_e, sb, lv, w, depth)
    return out


def _torch(binned, sf, sb, lv, w):
    return (torch.from_numpy(np.ascontiguousarray(binned)),
            torch.from_numpy(np.ascontiguousarray(sf, np.int32)),
            torch.from_numpy(np.ascontiguousarray(sb, np.int32)),
            torch.from_numpy(np.ascontiguousarray(lv, np.float32)),
            torch.from_numpy(np.ascontiguousarray(w, np.float32)))


def _port(case):
    binned, sf, sb, lv, w, depth = case
    return tk.forest_traverse(*_torch(binned, sf, sb, lv, w),
                              depth=depth).numpy()


def _assert_margins(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


CASES = ["dt", "rf", "xgb", "xgb_u16", "xgb_i32", "xgb_early"]


@pytest.mark.parametrize("case", CASES)
def test_plain_traversal_matches_jax_forest_margin(fitted, case):
    from sml_tpu.ml.inference import _forest_margin
    binned, sf, sb, lv, w, depth = fitted[case]
    want = jax.jit(_forest_margin, static_argnums=5)(
        jnp.asarray(binned), jnp.asarray(sf), jnp.asarray(sb),
        jnp.asarray(lv), jnp.asarray(w), depth)
    _assert_margins(_port(fitted[case]), want)


@pytest.mark.parametrize("case", CASES)
def test_plain_traversal_matches_pallas_interpret(fitted, case):
    from sml_tpu.native.traverse_kernel import forest_traverse
    binned, sf, sb, lv, w, depth = fitted[case]
    want = forest_traverse(jnp.asarray(binned), jnp.asarray(sf),
                           jnp.asarray(sb), jnp.asarray(lv), jnp.asarray(w),
                           depth=depth, interpret=True)
    _assert_margins(_port(fitted[case]), want)


def test_fixtures_cover_dtypes_nan_rows_and_early_leaves(fitted):
    assert fitted["xgb"][0].dtype == np.uint8
    assert fitted["xgb_u16"][0].dtype == np.uint16
    assert fitted["xgb_i32"][0].dtype == np.int32
    binned, sf, sb, lv, w, depth = fitted["xgb_early"]
    # some rows really end at an early leaf
    x = torch.from_numpy(binned.astype(np.int64))
    node = torch.zeros(x.shape[0], dtype=torch.int64)
    for _ in range(2):
        f = torch.from_numpy(sf[0].astype(np.int64))[node]
        child = 2 * node + 1 + (x.gather(1, f.clamp(min=0)[:, None])[:, 0]
                                > torch.from_numpy(sb[0].astype(np.int64))
                                [node]).long()
        node = torch.where(f >= 0, child, node)
    assert torch.isin(node, torch.tensor([1, 5])).any()


def test_cpu_operands_never_count_a_launch(fitted):
    before = tk.LAUNCHES
    _port(fitted["dt"])
    assert tk.LAUNCHES == before


def _ok_operands():
    binned = torch.zeros((4, 3), dtype=torch.uint8)
    sf = torch.full((2, 7), -1, dtype=torch.int32)
    sb = torch.zeros((2, 7), dtype=torch.int32)
    lv = torch.ones((2, 7), dtype=torch.float32)
    w = torch.full((2,), 0.5, dtype=torch.float32)
    return [binned, sf, sb, lv, w]


@pytest.mark.parametrize("bad, exc", [
    (lambda o: o.__setitem__(0, o[0].to(torch.float32)), TypeError),
    (lambda o: o.__setitem__(0, o[0].to(torch.int64)), TypeError),
    (lambda o: o.__setitem__(1, o[1].to(torch.int64)), TypeError),
    (lambda o: o.__setitem__(3, o[3].to(torch.float64)), TypeError),
    (lambda o: o.__setitem__(2, o[2][:, :5]), ValueError),
    (lambda o: o.__setitem__(4, o[4][:1]), ValueError),
    (lambda o: o.__setitem__(0, o[0].t()), ValueError),
])
def test_wrapper_rejects_bad_operands(bad, exc):
    ops = _ok_operands()
    bad(ops)
    with pytest.raises(exc):
        tk.forest_traverse(*ops, depth=2)


def test_wrapper_rejects_depth_past_the_tables():
    with pytest.raises(ValueError, match="nodes per tree"):
        tk.forest_traverse(*_ok_operands(), depth=3)


def test_wrapper_early_leaf_root_and_feature_past_row():
    """A root leaf returns its own value; a feature id past the row reads
    as bin 0 (the JAX one-hot select's behaviour)."""
    binned, sf, sb, lv, w = _ok_operands()
    binned[:, 0] = torch.tensor([0, 1, 2, 3], dtype=torch.uint8)
    lv = torch.arange(14, dtype=torch.float32).reshape(2, 7)
    sf[1, 0] = 7  # past F=3: every row reads bin 0, 0 > sb=0 is false
    out = tk.forest_traverse(binned, sf, sb, lv, w, depth=2)
    np.testing.assert_array_equal(out.numpy(), [0.5 * 0 + 0.5 * 8] * 4)


# ------------------------------------------------------------ the kernel's
# compact tables: early leaves completed, then exactly `depth` steps
def _complete_tables(sf: torch.Tensor, sb: torch.Tensor,
                          lv: torch.Tensor, weights: torch.Tensor,
                          depth: int, n_feat: int):
    """The compact tables the kernel (`csrc/forest_traverse.cu`) builds in
    shared memory, in plain PyTorch ops: (feature (T, 2^D - 1) int64 in [0, F], split bin (T,
    2^D - 1) int64, value (T, 2^D) f32). A node at or below an early leaf
    (sf < 0 on the node or an ancestor) has feature F, which reads bin 0,
    and split bin INT_MAX, so it always goes left; any other node with a
    feature id past the row has feature F and split bin -1 or 0 (right
    iff 0 > sb); a last-level node holds w[t] times the value of the
    topmost early leaf above it, else its own. Descended for exactly
    `depth` steps (`_descend_completed`), these give the leaf of
    `forest_margin_plain`."""
    nleaf = 1 << depth
    nrec = nleaf - 1
    sf64 = sf.to(torch.int64)[:, :nrec + nleaf]
    dev = sf.device
    node = torch.arange(nrec + nleaf, device=dev)
    # dead: sf < 0 on the node or an ancestor (level by level, top down)
    dead = sf64 < 0
    for lvl in range(1, depth + 1):
        j = node[(1 << lvl) - 1:(2 << lvl) - 1]
        dead[:, j] |= dead[:, (j - 1) // 2]
    feat = torch.where(dead[:, :nrec], n_feat,
                       sf64[:, :nrec].clamp(max=n_feat))
    sb64 = sb.to(torch.int64)[:, :nrec]
    bins = torch.where(sf64[:, :nrec] >= n_feat,
                       torch.where(sb64 < 0, -1, 0), sb64)
    bins = torch.where(dead[:, :nrec], 2 ** 31 - 1, bins)
    # the topmost early leaf above each last-level node, else itself
    top = node[nrec:].expand(sf.shape[0], nleaf).clone()
    for k in range(depth, 0, -1):   # from the root down: topmost first
        anc = ((node[nrec:] + 1) >> k) - 1
        hit = (sf64[:, anc] < 0) & (top == node[nrec:])
        top = torch.where(hit, anc, top)
    value = weights.to(torch.float32)[:, None] * lv.to(torch.float32) \
        .gather(1, top)
    return feat, bins, value


def _descend_completed(binned: torch.Tensor, feat: torch.Tensor,
                            bins: torch.Tensor, value: torch.Tensor,
                            depth: int) -> torch.Tensor:
    """The kernel's descent over completed tables (`_complete_tables`)
    in plain PyTorch ops: exactly `depth` steps per tree with no early
    stop, bins read from a zero column F past the row, and the values
    added in tree order in f32."""
    x = torch.nn.functional.pad(binned.to(torch.int64), (0, 1))
    nrec = (1 << depth) - 1
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for t in range(feat.shape[0]):
        node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for _ in range(depth):
            xb = x.gather(1, feat[t][node][:, None])[:, 0]
            node = 2 * node + 1 + (xb > bins[t][node]).to(torch.int64)
        acc = acc + value[t][node - nrec]
    return acc


def _completed(case):
    binned, sf, sb, lv, w, depth = case
    ops = _torch(binned, sf, sb, lv, w)
    tables = _complete_tables(*ops[1:], depth, binned.shape[1])
    return _descend_completed(ops[0], *tables, depth), ops


@pytest.mark.parametrize("case", CASES)
def test_completed_tables_match_jax_forest_margin(fitted, case):
    """The tables the kernel builds, descended for exactly `depth` steps,
    against the JAX package's traversal (within the f32 reordering
    tolerance) and against the plain version (bit for bit)."""
    from sml_tpu.ml.inference import _forest_margin
    binned, sf, sb, lv, w, depth = fitted[case]
    got, ops = _completed(fitted[case])
    want = jax.jit(_forest_margin, static_argnums=5)(
        jnp.asarray(binned), jnp.asarray(sf), jnp.asarray(sb),
        jnp.asarray(lv), jnp.asarray(w), depth)
    _assert_margins(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tk.forest_margin_plain(*ops, depth).numpy())


def _edge_ensemble():
    """Depth-3 trees over F=3 bins: a root early leaf; a root whose
    feature id is past the row (bin 0 > -1: always right); an early leaf
    at level 1 with a second early leaf on its left chain; and a tree with
    a feature id past the row at level 2."""
    n_nodes = 15
    sf = np.tile(np.array([0, 1, 2, 0, 1, 2, 0] + [-1] * 8, np.int32), (4, 1))
    sb = np.tile(np.array([1, 0, 2, 1, 1, 0, 2] + [0] * 8, np.int32), (4, 1))
    lv = np.arange(4 * n_nodes, dtype=np.float32).reshape(4, n_nodes) / 8
    sf[0, 0] = -1
    sf[1, 0], sb[1, 0] = 9, -1
    sf[2, 1] = -1
    sf[2, 3] = -1
    sf[3, 4] = 3
    w = np.array([0.5, 0.25, 1.0, 0.125], np.float32)
    binned = np.random.default_rng(5).integers(0, 4, size=(64, 3))
    return binned.astype(np.uint8), sf, sb, lv, w, 3


def test_completed_tables_early_leaf_root_nested_and_feature_past_row():
    from sml_tpu.ml.inference import _forest_margin
    case = _edge_ensemble()
    binned, sf, sb, lv, w, depth = case
    got, ops = _completed(case)
    np.testing.assert_array_equal(
        got.numpy(), tk.forest_margin_plain(*ops, depth).numpy())
    want = _forest_margin(jnp.asarray(binned), jnp.asarray(sf),
                          jnp.asarray(sb), jnp.asarray(lv), jnp.asarray(w),
                          depth)
    _assert_margins(got.numpy(), want)
    feat, bins, value = _complete_tables(*ops[1:], depth, 3)
    # the root leaf: every node always left, its value on every last-level
    # node below it
    assert (feat[0] == 3).all() and (bins[0] == 2 ** 31 - 1).all()
    np.testing.assert_array_equal(value[0].numpy(), [0.5 * lv[0, 0]] * 8)
    # a feature id past the row: feature row F, right iff 0 > sb
    assert feat[1, 0] == 3 and bins[1, 0] == -1
    assert feat[3, 4] == 3 and bins[3, 4] == 0
    # the level-1 early leaf (node 1) is the topmost one: its value
    # reaches nodes 7-10, and node 3, an early leaf below it, is marked too
    np.testing.assert_array_equal(value[2, :4].numpy(), [lv[2, 1]] * 4)
    assert (bins[2, [1, 3, 4]] == 2 ** 31 - 1).all()


def test_a_build_with_defines_is_a_library_of_its_own():
    """`build.load(name, defines)` (the phase stamps of the traversal
    kernel) never takes the place of the plain build of the source."""
    from sml_tpu_torch.native import build
    plain = build._lib_path("forest_traverse")
    stamped = build._lib_path("forest_traverse", ("SML_TRAVERSE_STAMPS",))
    assert plain == build._lib_path("forest_traverse", ())
    assert stamped != plain
    assert {os.path.dirname(plain), os.path.dirname(stamped)} == \
        {build.BUILD_DIR}


def test_bound_counts_the_reachable_tables_only():
    """`chip_smoke.table_bytes`, the tables' share of the kernel's bound:
    8 bytes for each internal node a row can reach, 4 for each reachable
    last-level node, nothing below an early leaf."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    _, sf, _, _, _, depth = _edge_ensemble()
    full = 8 * 7 + 4 * 8
    # a root leaf; two full trees; node 1 early (nodes 3, 4 and 7-10 below)
    want = [8, full, 8 * 5 + 4 * 4, full]
    for t, nbytes in enumerate(want):
        got = chip_smoke.table_bytes(torch.from_numpy(sf[t:t + 1]), depth)
        assert got == nbytes, t
    assert chip_smoke.table_bytes(torch.from_numpy(sf), depth) == sum(want)


# ------------------------------------------------------------ launch plan
PLAN_SHAPES = {
    # name: features, bin bytes, trees, depth
    "ml06": (10, 1, 1, 5),
    "ml07": (10, 1, 20, 6),
    "ml11": (10, 1, 40, 6),
    "uint16": (10, 2, 40, 6),
    "int32": (10, 4, 40, 6),
    "wide rows": (400, 4, 8, 6),
    "depth 12": (10, 2, 8, 12),
    "depth 14": (10, 2, 2, 14),
    "depth 16": (10, 2, 2, 16),
}


@pytest.mark.parametrize("rows", [1, 64, 4096, 100_000])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_traverse_plan_fits_the_card_and_covers_rows_and_trees(shape, rows):
    """The plan against an H100's limits: shared memory of a block and of
    an SM, threads and registers, 16-byte-aligned areas; its tiles cover
    every row once and its chunks and tree groups every tree once; it
    takes the global-memory kernel exactly when one compact tree passes
    shared memory."""
    n_feat, bin_bytes, n_trees, depth = PLAN_SHAPES[shape]
    n_nodes = 2 ** (depth + 1) - 1
    p = tk.traverse_plan(rows, n_feat, bin_bytes, n_trees, n_nodes, depth)
    assert p is tk.traverse_plan(rows, n_feat, bin_bytes, n_trees, n_nodes,
                                 depth)   # cached per shape
    one_tree = tk.traverse_smem(1, depth, 32, n_feat, False, 1)
    if p.path == "global":
        assert depth > 14 or one_tree > 227 * 1024
        assert p.threads == 256 and p.grid * 256 >= rows > (p.grid - 1) * 256
        return
    assert p.path == "shared" and depth <= 14
    layout = tk.traverse_layout(p.chunk, depth, p.tile_rows, n_feat,
                                p.stage_x, p.groups)
    assert layout["total"] == p.smem <= 227 * 1024
    offsets = [layout["rec"], layout["leaf"], *layout["x"], *layout["vals"]]
    assert all(o % 16 == 0 for o in offsets)
    assert p.per_sm >= 1 and p.per_sm * (p.smem + 1024) <= 228 * 1024
    assert p.per_sm * p.threads <= 2048
    assert p.per_sm * p.threads * 64 <= 65536 and p.per_sm <= 32
    assert p.tile_rows % 32 == 0 and p.threads == p.tile_rows * p.groups
    assert 32 <= p.threads <= 1024
    assert p.stage_x == int(4 * (n_feat + 1) * p.tile_rows <= 48 * 1024)
    # every row once: tile i goes to block i mod grid
    tiles = -(-rows // p.tile_rows)
    assert 1 <= p.grid <= min(tiles, 132 * p.per_sm)
    seen = np.zeros(rows, np.int64)
    for block in range(p.grid):
        for tile in range(block, tiles, p.grid):
            seen[tile * p.tile_rows:(tile + 1) * p.tile_rows] += 1
    assert (seen == 1).all()
    # every tree once: chunks of `chunk` trees, group g takes g, g + G, ...
    assert p.n_chunks == -(-n_trees // p.chunk)
    trees = np.zeros(n_trees, np.int64)
    for t0 in range(0, n_trees, p.chunk):
        tc = min(p.chunk, n_trees - t0)
        for g in range(p.groups):
            trees[[t0 + t for t in range(g, tc, p.groups)]] += 1
    assert (trees == 1).all()
    # the chunk is as large as shared memory allows
    if p.n_chunks > 1:
        assert tk.traverse_smem(n_trees, depth, p.tile_rows, n_feat,
                                p.stage_x, p.groups) > 227 * 1024


def test_traverse_plan_paths_at_the_check_shapes():
    """The shapes `chip_smoke.py` checks each reach the path they are
    meant to: bins staged at the course widths, bins read through L1 at
    400 features, trees in chunks at depth 13 and past 224 trees, the
    global-memory kernel at depth 16."""
    ml11 = tk.traverse_plan(4096, 10, 1, 40, 127, 6)
    assert (ml11.path, ml11.stage_x, ml11.n_chunks) == ("shared", 1, 1)
    assert tk.traverse_plan(4096, 400, 4, 8, 127, 6).stage_x == 0
    assert tk.traverse_plan(4096, 10, 2, 4, 2 ** 14 - 1, 13).n_chunks == 2
    assert tk.traverse_plan(4096, 10, 1, 300, 127, 6).n_chunks == 2
    many = tk.traverse_plan(100_000, 10, 1, 300, 127, 6)
    assert (many.groups, many.n_chunks) == (1, 2)   # sum carried in `out`
    assert tk.traverse_plan(4096, 10, 2, 2, 2 ** 17 - 1, 16).path == "global"
    # a request of 64 rows runs all 40 trees at once; 100,000 rows one
    # tile a block in one group
    assert tk.traverse_plan(64, 10, 1, 40, 127, 6).groups == 32
    big = tk.traverse_plan(100_000, 10, 1, 40, 127, 6)
    assert big.groups == 1 and big.grid * big.tile_rows >= 100_000
