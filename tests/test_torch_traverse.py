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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu_torch.native import traverse_kernel as tk

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
