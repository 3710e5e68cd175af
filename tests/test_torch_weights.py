"""Fitted weights carried from the JAX package into the port.

`spec_from_arrays` (from the arrays `_EnsembleSpec.save` writes) and the
directory loader (`load_model`, from `model.save(path)`) must give the
JAX `stacked()` tables, edges and category remaps bit for bit; the
port's host binning (`make_bins`, `bin_with`, `bin_dtype`) must give the
JAX package's bin matrices, dtype included. All comparisons are exact.
"""

import os

import numpy as np
import pytest

from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import tree_impl as pti
from sml_tpu_torch.ml.base import load_model

CATS = {0: 5}


def _data(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    X[:, 0] = rng.integers(0, 5, size=n)     # an indexed categorical
    X[::13, 3] = np.nan
    y = (X[:, 0] * 0.5 + 2 * X[:, 1] - np.nan_to_num(X[:, 3]) ** 2
         + rng.normal(0, 0.3, n))
    return X, y.astype(np.float32)


@pytest.fixture(scope="module")
def specs(spark):
    from sml_tpu.ml._tree_models import _fit_ensemble
    X, y = _data()
    common = dict(categorical=CATS, max_bins=32, min_instances=1,
                  min_info_gain=0.0, seed=3)
    rf = _fit_ensemble(X, y, max_depth=4, n_trees=4, feature_k=2,
                       bootstrap=True, subsample=1.0, loss="squared",
                       **common)
    xgb = _fit_ensemble(X, y, max_depth=3, n_trees=4, feature_k=None,
                        bootstrap=False, subsample=1.0, loss="squared",
                        boosting=True, reg_lambda=1.0, step_size=0.2,
                        **common)
    yb = (y > np.median(y)).astype(np.float32)
    xgb_bin = _fit_ensemble(X, yb, max_depth=3, n_trees=3, feature_k=None,
                            bootstrap=False, subsample=1.0,
                            loss="logistic", boosting=True, **common)
    return {"rf": rf, "xgb": xgb, "xgb_bin": xgb_bin}


def _saved_arrays(spec, path):
    os.makedirs(path, exist_ok=True)
    spec.save(str(path))
    with np.load(os.path.join(str(path), "data.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_same_spec(port, jax_spec):
    for a, b in zip(port.stacked(), jax_spec.stacked()):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.binning.edges, jax_spec.binning.edges)
    assert port.binning.edges.dtype == jax_spec.binning.edges.dtype
    assert sorted(port.binning.cat_remap) == sorted(jax_spec.binning.cat_remap)
    for k, v in jax_spec.binning.cat_remap.items():
        np.testing.assert_array_equal(port.binning.cat_remap[k], v)
    assert (port.depth, port.base, port.n_features, port.mode) == \
        (jax_spec.depth, jax_spec.base, jax_spec.n_features, jax_spec.mode)
    if jax_spec.tree_weights is None:
        assert port.tree_weights is None
    else:
        np.testing.assert_array_equal(port.tree_weights,
                                      jax_spec.tree_weights)


@pytest.mark.parametrize("kind", ["rf", "xgb", "xgb_bin"])
def test_spec_from_arrays_is_bit_identical(specs, kind, tmp_path):
    arrays = _saved_arrays(specs[kind], tmp_path / kind)
    _assert_same_spec(ptm.spec_from_arrays(arrays), specs[kind])


def test_rf_weights_are_one_over_t(specs, tmp_path):
    port = ptm.spec_from_arrays(_saved_arrays(specs["rf"], tmp_path / "rf"))
    w = port.stacked()[3]
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, np.full(4, 0.25, np.float32))


@pytest.mark.parametrize("jax_cls, port_cls, kind", [
    ("sml_tpu.ml._tree_models.RandomForestRegressionModel",
     "RandomForestRegressionModel", "rf"),
    ("sml_tpu.ml._tree_models.DecisionTreeRegressionModel",
     "DecisionTreeRegressionModel", "rf"),
    ("sml_tpu.ml._tree_models.GBTRegressionModel", "GBTRegressionModel",
     "xgb"),
    ("sml_tpu.ml._tree_models.GBTClassificationModel",
     "GBTClassificationModel", "xgb_bin"),
    ("sml_tpu.ml._tree_models.RandomForestClassificationModel",
     "RandomForestClassificationModel", "rf"),
    ("sml_tpu.xgboost.XgboostRegressorModel", "XgboostRegressorModel",
     "xgb"),
    ("sml_tpu.xgboost.XgboostClassifierModel", "XgboostClassifierModel",
     "xgb_bin"),
])
def test_directory_loader_maps_class_and_tables(specs, tmp_path, jax_cls,
                                                port_cls, kind):
    import importlib
    module, _, name = jax_cls.rpartition(".")
    model = getattr(importlib.import_module(module), name)(specs[kind])
    model.save(str(tmp_path / "m"))
    loaded = load_model(str(tmp_path / "m"))
    assert type(loaded).__name__ == port_cls
    assert loaded.uid == model.uid
    assert loaded.getNumTrees() == len(specs[kind].trees)
    _assert_same_spec(loaded._spec, specs[kind])


def test_directory_loader_refuses_other_classes(tmp_path):
    import json
    os.makedirs(tmp_path / "lin")
    with open(tmp_path / "lin" / "metadata.json", "w") as f:
        json.dump({"class": "sml_tpu.ml.regression.LinearRegressionModel",
                   "uid": "x", "params": {}, "extra": {}}, f)
    with pytest.raises(ValueError, match="cannot load"):
        load_model(str(tmp_path / "lin"))


@pytest.mark.parametrize("kind", ["rf", "xgb"])
def test_bin_with_matches_jax(specs, kind):
    from sml_tpu.ml.tree_impl import bin_with
    X, _ = _data(n=1500, seed=9)
    want = bin_with(X, specs[kind].binning)
    got = pti.bin_with(X, pti.Binning(specs[kind].binning.edges,
                                      specs[kind].binning.cat_remap))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_bins, dtype", [(32, np.uint8),
                                             (300, np.uint16)])
def test_make_bins_and_bin_with_match_jax(max_bins, dtype):
    from sml_tpu.ml import tree_impl as jti
    X, y = _data(n=3000, seed=4)
    b_jax, bn_jax = jti.make_bins(X, y, max_bins, categorical=CATS)
    b_port, bn_port = pti.make_bins(X, y, max_bins, categorical=CATS)
    assert b_port.dtype == b_jax.dtype == dtype
    np.testing.assert_array_equal(b_port, b_jax)
    np.testing.assert_array_equal(bn_port.edges, bn_jax.edges)
    np.testing.assert_array_equal(bn_port.cat_remap[0], bn_jax.cat_remap[0])
    Xf, _ = _data(n=700, seed=5)
    got, want = pti.bin_with(Xf, bn_port), jti.bin_with(Xf, bn_jax)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_bins", [2, 32, 256, 257, 300, 65536, 65537])
def test_bin_dtype_matches_jax(max_bins):
    from sml_tpu.ml.tree_impl import bin_dtype
    assert pti.bin_dtype(max_bins) == bin_dtype(max_bins)
