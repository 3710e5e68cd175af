"""The port's model surface against the live JAX package, on the CPU:
the tree models' `toDebugString` and `featureImportances`, `read()` on
every saveable class, and the `utils` and `native` packages' re-exports.

A model of each tree kind (DT, RF, GBT, both XGBoost models) is fitted by
the JAX package (`sml.tree.kernel=xla`), saved and loaded by the port, so
both print the same trees: the text is held equal character for
character, the importances bit for bit. The port's own DT and RF fits on
dyadic labels grow the JAX package's trees exactly
(`tests/test_torch_fit.py`), so their text is held equal too.
"""

import importlib
import os
import pkgutil

import numpy as np
import pytest
import torch

import sml_tpu_torch
from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml.linalg import DenseVector

torch.set_num_threads(2)


@pytest.fixture()
def xla_fits(spark):
    """The JAX fits on the XLA path with histogram subtraction, as the
    port builds; both keys restored after each test."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    keys = ("sml.tree.kernel", "sml.tree.histSubtraction")
    prev = {k: JCONF.get(k) for k in keys}
    JCONF.set("sml.tree.kernel", "xla")
    JCONF.set("sml.tree.histSubtraction", True)
    yield
    for k, v in prev.items():
        JCONF.set(k, v)


def _data(n=1500, f=5, seed=0):
    """Features with a categorical slot and labels in multiples of 1/8."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[:, 3] = rng.integers(0, 4, n)
    y = (np.round(8 * (X[:, 0] - 0.5 * X[:, 1] ** 2 + 0.25 * X[:, 3]))
         / 8).astype(np.float32)
    return X, y


_FIT = dict(categorical={3: 4}, max_bins=16, min_instances=1,
            min_info_gain=0.0, seed=5)
#: each tree kind: (JAX model class path, fit arguments, binary labels)
KINDS = {
    "dt": ("sml_tpu.ml._tree_models:DecisionTreeRegressionModel",
           dict(max_depth=4, n_trees=1, feature_k=None, bootstrap=False,
                subsample=1.0, loss="squared"), False),
    "rf": ("sml_tpu.ml._tree_models:RandomForestRegressionModel",
           dict(max_depth=4, n_trees=4, feature_k=2, bootstrap=True,
                subsample=1.0, loss="squared"), False),
    "gbt": ("sml_tpu.ml._tree_models:GBTClassificationModel",
            dict(max_depth=3, n_trees=4, feature_k=None, bootstrap=False,
                 subsample=1.0, loss="logistic", boosting=True,
                 step_size=0.3), True),
    "xgb_reg": ("sml_tpu.xgboost:XgboostRegressorModel",
                dict(max_depth=4, n_trees=4, feature_k=None,
                     bootstrap=False, subsample=0.8, loss="squared",
                     boosting=True, step_size=0.3, reg_lambda=1.0,
                     gamma=0.1), False),
    "xgb_cls": ("sml_tpu.xgboost:XgboostClassifierModel",
                dict(max_depth=3, n_trees=4, feature_k=None,
                     bootstrap=False, subsample=1.0, loss="logistic",
                     boosting=True, step_size=0.3, reg_lambda=1.0), True),
}


def _class(path):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def _jax_model(kind):
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    path, kw, binary = KINDS[kind]
    X, y = _data()
    if binary:
        y = (y > np.median(y)).astype(np.float32)
    return _class(path)(jfit(X, y, **_FIT, **kw))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tree_models_print_and_weigh_features_as_the_reference(
        xla_fits, tmp_path, kind):
    """A JAX model saved and loaded by the port: the same class, the same
    `toDebugString` text and `featureImportances` a `DenseVector` whose
    `toArray()` is the reference's."""
    jm = _jax_model(kind)
    jm.save(str(tmp_path / "m"))
    pm = pbase.load(str(tmp_path / "m"))
    assert type(pm).__name__ == type(jm).__name__
    assert isinstance(type(pm).toDebugString, property)
    assert pm.toDebugString == jm.toDebugString
    assert pm.toDebugString.startswith(
        f"{type(jm).__name__} with {KINDS[kind][1]['n_trees']} trees")
    assert isinstance(pm.featureImportances, DenseVector)
    np.testing.assert_array_equal(pm.featureImportances.toArray(),
                                  jm.featureImportances.toArray())


@pytest.mark.parametrize("kind", ["dt", "rf"])
def test_port_fits_print_as_the_reference_fits(xla_fits, kind):
    """The port's own DT and RF fits (dyadic labels: the JAX package's
    trees exactly) print the reference fit's text and weigh its
    features."""
    path, kw, _ = KINDS[kind]
    X, y = _data()
    jm = _jax_model(kind)
    pm = getattr(ptm, path.partition(":")[2])(
        ptm._fit_ensemble(X, y, device="cpu", **_FIT, **kw))
    assert pm.toDebugString == jm.toDebugString
    np.testing.assert_array_equal(pm.featureImportances.toArray(),
                                  jm.featureImportances.toArray())


def _saveable_classes():
    """Every public Saveable class of the port's modules, by name."""
    found = {}
    for info in pkgutil.walk_packages(sml_tpu_torch.__path__,
                                      "sml_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if isinstance(obj, type) and issubclass(obj, pbase.Saveable) \
                    and not name.startswith("_") \
                    and obj.__module__ == mod.__name__:
                found[name] = obj
    return found


def test_read_raises_as_the_reference():
    """`read()` on every saveable class of the port raises the
    reference's NotImplementedError("use .load(path)")."""
    from sml_tpu.ml.base import Saveable as JSaveable
    with pytest.raises(NotImplementedError) as want:
        JSaveable.read()
    classes = _saveable_classes()
    assert {"CrossValidatorModel", "Pipeline", "RandomForestRegressionModel",
            "XgboostRegressorModel", "StringIndexer"} <= set(classes)
    for name, cls in sorted(classes.items()):
        with pytest.raises(NotImplementedError) as got:
            cls.read()
        assert str(got.value) == str(want.value) == "use .load(path)", name


def test_utils_and_native_reexport_as_the_reference():
    """`sml_tpu_torch.utils` and `sml_tpu_torch.native` export the
    reference's names, and the hashing functions give its values."""
    import sml_tpu.native as jnative
    import sml_tpu.utils as jutils
    import sml_tpu_torch.native as pnative
    import sml_tpu_torch.utils as putils
    from sml_tpu_torch.native import build, hashing
    from sml_tpu_torch.utils import profiler
    assert putils.__all__ == jutils.__all__
    assert pnative.__all__ == jnative.__all__
    assert putils.PROFILER is profiler.PROFILER
    assert putils.start_device_trace is profiler.start_device_trace
    assert pnative.load_library is build.load
    assert pnative.hash_columns is hashing.hash_columns
    lib = pnative.load_library("murmur3")
    assert hasattr(lib, "mm3_hash_i32")
    rng = np.random.default_rng(3)
    cols = [rng.integers(-1000, 1000, 50).astype(np.int32),
            rng.normal(size=50)]
    got = pnative.hash_columns(cols)
    np.testing.assert_array_equal(got, jnative.hash_columns(cols))
    np.testing.assert_array_equal(pnative.hash_partition_ids(got, 7),
                                  jnative.hash_partition_ids(got, 7))
    for value in (0, 42, -7, 2.5, "Mission"):
        assert pnative.hash_scalar(value) == jnative.hash_scalar(value)


def test_start_device_trace_writes_a_trace(tmp_path):
    """The port's `start_device_trace` writes a torch.profiler trace of
    the block under its log directory, as the reference writes jax's."""
    from sml_tpu_torch.utils import start_device_trace
    with start_device_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces, os.listdir(tmp_path)
