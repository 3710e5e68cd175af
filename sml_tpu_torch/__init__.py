"""sml_tpu_torch — the PyTorch/CUDA port of `sml_tpu`, for NVIDIA Hopper.

The JAX package `sml_tpu` stays the reference; this package is held
against it by the `tests/test_torch_*.py` tests, and never imports it or
JAX. Each TPU kernel of the JAX package becomes a hand-written Hopper
kernel under `csrc/`, built with `nvcc` at first use (`native/build.py`).

Ported so far:
- the tree-ensemble serving path: host binning (`ml/tree_impl.py`), the
  device bin cache (`ml/_staging.py`), the model loader (`ml/base.py`,
  `ml/_tree_models.py`, `xgboost.py`), scoring and the fused
  predict+eval (`ml/inference.py`, over the `forest_traverse` kernel in
  `native/traverse_kernel.py`), the regression metrics
  (`ml/evaluation.py`) and the micro-batching server (`serving/`);
- the fit path of tree ensembles: the DT, RF, GBT and XGBoost
  estimators (`ml/_tree_models.py`, `xgboost.py`) over the level-wise
  builder of `ml/tree_impl.py` and its two kernels, `hist_accumulate`
  and `split_scan` (`native/hist_kernel.py`); sampled fits (bootstrap
  forests, per-node feature subspaces, `subsample < 1`) draw jax's
  Threefry streams (`utils/prng.py`) through the `row_weights` and
  `feature_mask` kernels (`native/prng_kernel.py`), one launch of each
  a fit;
- tuning's device half: the (grid point x fold) fits of a DT/RF
  cross-validation grid as fused fits whose elements share each level's
  kernel launches (`fit_ensembles_trials`, `fit_ensembles_folds` in
  `ml/tree_impl.py`; `fit_cv_grid` and `fused_reg_stats_from_matrix` in
  `ml/_tree_models.py`), and the host binning's threaded C++ kernel
  (`native/binning.py`, `csrc/binning.cc`).

- the host layer: a DataFrame over numpy blocks with Spark's
  `randomSplit` draw for draw (`frame/`, `native/hashing.py` over
  `csrc/murmur3.cc`, `frame/sampling.py` over `csrc/xorshift.cc`),
  Params and Pipeline (`ml/param.py`, `ml/base.py`), the feature stages
  (`ml/feature.py`), the evaluators (`ml/evaluation.py`), and tree
  estimators and models that take DataFrames;
- model selection: CrossValidator and TrainValidationSplit
  (`ml/tuning.py`; a DT/RF grid as fused fits, anything else as placed
  trials on the card, `device.run_placed_trials`), hyperopt's `fmin`
  (`tune/`);
- the non-tree programs: LinearRegression and LogisticRegression on a
  Gram pass and IRLS (`ml/linear_impl.py`, `ml/regression.py`,
  `ml/classification.py`), KMeans (`ml/clustering.py`), ALS
  (`ml/recommendation.py`), the linear kind of `DeviceScorer`, and
  `courseware.make_movielens_dataset`;
- MLE 04's time series (`timeseries.py`: Prophet's Gram and FISTA and
  ARIMA's CSS loss and its autograd gradient as float64 torch ops on the
  card; acf, pacf, adfuller and Holt on the host), the frame's
  pandas-free remainder (`frame/grouped.py`: groupBy and agg;
  `frame/sql.py`: `spark.sql`, temp views and the catalog on sqlite3;
  `frame/io.py`: the CSV and JSON readers and writers; joins,
  `selectExpr`, `stat` and the date functions), `courseware.
  make_dedup_dataset`, `version.py`, and the course's import shims
  (`compat.install_shims`);
- tracking and the model registry (`tracking/`: a file store either
  package reads, the MLflow surface of ML 04 / ML 05), the
  registry-backed `serving.ServingEndpoint` (stage aliases, hot-swap,
  a canary mirrored to Staging) and ML 09's AutoML (`automl.py`);
- the dispatcher, the host routes, prewarm and the obs core
  (`parallel/dispatch.py`, `parallel/prewarm.py`, `native/
  host_traverse.py`, `obs/`);
- the data plane: parquet through the port's own codec
  (`frame/parquet/`, with snappy in C++ `csrc/snappy.cc`), Delta tables
  (`delta/`), the feature store (`feature_store.py`) and the courseware
  harness (`courseware.py`: `ClassroomSetup` with its dataset install,
  `TestResults`), with no pandas or pyarrow.

Entry points run on the CUDA card unless the caller passes
device="cpu"; without a card they raise. The DataFrame entry points
(an estimator's `fit(df)`, a model's `transform`, the evaluators) and
`Prophet.fit` / `ARIMA.fit` read the device from the session's
`sml.device` key instead, as do `ServingEndpoint` (unless given a
`device`), `pyfunc` models and AutoML.
"""

from .conf import GLOBAL_CONF
from .frame import DataFrame, Row, TpuSession, functions, get_session
from .version import __version__


def install_shims() -> None:
    """Register the pyspark/mlflow/hyperopt/databricks import shims so
    the course's code runs unchanged on the port (`compat.py`)."""
    from .compat import install_shims as _install
    _install()


__all__ = ["TpuSession", "DataFrame", "Row", "functions", "get_session",
           "GLOBAL_CONF", "install_shims", "__version__"]
