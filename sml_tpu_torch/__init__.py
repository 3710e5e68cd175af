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
  `feature_mask` kernels (`native/prng_kernel.py`);
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
  `courseware.make_movielens_dataset`.

Entry points run on the CUDA card unless the caller passes
device="cpu"; without a card they raise. The DataFrame entry points
(an estimator's `fit(df)`, a model's `transform`, the evaluators) read
the device from the session's `sml.device` key instead.
"""

from .conf import GLOBAL_CONF
from .frame import DataFrame, Row, TpuSession, functions, get_session

__all__ = ["DataFrame", "GLOBAL_CONF", "Row", "TpuSession", "functions",
           "get_session"]
