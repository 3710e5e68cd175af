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
  `feature_mask` kernels (`native/prng_kernel.py`).

Entry points run on the CUDA card unless the caller passes
device="cpu"; without a card they raise.
"""
