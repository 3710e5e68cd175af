"""sml_tpu_torch — the PyTorch/CUDA port of `sml_tpu`, for NVIDIA Hopper.

The JAX package `sml_tpu` stays the reference; this package is held
against it by the `tests/test_torch_*.py` tests, and never imports it or
JAX. Each TPU kernel of the JAX package becomes a hand-written Hopper
kernel under `csrc/`, built with `nvcc` at first use (`native/build.py`).

Ported so far: the tree-ensemble serving path — host binning
(`ml/tree_impl.py`), the device bin cache (`ml/_staging.py`), the model
loader (`ml/base.py`, `ml/_tree_models.py`, `xgboost.py`), scoring and
the fused predict+eval (`ml/inference.py`, over the `forest_traverse`
kernel in `native/traverse_kernel.py`), the regression metrics
(`ml/evaluation.py`) and the micro-batching server (`serving/`).

Entry points run on the CUDA card unless the caller passes
device="cpu"; without a card they raise.
"""
