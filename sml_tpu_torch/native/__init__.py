"""Hand-written CUDA kernels for Hopper, built from `csrc/` by `build.py`,
each with its plain PyTorch version beside its wrapper."""
