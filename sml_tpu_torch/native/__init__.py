"""Hand-written CUDA kernels for Hopper, built from `csrc/` by `build.py`,
each with its plain PyTorch version beside its wrapper, and the host C++
(hashing, binning). `load_library(name)` is `build.load`: the library of
`csrc/<name>.cu` or `.cc`, built at first use; it raises where the JAX
package's returns None."""
from .build import load as load_library
from .hashing import hash_columns, hash_partition_ids, hash_scalar

__all__ = ["load_library", "hash_columns", "hash_partition_ids", "hash_scalar"]
