"""Vector types for feature columns.

The port's copy of `sml_tpu/ml/linalg.py`. MLlib's `VectorAssembler`
output column holds `DenseVector`/`SparseVector` values; here a vector
column is one (n, d) float64 numpy block in the frame (the role of the
JAX package's pandas `VectorArray`), and these types exist for API parity
and host-side inspection: `collect()` hands out a row as a DenseVector.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np


class Vector:
    def toArray(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    def __len__(self):
        return self.size

    def __eq__(self, other):
        if not isinstance(other, Vector):
            return NotImplemented
        return np.array_equal(self.toArray(), other.toArray())

    def __hash__(self):
        return hash(self.toArray().tobytes())


class DenseVector(Vector):
    __slots__ = ("values",)

    def __init__(self, values: Iterable[float]):
        self.values = np.asarray(values, dtype=np.float64)

    def toArray(self) -> np.ndarray:
        return self.values

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    def __getitem__(self, i):
        return self.values[i]

    def __iter__(self):
        return iter(self.values)

    def dot(self, other) -> float:
        other = other.toArray() if isinstance(other, Vector) \
            else np.asarray(other)
        return float(self.values @ other)

    def norm(self, p: float = 2.0) -> float:
        return float(np.linalg.norm(self.values, p))

    def __repr__(self):
        return f"DenseVector({np.array2string(self.values, separator=', ')})"


class SparseVector(Vector):
    __slots__ = ("_size", "indices", "values")

    def __init__(self, size: int, indices, values=None):
        self._size = int(size)
        if values is None:  # dict or list-of-pairs form
            pairs = sorted(indices.items()) if isinstance(indices, dict) \
                else sorted(indices)
            self.indices = np.asarray([p[0] for p in pairs], dtype=np.int32)
            self.values = np.asarray([p[1] for p in pairs], dtype=np.float64)
        else:
            self.indices = np.asarray(indices, dtype=np.int32)
            self.values = np.asarray(values, dtype=np.float64)

    def toArray(self) -> np.ndarray:
        arr = np.zeros(self._size, dtype=np.float64)
        arr[self.indices] = self.values
        return arr

    @property
    def size(self) -> int:
        return self._size

    def __getitem__(self, i):
        if i < 0:
            i += self._size
        pos = np.searchsorted(self.indices, i)
        if pos < len(self.indices) and self.indices[pos] == i:
            return float(self.values[pos])
        return 0.0

    def dot(self, other) -> float:
        other_arr = other.toArray() if isinstance(other, Vector) \
            else np.asarray(other)
        return float(self.values @ other_arr[self.indices])

    def __repr__(self):
        idx = ", ".join(str(int(i)) for i in self.indices)
        vals = ", ".join(repr(float(v)) for v in self.values)
        return f"SparseVector({self._size}, [{idx}], [{vals}])"


class Vectors:
    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0],
                                           (list, tuple, np.ndarray)):
            values = values[0]
        return DenseVector(values)

    @staticmethod
    def sparse(size: int, indices, values=None) -> SparseVector:
        return SparseVector(size, indices, values)

    @staticmethod
    def zeros(size: int) -> DenseVector:
        return DenseVector(np.zeros(size))


def to_matrix(col: Union[np.ndarray, Sequence]) -> np.ndarray:
    """An (n, d) float64 matrix of a vector column: a 2-D block as it is
    (no copy), a sequence of vectors or lists densified row by row."""
    if isinstance(col, np.ndarray) and col.ndim == 2:
        return col
    n = len(col)
    if n == 0:
        return np.zeros((0, 0))
    first = col[0]
    d = first.size if isinstance(first, Vector) else len(first)
    out = np.zeros((n, d), dtype=np.float64)
    for i, v in enumerate(col):
        out[i] = v.toArray() if isinstance(v, Vector) \
            else np.asarray(v, dtype=np.float64)
    return out
