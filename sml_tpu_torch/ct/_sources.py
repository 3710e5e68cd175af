"""Live chunk sources: streaming and Delta micro-batches as chunks.

The port's copy of `sml_tpu/ct/_sources.py`. The chunked plane's
`ChunkSource` is re-iterable (its quantization is a two-pass fit), while
a live source grows between passes. The adapters keep a watermark:

- `snapshot()` freezes the data committed since the watermark as the
  window, which both ingest passes stream;
- `advance()` moves the watermark past the window once it is consumed
  (a fit landed, or the trainer judged it clean);
- nothing before the watermark is read again, so each micro-batch pays
  only its own sketch, quantization and copy.

`fingerprint()` is None for the stream adapter (a live window never
comes from the ingest memo) and keyed by the version range for the
Delta adapter (committed versions do not change).

The JAX package slices pandas frames; the port slices its blocks' numpy
columns: a memory sink's micro-batch blocks, and each Delta add file
read a row group at a time through the port's parquet codec.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..frame._chunks import ChunkSource
from ..frame.column import block_len


def _xy(block, features: List[str], label: Optional[str], lo: int,
        hi: int):
    X = np.column_stack([np.asarray(block[c][lo:hi], np.float64)
                         for c in features])
    y = (np.asarray(block[label][lo:hi], np.float64)
         if label is not None else None)
    return X, y


class StreamChunkSource(ChunkSource):
    """A memory-sink `StreamingQuery`'s committed micro-batches as
    chunks. `snapshot()` freezes the batches committed since the
    watermark (holding references, so later appends never change the
    window) and `_iter_chunks` streams them in commit order, cut into
    `chunk_rows`-row blocks."""

    def __init__(self, query, feature_cols: Sequence[str],
                 label_col: Optional[str] = None,
                 chunk_rows: Optional[int] = None):
        fmt = getattr(query, "_fmt", None)
        if fmt != "memory":
            raise ValueError(
                f"StreamChunkSource adapts a memory-sink StreamingQuery "
                f"(got sink format {fmt!r}); point Delta/parquet sinks "
                f"at DeltaChunkSource or a file source instead")
        self._query = query
        self._features = list(feature_cols)
        self._label = label_col
        self._chunk_rows = int(chunk_rows) if chunk_rows else None
        self.n_features = len(self._features)
        self._lo = 0            # micro-batches consumed (the watermark)
        self._hi = 0            # end of the frozen window
        self._window: List[dict] = []
        self.n_rows = 0

    def snapshot(self) -> int:
        """Freeze the micro-batches committed since the watermark as the
        window; returns its row count. A list append is atomic, so
        slicing under the captured length races nothing."""
        parts = self._query._mem_parts
        hi = len(parts)
        self._window = parts[self._lo:hi]
        self._hi = hi
        self.n_rows = int(sum(block_len(p) for p in self._window))
        return self.n_rows

    def advance(self) -> None:
        """Consume the frozen window: the next `snapshot()` sees only
        newer micro-batches."""
        self._lo = self._hi
        self._window = []
        self.n_rows = 0

    def _iter_chunks(self):
        c = self.chunk_rows
        for block in self._window:
            for start in range(0, block_len(block), c):
                yield _xy(block, self._features, self._label, start,
                          start + c)

    def fingerprint(self):
        return None  # a live window never comes from the ingest memo


class DeltaChunkSource(ChunkSource):
    """The Delta versions committed since a watermark as chunks:
    `snapshot()` freezes the add actions of every commit past the
    consumed version (the row count from the log's `numRecords`, so no
    parquet file is opened), and `_iter_chunks` streams each added file
    in commit order. The table is append-only by contract: an overwrite
    rewrites history, which a watermark cannot describe."""

    def __init__(self, path: str, feature_cols: Sequence[str],
                 label_col: Optional[str] = None,
                 chunk_rows: Optional[int] = None,
                 start_version: int = -1):
        self._path = path
        self._features = list(feature_cols)
        self._label = label_col
        self._chunk_rows = int(chunk_rows) if chunk_rows else None
        self.n_features = len(self._features)
        self._since = int(start_version)   # the highest consumed version
        self._snap_hi = self._since
        self._snap_files: List[str] = []
        self.n_rows = 0

    def snapshot(self) -> int:
        from ..delta.table import _list_versions, _read_commit
        versions = [v for v in _list_versions(self._path)
                    if v > self._since]
        files: List[str] = []
        n = 0
        for v in sorted(versions):
            for action in _read_commit(self._path, v):
                if "add" in action:
                    files.append(action["add"]["path"])
                    n += int(action["add"].get("numRecords", 0))
        self._snap_files = files
        self._snap_hi = max(versions) if versions else self._since
        self.n_rows = n
        return n

    def advance(self) -> None:
        self._since = self._snap_hi
        self._snap_files = []
        self.n_rows = 0

    def _iter_chunks(self):
        from ..frame import parquet as _pq
        cols = self._features + ([self._label] if self._label else [])
        for rel in self._snap_files:
            pf = _pq.ParquetFile(os.path.join(self._path, rel))
            for block in pf.iter_blocks(self.chunk_rows, cols):
                yield _xy(block, self._features, self._label, 0,
                          block_len(block))

    def fingerprint(self):
        # committed versions never change: (path, range, files) is stable
        return ("delta-window", self._path, self._since, self._snap_hi,
                tuple(self._snap_files))
