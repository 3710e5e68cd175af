"""The out-of-core data plane's host half: chunk sources, split draws
and the mergeable quantile sketch.

The port's copy of `sml_tpu/frame/_chunks.py` (all but `HostChunkView`,
which waits for the multi-GPU slice):

- `ChunkSource`: a re-iterable source of row-block chunks (`chunks()`
  returns a fresh iterator each call: the streamed quantization reads
  the source twice) yielding `(X, y)` pairs in global row order, at most
  `sml.data.chunkRows` rows each. `ArrayChunkSource` views resident
  arrays as chunks, `GeneratorChunkSource` makes each chunk on demand
  (the data is never whole), `FilteredChunkSource` and `FoldChunkSource`
  keep the rows of a split or a fold.
- `chunk_random_split` / `split_assignments`: membership of each row
  comes from a stateless draw of (seed, global row index)
  (`sampling.row_uniforms`), so splits and folds are the same rows for
  any chunking; a filtered source numbers its rows by their position in
  the filtered stream, so nested splits are chunk-invariant too.
- `FeatureSketch` / `DatasetSketch`: a mergeable quantile sketch. Up to
  `_EXACT_CAP` finite values a feature it keeps the raw values and its
  quantiles are the same `np.quantile` call `tree_impl.make_bins` runs,
  so bin edges are bit-identical; past the cap it compresses to
  `sml.data.sketchBuckets` weight-uniform centroids (edges within one
  bin width for buckets >> maxBins; `make_bins` subsamples past the same
  cap, so neither side is exact there). Categorical slots stream their
  label sums for the label-mean category order.

The device half (per-chunk copies into the resident bin matrix) is in
`ml/_staging.py` and `ml/_chunked.py`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..conf import GLOBAL_CONF

#: finite values a feature below which the sketch is exact: the same
#: threshold above which make_bins subsamples
_EXACT_CAP = 262_144


def default_chunk_rows() -> int:
    return max(int(GLOBAL_CONF.getInt("sml.data.chunkRows")), 1)


# ------------------------------------------------------------- chunk sources
class ChunkSource:
    """Base protocol of row-block sources.

    A subclass implements `_iter_chunks()`, yielding `(X, y)` pairs
    (`X` (rows, n_features), `y` (rows,) or None) in global row order,
    at most `chunk_rows` rows each. `n_rows` may be None until a pass
    has counted it. `fingerprint()` (optional) names the source's
    content, so a repeated fit on the same source hits the ingest memo."""

    n_features: int
    n_rows: Optional[int] = None

    @property
    def chunk_rows(self) -> int:
        return getattr(self, "_chunk_rows", None) or default_chunk_rows()

    def chunks(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """A fresh iterator over the chunks; counts `n_rows` as it goes."""
        n = 0
        for X, y in self._iter_chunks():
            n += int(np.shape(X)[0])
            yield X, y
        self.n_rows = n

    def _iter_chunks(self):
        raise NotImplementedError

    def fingerprint(self) -> Optional[tuple]:
        return None

    def randomSplit(self, weights: Sequence[float],
                    seed: int) -> List["FilteredChunkSource"]:
        return chunk_random_split(self, weights, seed)

    def sample(self, fraction: float, seed: int) -> "FilteredChunkSource":
        """A row-wise Bernoulli sample by the same stateless draw as
        `randomSplit`."""
        return FilteredChunkSource(self, 0.0, float(fraction), int(seed))


class ArrayChunkSource(ChunkSource):
    """Resident (X, y) arrays viewed as chunks; `chunk_rows=None` is one
    chunk."""

    def __init__(self, X: np.ndarray, y: Optional[np.ndarray] = None,
                 chunk_rows: Optional[int] = None):
        self._X = np.asarray(X)
        self._y = None if y is None else np.asarray(y)
        self._chunk_rows = int(chunk_rows) if chunk_rows else None
        self.n_features = int(self._X.shape[1])
        self.n_rows = int(self._X.shape[0])

    @property
    def chunk_rows(self) -> int:
        return self._chunk_rows or self.n_rows or 1

    def _iter_chunks(self):
        c = self.chunk_rows
        for start in range(0, self._X.shape[0], c):
            X = self._X[start:start + c]
            y = None if self._y is None else self._y[start:start + c]
            yield X, y

    def fingerprint(self) -> Optional[tuple]:
        # by identity: the source holds the arrays, so the ids stay valid
        return ("array", id(self._X), self._X.shape, str(self._X.dtype),
                None if self._y is None else id(self._y))


class GeneratorChunkSource(ChunkSource):
    """Chunks made on demand by `make(start, stop) -> (X, y)`, which
    must give the same rows for the same range (both ingest passes call
    it); the data is never whole."""

    def __init__(self, n_rows: int, n_features: int,
                 make: Callable[[int, int],
                                Tuple[np.ndarray, Optional[np.ndarray]]],
                 chunk_rows: Optional[int] = None,
                 fingerprint: Optional[tuple] = None):
        self.n_rows = int(n_rows)
        self.n_features = int(n_features)
        self._make = make
        self._chunk_rows = int(chunk_rows) if chunk_rows else None
        self._fingerprint = fingerprint

    def _iter_chunks(self):
        c = self.chunk_rows
        for start in range(0, self.n_rows, c):
            yield self._make(start, min(start + c, self.n_rows))

    def fingerprint(self) -> Optional[tuple]:
        return self._fingerprint


class FilteredChunkSource(ChunkSource):
    """The parent's rows i with `lo <= row_uniforms(seed, i) < hi`, i
    the parent's global row index; this source's own rows are numbered
    by their filtered position."""

    def __init__(self, parent: ChunkSource, lo: float, hi: float, seed: int):
        self._parent = parent
        self._lo = float(lo)
        self._hi = float(hi)
        self._seed = int(seed)
        self.n_features = parent.n_features

    @property
    def chunk_rows(self) -> int:
        return self._parent.chunk_rows

    def _iter_chunks(self):
        from .sampling import row_uniforms
        start = 0
        for X, y in self._parent.chunks():
            rows = int(np.shape(X)[0])
            u = row_uniforms(self._seed, start, rows)
            mask = (u >= self._lo) & (u < self._hi)
            start += rows
            if mask.any():
                yield (np.asarray(X)[mask],
                       None if y is None else np.asarray(y)[mask])

    def fingerprint(self) -> Optional[tuple]:
        pf = self._parent.fingerprint()
        if pf is None:
            return None
        return ("filter", pf, self._lo, self._hi, self._seed)


class FoldChunkSource(ChunkSource):
    """A k-fold view for out-of-core cross-validation: row i is in fold
    `split_assignments(seed, i, [1] * k)`; the view keeps fold `fold`
    (`invert=False`, validation) or every other row (`invert=True`,
    training)."""

    def __init__(self, parent: ChunkSource, seed: int, k: int, fold: int,
                 invert: bool = False):
        self._parent = parent
        self._seed = int(seed)
        self._k = int(k)
        self._fold = int(fold)
        self._invert = bool(invert)
        self.n_features = parent.n_features

    @property
    def chunk_rows(self) -> int:
        return self._parent.chunk_rows

    def _iter_chunks(self):
        start = 0
        weights = [1.0] * self._k
        for X, y in self._parent.chunks():
            rows = int(np.shape(X)[0])
            cell = split_assignments(self._seed, start, rows, weights)
            mask = (cell != self._fold) if self._invert \
                else (cell == self._fold)
            start += rows
            if mask.any():
                yield (np.asarray(X)[mask],
                       None if y is None else np.asarray(y)[mask])

    def fingerprint(self) -> Optional[tuple]:
        pf = self._parent.fingerprint()
        if pf is None:
            return None
        return ("fold", pf, self._seed, self._k, self._fold, self._invert)


def chunk_random_split(source: ChunkSource, weights: Sequence[float],
                       seed: int) -> List[FilteredChunkSource]:
    """randomSplit of a ChunkSource by the stateless per-row draw: the
    weight cells partition [0, 1), and each row goes to the cell its
    uniform falls in. The splits are disjoint and exhaustive, and the
    same rows for any chunking (not Spark's sampler: the frame's
    `randomSplit` keeps that)."""
    total = float(sum(weights))
    bounds = np.cumsum([w / total for w in weights])
    outs = []
    lo = 0.0
    for i, hi in enumerate(bounds):
        hi = 1.0 if i == len(bounds) - 1 else float(hi)
        outs.append(FilteredChunkSource(source, lo, hi, int(seed)))
        lo = hi
    return outs


def split_assignments(seed: int, start: int, n: int,
                      weights: Sequence[float]) -> np.ndarray:
    """Each global row's cell in [start, start + n) for `weights`: the
    membership `chunk_random_split` applies, and the folds of CV."""
    from .sampling import row_uniforms
    total = float(sum(weights))
    bounds = np.cumsum([w / total for w in weights])
    u = row_uniforms(int(seed), int(start), int(n))
    return np.minimum(np.searchsorted(bounds, u, side="right"),
                      len(bounds) - 1).astype(np.int32)


# ------------------------------------------------------------ quantile sketch
def _ones_or(vals, wts) -> np.ndarray:
    """The weights of a pending stream: ones where they were never
    materialized (exact mode)."""
    return np.concatenate([np.ones(v.size, dtype=np.float64)
                           if w is None else w for v, w in zip(vals, wts)])


class FeatureSketch:
    """A mergeable quantile summary of one feature's finite values.

    Exact mode (at most `exact_cap` values): the raw values are kept in
    their own dtype and `quantiles()` is `np.quantile` over them. Past
    the cap the stream compresses to `buckets` weight-uniform centroids
    (each segment's order statistic at its weight midpoint, weighted by
    the segment), and quantiles interpolate the weighted points with rank
    error under one segment's weight. `merge` concatenates two streams
    and compresses again past the cap."""

    __slots__ = ("buckets", "exact_cap", "_vals", "_wts", "_n", "_exact",
                 "n_seen", "compressions")

    def __init__(self, buckets: Optional[int] = None,
                 exact_cap: int = _EXACT_CAP):
        self.buckets = int(buckets or
                           GLOBAL_CONF.getInt("sml.data.sketchBuckets"))
        self.exact_cap = int(exact_cap)
        self._vals: List[np.ndarray] = []
        self._wts: List[Optional[np.ndarray]] = []
        self._n = 0          # retained values across the pending lists
        self._exact = True
        self.n_seen = 0      # finite values observed
        self.compressions = 0

    def update(self, col: np.ndarray) -> None:
        # the column keeps its dtype: an f32 column quantiled in float64
        # gives other edge bits than make_bins
        finite = np.asarray(col)
        finite = finite[np.isfinite(finite)]
        if finite.size == 0:
            return
        self.n_seen += int(finite.size)
        self._vals.append(finite)
        self._wts.append(None)   # ones, materialized at compression
        self._n += int(finite.size)
        if self._n > self.exact_cap:
            self._compress()

    def merge(self, other: "FeatureSketch") -> None:
        """Fold another sketch's stream in; exact while the total fits
        the cap."""
        self.n_seen += other.n_seen
        self._vals.extend(other._vals)
        self._wts.extend(other._wts)
        self._n += other._n
        self._exact = self._exact and other._exact
        if self._n > self.exact_cap:
            self._compress()

    def _compress(self) -> None:
        """The pending stream as `buckets` weight-uniform centroids: sort,
        keep the order statistic at each equal-weight segment's midpoint
        (the minimum and maximum always), each weighted by the stream
        since the previous one, so the total weight is kept exactly."""
        vals = np.concatenate(self._vals)
        wts = _ones_or(self._vals, self._wts)
        order = np.argsort(vals, kind="stable")
        v, w = vals[order], wts[order]
        if v.size > self.buckets:
            cw = np.cumsum(w)
            total = cw[-1]
            mids = (np.arange(self.buckets, dtype=np.float64) + 0.5) \
                * (total / self.buckets)
            idx = np.searchsorted(cw, mids, side="left")
            idx = np.unique(np.clip(idx, 0, v.size - 1))
            idx[0] = 0
            idx[-1] = v.size - 1
            keep_w = np.diff(np.concatenate(([0.0], cw[idx])))
            v, w = v[idx], keep_w
            self._exact = False
            self.compressions += 1
        self._vals = [v]
        self._wts = [w]
        self._n = int(v.size)

    @property
    def exact(self) -> bool:
        return self._exact

    def values_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """The retained (values, weights), unsorted, in insertion order;
        exact-mode weights are ones."""
        if self._n == 0:
            return (np.zeros(0, dtype=np.float64),
                    np.zeros(0, dtype=np.float64))
        vals = self._vals[0] if len(self._vals) == 1 \
            else np.concatenate(self._vals)
        return vals, _ones_or(self._vals, self._wts)

    def cdf(self, xs: np.ndarray) -> np.ndarray:
        """The weighted share of the stream at or below each x (zeros
        for an empty sketch)."""
        xs = np.asarray(xs, dtype=np.float64)
        if self._n == 0:
            return np.zeros(xs.shape, dtype=np.float64)
        v, w = self.values_weights()
        order = np.argsort(v, kind="stable")
        v, w = v[order], w[order]
        cw = np.cumsum(w)
        idx = np.searchsorted(v, xs, side="right")
        out = np.where(idx > 0, cw[np.maximum(idx - 1, 0)], 0.0)
        return out / cw[-1]

    def to_dict(self) -> dict:
        """A JSON-safe form that `from_dict` restores to a sketch with
        the same quantiles and cdf, bit for bit, and merge-compatible.
        Exact mode keeps the raw values (and their dtype), compressed
        mode the (value, weight) centroids."""
        if not self._exact and len(self._vals) > 1:
            # compressed-mode quantiles read one consolidated pair
            self._compress()
        if self._n == 0:
            vals = np.zeros(0, dtype=np.float64)
            wts = None
        else:
            vals = self._vals[0] if len(self._vals) == 1 \
                else np.concatenate(self._vals)
            wts = None if all(w is None for w in self._wts) \
                else _ones_or(self._vals, self._wts)
        out = {
            "buckets": self.buckets,
            "exact_cap": self.exact_cap,
            "n_seen": self.n_seen,
            "compressions": self.compressions,
            "exact": bool(self._exact),
            "dtype": str(vals.dtype),
            "values": np.asarray(vals, dtype=np.float64).tolist(),
        }
        if wts is not None:
            out["weights"] = np.asarray(wts, dtype=np.float64).tolist()
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureSketch":
        sk = cls(buckets=int(d["buckets"]), exact_cap=int(d["exact_cap"]))
        vals = np.asarray(d["values"], dtype=np.float64).astype(
            np.dtype(d.get("dtype", "float64")))
        sk.n_seen = int(d["n_seen"])
        sk.compressions = int(d.get("compressions", 0))
        sk._exact = bool(d.get("exact", True))
        if vals.size:
            sk._vals = [vals]
            w = d.get("weights")
            sk._wts = [None if w is None
                       else np.asarray(w, dtype=np.float64)]
            sk._n = int(vals.size)
        return sk

    def quantiles(self, qs: np.ndarray) -> np.ndarray:
        """The values at probabilities `qs`: `np.quantile` of the raw
        values in exact mode; else the weighted order statistics
        interpolated with the same (N - 1) * q rank convention."""
        if self._n == 0:
            return np.zeros(0, dtype=np.float64)
        if self._exact:
            return np.quantile(np.concatenate(self._vals), qs)
        v = np.asarray(self._vals[0], dtype=np.float64)
        cw = np.cumsum(self._wts[0])
        total = cw[-1]
        # point i spans the expanded ranks [cw[i-1], cw[i])
        h = np.asarray(qs, dtype=np.float64) * (total - 1.0)
        lo = np.searchsorted(cw, np.floor(h), side="right")
        hi = np.searchsorted(cw, np.ceil(h), side="right")
        lo = np.clip(lo, 0, v.size - 1)
        hi = np.clip(hi, 0, v.size - 1)
        frac = h - np.floor(h)
        return v[lo] + (v[hi] - v[lo]) * frac


class DatasetSketch:
    """The sketches of every continuous feature and the streamed label
    sums of every categorical slot: one object per ingest pass 1,
    updated chunk by chunk, finalized into a `tree_impl.Binning` through
    `tree_impl.finalize_binning`, the assembly `make_bins` runs."""

    def __init__(self, n_features: int,
                 categorical: Optional[Dict[int, int]] = None,
                 buckets: Optional[int] = None,
                 exact_cap: int = _EXACT_CAP):
        self.n_features = int(n_features)
        self.categorical = dict(categorical or {})
        self.features = {f: FeatureSketch(buckets, exact_cap)
                         for f in range(n_features)
                         if f not in self.categorical}
        # categorical slot -> (label sum, count) per category id
        self._cat_sum = {f: np.zeros(int(card), dtype=np.float64)
                         for f, card in self.categorical.items()}
        self._cat_cnt = {f: np.zeros(int(card), dtype=np.int64)
                         for f, card in self.categorical.items()}
        self.n_rows = 0

    def update(self, X: np.ndarray, y: Optional[np.ndarray] = None) -> None:
        X = np.asarray(X)
        self.n_rows += int(X.shape[0])
        for f, sk in self.features.items():
            sk.update(X[:, f])
        if self.categorical and y is not None:
            # labels rounded through f32 first, as make_bins sees them
            y = np.asarray(y, dtype=np.float32).astype(np.float64)
        for f in self.categorical:
            card = int(self.categorical[f])
            ids = np.clip(X[:, f].astype(np.int64), 0, card - 1)
            if y is not None:
                self._cat_sum[f] += np.bincount(ids, weights=y,
                                                minlength=card)
            self._cat_cnt[f] += np.bincount(ids, minlength=card)

    def merge(self, other: "DatasetSketch") -> None:
        self.n_rows += other.n_rows
        for f, sk in self.features.items():
            sk.merge(other.features[f])
        for f in self.categorical:
            self._cat_sum[f] += other._cat_sum[f]
            self._cat_cnt[f] += other._cat_cnt[f]

    @property
    def exact(self) -> bool:
        return all(sk.exact for sk in self.features.values())

    def to_dict(self) -> dict:
        """A JSON-safe form of every sketch and categorical table;
        `from_dict` restores one with the same quantiles, bit for bit."""
        return {
            "n_features": self.n_features,
            "n_rows": self.n_rows,
            "categorical": {str(f): int(c)
                            for f, c in sorted(self.categorical.items())},
            "features": {str(f): sk.to_dict()
                         for f, sk in sorted(self.features.items())},
            "cat_sum": {str(f): self._cat_sum[f].tolist()
                        for f in sorted(self.categorical)},
            "cat_cnt": {str(f): self._cat_cnt[f].tolist()
                        for f in sorted(self.categorical)},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DatasetSketch":
        categorical = {int(f): int(c)
                       for f, c in (d.get("categorical") or {}).items()}
        out = cls(int(d["n_features"]), categorical)
        out.n_rows = int(d.get("n_rows", 0))
        out.features = {int(f): FeatureSketch.from_dict(sd)
                        for f, sd in (d.get("features") or {}).items()}
        for f in out.categorical:
            out._cat_sum[f] = np.asarray(d["cat_sum"][str(f)],
                                         dtype=np.float64)
            out._cat_cnt[f] = np.asarray(d["cat_cnt"][str(f)],
                                         dtype=np.int64)
        return out

    def cat_means(self, with_labels: bool) -> Dict[int, np.ndarray]:
        """Each slot's mean label per category (inf where absent), the
        order `make_bins` ranks categories by; without labels, the
        category id. The sums are float64 over f32-rounded labels, where
        `make_bins` takes numpy's f32 mean: two categories whose means
        agree to about an f32 ulp may rank the other way."""
        out = {}
        for f in self.categorical:
            card = int(self.categorical[f])
            means = np.full(card, np.inf)
            seen = self._cat_cnt[f] > 0
            if with_labels:
                means[seen] = self._cat_sum[f][seen] / self._cat_cnt[f][seen]
            else:
                means[seen] = np.nonzero(seen)[0].astype(np.float64)
            out[f] = means
        return out

    def to_binning(self, max_bins: int, with_labels: bool = True,
                   max_categories_error: bool = True):
        """(Binning, edge_list, out_dtype) through the port's
        `tree_impl.finalize_binning`."""
        from ..ml.tree_impl import finalize_binning
        probs = np.linspace(0, 1, max_bins + 1)[1:-1]
        cont_q = {f: sk.quantiles(probs) if sk.n_seen else None
                  for f, sk in self.features.items()}
        return finalize_binning(self.n_features, max_bins, self.categorical,
                                cont_q, self.cat_means(with_labels),
                                max_categories_error=max_categories_error)
