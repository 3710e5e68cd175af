"""Out-of-core chunked ingest, fit, warm start, CV and predict: the
device half of the data plane.

Counterpart of `sml_tpu/ml/_chunked.py`; `frame/_chunks.py` holds the
host protocol (ChunkSource, the mergeable sketch, the split draws).

- `ingest_source`, the two-pass streamed quantization. Pass 1 sketches
  each chunk (`DatasetSketch`, merged into one, counting rows) and
  finalizes the bin edges. Pass 2 reads the source again through
  `parallel.pipeline.prefetch_pipeline`: each chunk is binned by the C++
  `_bin_columns` on a worker thread (ctypes releases the GIL, so chunks
  bin in parallel) into the compact host mirror, and copied into its
  rows of the resident device matrix from a pinned buffer on a copy
  stream (`_staging.ChunkAssembler`), chunk i+1 dispatched before chunk
  i drains. The assembled matrix is adopted into the bin cache
  (`insert_bins_cached`), so the device holds the compact matrix and
  never the raw float rows. The JAX package pads rows to its mesh; one
  card has one layout. The assembling matrix is the memory ledger's
  transient `chunk_stage` pool until the bin cache adopts it, and the
  device memory pass 2 adds is also read from
  `torch.cuda.max_memory_allocated`. Each chunk's host quantization wall
  feeds `obs.INGEST_SKEW` (the `ingest` block of `engine_health()`
  names the slowest chunk), and `drift_baseline=` judges every chunk's
  pass-1 sketch against a model's training baseline (the "ingest"
  drift monitor).
- `fit_ensemble_chunked`: `_tree_models._fit_ensemble` with
  `prebinned=`, the same path as a fit on the materialized rows, which
  it equals bit for bit while the sketch is exact; pass 1's sketch
  doubles as the fitted model's drift baseline.
- `warm_start_ensemble_chunked`: fresh chunks binned under a saved
  spec's binning, then `_resume_ensemble`.
- `iter_predictions` / `predict_chunked` / `cross_validate_chunked`:
  streamed prediction and k-fold CV over `FoldChunkSource` views.

The entry points run on `device`, the card unless the caller passes
"cpu", and raise without one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..conf import GLOBAL_CONF
from ..frame._chunks import ChunkSource, DatasetSketch, FoldChunkSource
from ..utils.profiler import PROFILER, now
from .tree_impl import Binning, _bin_columns, binning_edges_and_dtype


class IngestResult(NamedTuple):
    binned: np.ndarray          # (n, F) compact host mirror: the bin-cache key
    y: Optional[np.ndarray]     # (n,) f32 labels (None: unlabeled)
    binning: Binning
    n_rows: int
    stats: dict                 # the ingest's walls, bytes and event order
    sketch: Optional[DatasetSketch] = None   # pass 1's whole-data sketch


#: completed ingests by source fingerprint: a refit on the same source
#: skips both passes. Two entries, each pinning one compact matrix
_ingest_memo: dict = {}
_INGEST_MEMO_ENTRIES = 2


def _memo_key(source: ChunkSource, max_bins: int,
              categorical: Optional[Dict[int, int]]) -> Optional[tuple]:
    fp = source.fingerprint()
    if fp is None:
        return None
    return (fp, int(max_bins), tuple(sorted((categorical or {}).items())),
            int(source.chunk_rows))


def sketch_source(source: ChunkSource, max_bins: int,
                  categorical: Optional[Dict[int, int]] = None,
                  monitor=None) -> DatasetSketch:
    """Ingest pass 1: a `DatasetSketch` of each chunk, merged into one
    (the mergeable contract: summaries built apart, then unified). A
    drift `monitor` judges each chunk's sketch as it goes."""
    unified = DatasetSketch(source.n_features, categorical)
    for i, (X, y) in enumerate(source.chunks()):
        chunk_sk = DatasetSketch(source.n_features, categorical)
        chunk_sk.update(X, y)
        if monitor is not None:
            monitor.observe_sketch(chunk_sk, i)
        unified.merge(chunk_sk)
    return unified


def ingest_source(source: ChunkSource, max_bins: int,
                  categorical: Optional[Dict[int, int]] = None,
                  binning: Optional[Binning] = None,
                  sketch: Optional[DatasetSketch] = None,
                  device=None, label: str = "source",
                  drift_baseline=None) -> IngestResult:
    """The two-pass streamed quantization of a ChunkSource (the module
    docstring gives its shape). Returns the host mirror and binning, with
    the assembled device copy already in the bin cache of `device`.

    `binning` pins the edges and category ranks to a saved model's (a
    warm start's appended rounds split on the bin ids the saved trees
    use); pass 1 still streams, for the row count and the sketch.
    `sketch`, a caller's pass-1 sketch of the same rows, replaces pass 1
    (unless a drift monitor must stream). Either skips the memo.

    `drift_baseline` (an `obs.drift.DriftBaseline`, typically a
    registered model's) arms the ingest drift monitor: every chunk's
    pass-1 sketch is judged against it, flagged chunks count
    `drift.chunk_flagged`, and the monitor registers as "ingest" in
    `engine_health()["drift"]` (the last monitored ingest wins). A
    monitored ingest always streams and never uses or fills the memo.
    The chunks' host walls feed `obs.INGEST_SKEW` as program
    `ingest.<label>`.

    `stats` holds: n_chunks, chunk_rows, prefetch_depth, sketch_exact,
    sketch_s / pipeline_s / prep_s / dispatch_s (host clock; prep summed
    over the worker threads), raw_bytes, compact_bytes,
    chunk_stage_peak_bytes (on the card: the peak device memory pass 2
    adds over what was allocated when it began, after
    `torch.cuda.reset_peak_memory_stats`; None on the CPU) and order
    (the pipeline's ("dispatch" | "drain", chunk) events in order)."""
    from ..device import resolve_device
    from ..obs import INGEST_SKEW, LEDGER
    from ..parallel.pipeline import prefetch_pipeline
    from ._staging import ChunkAssembler, insert_bins_cached
    dev = resolve_device(device)
    key = None if (binning is not None or sketch is not None
                   or drift_baseline is not None) \
        else _memo_key(source, max_bins, categorical)
    hit = _ingest_memo.get(key) if key is not None else None
    if hit is not None:
        PROFILER.count("ingest.memo_hit")
        return hit
    monitor = None
    if drift_baseline is not None:
        from ..obs import drift as _drift
        monitor = _drift.DriftMonitor(drift_baseline, name="ingest")
        _drift.DRIFT.register("ingest", monitor)

    # ---- pass 1: the sketch (counts rows, learns the edges)
    t0 = now()
    if sketch is None or monitor is not None:
        sketch = sketch_source(source, max_bins, categorical, monitor)
    if binning is not None:
        edge_list, out_dtype = binning_edges_and_dtype(binning)
    else:
        binning, edge_list, out_dtype = sketch.to_binning(max_bins)
    n = sketch.n_rows
    sketch_s = now() - t0
    PROFILER.count("ingest.sketch_compress", float(sum(
        sk.compressions for sk in sketch.features.values())))

    # ---- pass 2: bin each chunk, copy it into the resident matrix
    F = source.n_features
    host = np.zeros((n, F), dtype=out_dtype)
    y_host = np.zeros(n, dtype=np.float32)
    labeled = [False]
    prep_walls: list = []
    dispatch_walls: list = []
    raw_bytes = [0]
    order: list = []
    depth = max(GLOBAL_CONF.getInt("sml.data.prefetchChunks"), 1)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
    asm = ChunkAssembler(n, F, out_dtype, dev, depth)
    stage_bytes = n * F * np.dtype(out_dtype).itemsize
    LEDGER.alloc("chunk_stage", stage_bytes)

    def offsets():
        start = 0
        for X, y in source.chunks():
            rows = int(np.shape(X)[0])
            yield start, X, y
            start += rows

    def prep(item):
        """A chunk's quantization into its rows of the host mirror, on a
        worker thread (disjoint rows; counters are returned)."""
        t1 = now()
        start, X, y = item
        X = np.asarray(X)
        rows = X.shape[0]
        nbytes = X.nbytes + (0 if y is None else np.asarray(y).nbytes)
        host[start:start + rows] = _bin_columns(X, edge_list,
                                                binning.cat_remap, out_dtype)
        if y is not None:
            y_host[start:start + rows] = np.asarray(y, dtype=np.float32)
        return start, rows, y is not None, nbytes, now() - t1

    def dispatch(_i, prepped):
        """Serial, in order: the chunk's copy into the device matrix."""
        start, rows, has_y, nbytes, prep_wall = prepped
        t1 = now()
        labeled[0] = labeled[0] or has_y
        raw_bytes[0] += nbytes
        prep_walls.append(prep_wall)
        event = asm.put(start, host[start:start + rows])
        dispatch_walls.append(now() - t1)
        return event

    def drain(_i, event):
        if event is not None:
            event.synchronize()

    t2 = now()
    try:
        for _ in prefetch_pipeline(offsets(), prep, dispatch, drain,
                                   depth=depth, workers=min(depth + 1, 4),
                                   family="ingest", index_key="chunk",
                                   order=order):
            pass
        matrix = asm.finish()
    finally:
        # the bin cache takes the matrix's bytes over from here
        LEDGER.free("chunk_stage", stage_bytes)
    pipeline_s = now() - t2
    peak = None
    if cuda:
        peak = int(torch.cuda.max_memory_allocated(dev) - mem0)
    insert_bins_cached(host, matrix)

    n_chunks = len(prep_walls)
    PROFILER.count("ingest.chunks", float(n_chunks))
    PROFILER.count("ingest.rows", float(n))
    PROFILER.count("ingest.raw_bytes", float(raw_bytes[0]))
    if n_chunks:
        INGEST_SKEW.note(f"ingest.{label}", prep_walls,
                         devices=list(range(n_chunks)), wall_s=pipeline_s)
    stats = {
        "n_chunks": n_chunks,
        "chunk_rows": int(source.chunk_rows),
        "prefetch_depth": depth,
        "sketch_exact": sketch.exact,
        "sketch_s": sketch_s,
        "pipeline_s": pipeline_s,
        "prep_s": float(sum(prep_walls)),
        "dispatch_s": float(sum(dispatch_walls)),
        "raw_bytes": int(raw_bytes[0]),
        "compact_bytes": int(host.nbytes),
        "chunk_stage_peak_bytes": peak,
        "order": order,
    }
    out = IngestResult(binned=host, y=y_host if labeled[0] else None,
                       binning=binning, n_rows=n, stats=stats, sketch=sketch)
    if key is not None:
        while len(_ingest_memo) >= _INGEST_MEMO_ENTRIES:
            _ingest_memo.pop(next(iter(_ingest_memo)))
        _ingest_memo[key] = out
    return out


def fit_ensemble_chunked(source: ChunkSource, *, categorical=None,
                         max_depth: int, max_bins: int,
                         min_instances: int = 1,
                         min_info_gain: float = 0.0, n_trees: int = 1,
                         feature_k: Optional[int] = None,
                         bootstrap: bool = False, subsample: float = 1.0,
                         seed: int = 17, loss: str = "squared",
                         step_size: float = 0.1, reg_lambda: float = 0.0,
                         gamma: float = 0.0, boosting: bool = False,
                         rounds_per_dispatch: Optional[int] = None,
                         drift_baseline=None, on_rounds=None, sketch=None,
                         device=None):
    """A tree-ensemble fit from a ChunkSource on `device`: the streamed
    quantization, then the ordinary `_fit_ensemble` over the prebinned
    compact matrix (its device copy already in the bin cache). Pass 1's
    sketch doubles as the fitted model's drift baseline (the full rows,
    no extra sketching); `drift_baseline` also arms the per-chunk ingest
    monitor against a PRIOR model's baseline (`ingest_source`). Raises
    for a source without labels."""
    from ._tree_models import _fit_ensemble
    ing = ingest_source(source, max_bins, categorical, sketch=sketch,
                        device=device, label="fit",
                        drift_baseline=drift_baseline)
    if ing.y is None:
        raise ValueError("fit_ensemble_chunked needs a labeled ChunkSource "
                         "(chunks must yield (X, y) with y not None)")
    return _fit_ensemble(
        None, ing.y, categorical=categorical or {}, max_depth=max_depth,
        max_bins=max_bins, min_instances=min_instances,
        min_info_gain=min_info_gain, n_trees=n_trees, feature_k=feature_k,
        bootstrap=bootstrap, subsample=subsample, seed=seed, loss=loss,
        step_size=step_size, reg_lambda=reg_lambda, gamma=gamma,
        boosting=boosting, rounds_per_dispatch=rounds_per_dispatch,
        prebinned=(ing.binned, ing.binning), baseline_sketch=ing.sketch,
        on_rounds=on_rounds, device=device)


def warm_start_ensemble_chunked(spec, source: ChunkSource, *,
                                n_new_trees: int, seed: int = 17,
                                drift_baseline=None, sketch=None,
                                device=None, **resume_kwargs):
    """Append `n_new_trees` boosting rounds to a saved boosted spec from
    a ChunkSource: the chunks bin under the saved binning
    (`ingest_source(binning=)`), the saved rounds' margin is replayed in
    one `forest_traverse` launch, and the new rounds run under the keys
    of their round index, so k rounds and a warm start of N - k equal N
    rounds bit for bit on the same rows and seed. Pass 1's sketch is the
    refreshed model's baseline, and `drift_baseline` arms the per-chunk
    ingest monitor. `resume_kwargs` are `_resume_ensemble`'s
    (subsample, step_size, feature_k, rounds_per_dispatch, on_rounds,
    ...)."""
    from ._tree_models import _resume_ensemble
    if spec.tree_weights is None:
        raise ValueError(
            "warm start needs a boosted spec (GBT/xgboost): forest/DT "
            "trees average independent rounds — refit those whole")
    categorical = {f: len(r) for f, r in spec.binning.cat_remap.items()}
    max_bins = spec.binning.edges.shape[1] + 1
    ing = ingest_source(source, max_bins, categorical, binning=spec.binning,
                        sketch=sketch, device=device, label="warm_fit",
                        drift_baseline=drift_baseline)
    if ing.y is None:
        raise ValueError("warm_start_ensemble_chunked needs a labeled "
                         "ChunkSource (chunks must yield (X, y) with y "
                         "not None)")
    return _resume_ensemble(spec, ing.binned, ing.y, n_new_trees=n_new_trees,
                            seed=seed, baseline_sketch=ing.sketch,
                            device=device, **resume_kwargs)


def iter_predictions(spec, source: ChunkSource, device=None):
    """Streamed prediction: a (predictions, labels) pair a chunk through
    `_EnsembleSpec.predict_margin`, each chunk binned and staged alone.
    A row's prediction does not depend on its batch, so they equal the
    whole call's bit for bit."""
    for X, y in source.chunks():
        yield spec.predict_margin(np.asarray(X, dtype=np.float64),
                                  device), y


def predict_chunked(spec_or_model, source: ChunkSource,
                    device=None) -> np.ndarray:
    """The (n,) float64 predictions of a whole ChunkSource."""
    spec = getattr(spec_or_model, "_spec", spec_or_model)
    outs = [p for p, _ in iter_predictions(spec, source, device)]
    return np.concatenate(outs) if outs else np.zeros(0)


def cross_validate_chunked(source: ChunkSource, k: int, split_seed: int, *,
                           categorical=None, device=None,
                           drift_baseline=None, **fit_params) -> dict:
    """k-fold CV from a ChunkSource: fold membership is the stateless
    per-row draw (`FoldChunkSource`), each fold's training view fits
    through the chunked path and its held fold's RMSE streams chunk by
    chunk; no fold is ever whole. `split_seed` seeds the folds, the
    estimator's `seed` rides in `fit_params`. The fold fits equal those
    of any other chunking bit for bit; the streamed RMSE sums per chunk,
    so it agrees across chunkings to reduction order. `drift_baseline`
    rides into every fold's ingest monitor."""
    fold_rmse = []
    for j in range(int(k)):
        train = FoldChunkSource(source, split_seed, k, j, invert=True)
        val = FoldChunkSource(source, split_seed, k, j, invert=False)
        spec = fit_ensemble_chunked(train, categorical=categorical,
                                    device=device,
                                    drift_baseline=drift_baseline,
                                    **fit_params)
        sse = 0.0
        cnt = 0
        for pred, y in iter_predictions(spec, val, device):
            d = pred - np.asarray(y, dtype=np.float64)
            sse += float(d @ d)
            cnt += d.size
        fold_rmse.append(float(np.sqrt(sse / max(cnt, 1))))
    return {"avg_rmse": float(np.mean(fold_rmse)), "fold_rmse": fold_rmse,
            "k": int(k), "seed": int(split_seed)}
