"""Typed configuration registry (the `spark.conf` equivalent), for the
keys the DataFrame layer and the tree-ensemble serving and fit paths
read.

Known keys carry a type and a default; unknown `sml.*` keys raise on
`get` so a typo cannot silently read a default. Counterpart of
`sml_tpu/conf.py`, cut to the ported slices (serving, the fits,
tuning and the host layer). `sml.device` has no JAX
counterpart key: it is the port's form of the JAX package's
process-wide platform choice (`jax.config.update("jax_platforms",
...)`). The JAX package's `sml.tree.kernel` and
`sml.tree.kernelBlockRows` are not ported: on the card there is one
path (the kernel, or raise), and block sizes come from the shapes, in
each kernel's wrapper. Nor is `sml.tree.histSubtraction`: the port
always builds with subtraction, its default. ROADMAP.md section 1 lists
every key the JAX package registers and the port does not, each with
its reason; `registered_keys()` and `describe()` dump the registry, and
the lint (`sml_tpu_torch/lint/`) holds every conf literal of the port
against it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    caster: Callable[[str], Any]
    doc: str = ""


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "on")


_KNOWN: Dict[str, ConfEntry] = {}


def _register(key: str, default: Any, caster: Callable[[str], Any],
              doc: str = "") -> None:
    _KNOWN[key] = ConfEntry(key, default, caster, doc)


_register("sml.serve.maxBatchRows", 4096, int,
          "Serving micro-batcher: max rows coalesced into one device "
          "launch; a full batch flushes immediately")
_register("sml.serve.flushMicros", 2000, int,
          "Serving micro-batcher: microseconds a partial batch waits for "
          "more requests before flushing (deadline from the OLDEST queued "
          "request). 0 = flush as soon as the worker is free")
_register("sml.serve.flushAutoTune", False, _to_bool,
          "Serving micro-batcher deadline auto-tuning: adapt the flush "
          "deadline each cycle between the measured drain time (median "
          "serve.batch_ms, else dispatch.device_ms: the floor) and the SLO "
          "budget (half sml.serve.sloMillis minus the drain: the ceiling), "
          "targeting the time the measured arrival intensity needs to fill "
          "one batch. It reads the metrics histograms, which fill only with "
          "the recorder on (sml.obs.enabled). Off = flushMicros is static. "
          "Under sparse arrivals the rule RAISES the deadline toward its "
          "ceiling, the JAX package's behaviour")
_register("sml.serve.queueRows", 32768, int,
          "Serving admission bound: rows queued or in flight toward the "
          "device (parallel.dispatch.DEVICE_QUEUE) above which new requests "
          "degrade to the host route or shed instead of queueing")
_register("sml.serve.hostFallback", False, _to_bool,
          "Serving degradation ladder: score queue-overflow requests on the "
          "host route in the submitting thread instead of shedding them. "
          "Off by default (the JAX package's is on): the port's serving "
          "runs on a card, and work moves off it only when the caller asks")
_register("sml.serve.sloMillis", 250, int,
          "Per-request latency SLO target (milliseconds, admission to "
          "result): the serve.request_ms histogram counts breaches against "
          "it (obs.slo_report), and the flush auto-tuner's ceiling is half "
          "of it")
_register("sml.serve.sloBudget", 0.01, float,
          "Latency-SLO error budget: the fraction of requests allowed over "
          "sml.serve.sloMillis. burn_rate = breach_fraction / budget")
_register("sml.serve.requestTimeoutMillis", 250, int,
          "Serving deadline: a request still undispatched this long after "
          "admission is shed at flush time. 0 = no deadline")
_register("sml.serve.modelCacheBytes", 1 << 30, int,
          "Byte budget for the serving multi-model LRU cache of warm "
          "DeviceScorers (costed by DeviceScorer.resident_bytes)")
_register("sml.serve.canaryFraction", 0.0, float,
          "Fraction of endpoint traffic mirrored to the Staging version "
          "(shadow/canary mode): mirrored requests score on the host "
          "route off the request path and feed prediction-divergence stats "
          "(ServingEndpoint.canary_stats). 0 disables")
_register("sml.predict.binCacheBytes", 1 << 30, int,
          "LRU byte bound for memoized predict-time binned matrices")
_register("sml.tree.binCacheBytes", 2 << 30, int,
          "Device-bytes budget for the content-keyed cache of staged "
          "compact bin matrices and stacked fold matrices")
_register("sml.tree.roundsPerDispatch", 0, int,
          "Boosting rounds between round-level hook points: k > 0 splits "
          "a boosted fit's rounds into ceil(n_trees/k) segments, each "
          "counted as one tree.fit_dispatch, and an on_rounds hook (the "
          "round checkpoints of ct/) fires at each segment boundary but "
          "the last; 0 = the whole ensemble as one segment (default). "
          "The trees do not depend on it")
_register("sml.tree.hierarchicalAllreduce", "auto", str,
          "Two-level histogram allreduce on host-grouped meshes: "
          "'auto' = intra-group reduce-scatter over the 'ici' hop + "
          "inter-group allreduce over the 'dcn' hop + allgather back "
          "whenever the active mesh declares a host axis "
          "(mesh.host_mesh); 'true' = same, but error-prone on flat "
          "meshes so it still requires the host axes; 'false' = always "
          "the flat single-hop psum. Per-hop launches/bytes land in "
          "collective.psum[_bytes].ici/.dcn")
_register("sml.mesh.hostGroups", 0, int,
          "Default host-group count for mesh.host_mesh() when called "
          "without an explicit `hosts`: 0 = auto (the node count, "
          "WORLD_SIZE / LOCAL_WORLD_SIZE, when torchrun started the "
          "ranks on several nodes, else 1); N>0 = N virtual host groups "
          "partitioning the ranks (the single-machine testing story for "
          "the multi-host code path)")
_register("sml.data.chunkRows", 65536, int,
          "Row-block size of the out-of-core data plane (frame/_chunks.py): "
          "ChunkSources yield chunks of at most this many rows, and the "
          "chunked ingest quantizes and stages one chunk at a time, so "
          "host residency is a few chunk buffers plus the compact bin "
          "matrix, never the raw float data")
_register("sml.data.sketchBuckets", 2048, int,
          "Centroid budget per feature of the streamed-quantization "
          "quantile sketch: below the exact cap the sketch holds raw "
          "values (bin edges bit-identical to make_bins), above it each "
          "feature compresses to this many weight-uniform centroids "
          "(edges within one bin width for buckets >> maxBins)")
_register("sml.data.prefetchChunks", 2, int,
          "Chunked-ingest lookahead: chunks dispatched (copied to the "
          "device from pinned staging buffers) ahead of the drain point, "
          "so chunk i+1's host quantization overlaps chunk i's copy; also "
          "the number of pinned staging buffers. 1 = fully synchronous")
_register("sml.fit.foldStackBytes", 1 << 30, int,
          "Byte bound for the fit-time fold-stack memo (stacked CV fold "
          "datasets reused across a tuning grid)")
_register("sml.device", "cuda", str,
          "Device the DataFrame entry points run on (a tree estimator's "
          "fit(df), a model's transform, the evaluators), through "
          "device.resolve_device: the card by default; 'cpu' runs the "
          "kernels' plain versions on the host")
_register("sml.default.parallelism", 8, int,
          "Default partition count for new data sources")
_register("sml.shuffle.partitions", 8, int,
          "Partition count after shuffles (spark.sql.shuffle.partitions)")
_register("spark.sql.shuffle.partitions", 8, int,
          "Alias kept for course compatibility")
_register("sml.arrow.maxRecordsPerBatch", 10000, int,
          "Arrow record-batch size for pandas-fn fan-out")
_register("spark.sql.execution.arrow.maxRecordsPerBatch", 10000, int,
          "Alias kept for course compatibility")
_register("sml.applyInPandas.parallelism", 8, int,
          "Concurrent per-group fn threads in applyInPandas; 1 = sequential "
          "(needed only by fns that mutate shared closure state)")
_register("sml.shuffle.reuseBytes", 1 << 30, int,
          "Byte bound for the shuffle-reuse cache (memoized applyInPandas "
          "group splits of cached frames); 0 disables reuse")
_register("sml.split.sampler", "spark", str,
          "randomSplit sampler: 'spark' = draw-for-draw Spark parity "
          "(per-partition determinism sort + XORShiftRandom Bernoulli "
          "cells); 'legacy' = the JAX package's pre-Spark numpy draws")
_register("sml.cv.maxFusedTrials", 16, int,
          "Max (grid point x fold) fits fused into one device fit: a "
          "G-point grid over k folds costs ceil(G*k/maxFusedTrials) fit "
          "dispatches; <= 1 fuses only the folds (one fit per grid point)")
_register("sml.cv.batchFolds", True, _to_bool,
          "Fuse tree-regressor CV/TVS trial fits: with "
          "sml.cv.maxFusedTrials > 1 the grid axis fuses too, so a G-point "
          "grid over k folds costs ceil(G*k/maxFusedTrials) tree-fit "
          "dispatches; every element is its sequential fit bit for bit. "
          "false forces placed trials")
_register("sml.cv.trialAxisDevices", 0, int,
          "Ranks spanned by the fused-trial ELEMENT axis: grid-fused "
          "(grid point x fold) trials spread over lanes of ranks (a "
          "'trial' axis) while each trial lane keeps splitting rows over "
          "its own ranks, so E trials progress on disjoint ranks with an "
          "n/t-wide (often allreduce-free) data axis apiece, instead of "
          "every trial spanning all ranks. 0 = auto (spread trials "
          "whenever one trial's padded rows fit a single rank "
          "comfortably: the small-rows regime where the per-level "
          "allreduce latency dominates the per-rank histogram); 1 = "
          "rows-only sharding; k > 1 clamps to the largest mesh divisor "
          "<= k (the element axis pads by repeating element 0). Every "
          "layout fits the one-rank trees bit for bit")
_register("sml.tune.candidatesPerDispatch", 4, int,
          "TPE candidates proposed AND scored per generation for "
          "batch-capable fmin objectives (fn.score_batch): a "
          "tree-estimator objective backed by "
          "ml.tuning.fused_param_scores pays one fused device fit per "
          "generation instead of one per trial; <= 1 keeps the "
          "sequential propose-score loop")
_register("sml.linear.compactBytes", 1 << 28, int,
          "Expanded-block size (n*d*4) above which linear/logistic fits "
          "stage the compact numeric+code form and expand one-hot slots "
          "on-chip instead of materializing the (n, d) matrix")
_register("sml.compile.cacheDir", "", str,
          "Directory of the prewarm manifest (parallel/prewarm.py): empty = "
          "sml_tpu_torch/native/build/, beside the built kernel libraries")
_register("sml.obs.enabled", False, _to_bool,
          "Flight-recorder event bus (sml_tpu_torch.obs): record typed "
          "engine events (spans, counters, dispatch decisions) into a "
          "bounded ring for the dispatch audit, and fill the metrics "
          "histograms. Disabled, every instrumentation site costs one "
          "attribute load")
_register("sml.obs.ringEvents", 65536, int,
          "Capacity of the flight recorder's in-memory event ring; the "
          "oldest events are dropped (and counted) once full. Resizing "
          "keeps the newest events")
_register("sml.obs.sinkPath", "", str,
          "Optional JSONL sink: every recorded event is also appended to "
          "this file as one JSON object per line (empty = ring only). "
          "Applied when set")
_register("sml.obs.sinkMaxBytes", 64 << 20, int,
          "Byte bound for the JSONL sink file: past it the live file "
          "rotates once to <sinkPath>.1 (replacing the previous roll) and "
          "reopens fresh. 0 = unlimited")
_register("sml.obs.metricsWindowSec", 300, int,
          "Rolling-window span of the metrics registry (obs/_metrics.py): "
          "windowed quantiles and rates cover the trailing this-many "
          "seconds (8 ring slots); all-time histograms are kept regardless")
_register("sml.obs.autoLogRunMetrics", True, _to_bool,
          "With the recorder enabled, every outermost Estimator.fit under "
          "an active tracking run logs engine.* metrics (h2d/d2h bytes, "
          "cache hit rates, route mix, compile count, peak device ledger "
          "bytes) to the run: the MLflow system-metrics equivalent")
_register("sml.obs.driftBaselineRows", 32768, int,
          "Fit-time drift-baseline capture (obs/drift.py): with the "
          "recorder on (sml.obs.enabled; an obs-off fit pays one "
          "attribute load, not a sketch pass), tree fits sketch up to "
          "this many deterministically-strided training rows (features "
          "+ label + the model's own predictions) into the fitted "
          "model's DriftBaseline, persisted with the model and logged "
          "through tracking.log_model; persisted sketches compress to "
          "the sml.data.sketchBuckets centroid budget. 0 disables "
          "capture. Also bounds the retained values per stream of "
          "serving live-window sketches. The chunked-ingest path "
          "reuses its full-data pass-1 sketch instead (no extra cost)")
_register("sml.obs.driftBins", 10, int,
          "PSI cell count for drift distances: live-vs-baseline "
          "population stability is measured over this many "
          "equal-probability cells cut at the BASELINE's quantiles")
_register("sml.obs.driftMargin", 2.0, float,
          "Drift flag threshold as a multiple of the noise floor (the "
          "max self-distance of resampled-baseline iid windows): a "
          "feature flags when its distance exceeds margin x floor. "
          "Higher = less sensitive")
_register("sml.obs.driftMinRows", 256, int,
          "Minimum live rows in a drift window before it is judged: "
          "tiny windows carry too much sampling noise to name a "
          "drifting feature honestly")
_register("sml.obs.driftResamples", 3, int,
          "Bootstrap resamples of the baseline used to set each "
          "feature's noise floor (deterministic seeds; floors cached "
          "per rounded-down power-of-two live-row count)")
_register("sml.obs.driftWindowSec", 300, int,
          "Rolling-window span of serving drift monitors: live sketches "
          "rotate in two half-window slots, so a drift report covers "
          "between half and one full window of recent traffic")
_register("sml.obs.blackboxDir", "blackbox", str,
          "Directory black-box forensics bundles are written under "
          "(obs.dump_blackbox, and unhandled exceptions and the first "
          "hard stall once obs.install_blackbox() armed them). Each dump "
          "creates one blackbox-<utc>-<pid> bundle inside it")
_register("sml.profiler.enabled", False, _to_bool,
          "Keep op-level timing spans (utils/profiler.py: PROFILER.spans, "
          "PROFILER.report); counters count either way")
_register("sml.delta.retentionDurationCheck.enabled", True, _to_bool,
          "Refuse DeltaTable.vacuum below the 168-hour default retention "
          "unless disabled")
_register("spark.databricks.delta.retentionDurationCheck.enabled", True,
          _to_bool, "Alias of sml.delta.retentionDurationCheck.enabled, "
          "the course's spelling")
_register("sml.training.module-name", "", str,
          "Course module name stamped by the Classroom-Setup shim "
          "(courseware.CourseConfig)")
_register("sml.training.username", "", str,
          "Course username stamped by the Classroom-Setup shim")
_register("sml.infer.prefetchBatches", 4, int,
          "DeviceScorer.score_batches lookahead: batches dispatched ahead "
          "of the drain point so batch i+1's prep + H2D staging overlaps "
          "batch i's compute and D2H (was a hard-coded 4). 1 = fully "
          "synchronous")


class TorchConf:
    """Thread-safe KV config with typed known keys and free-form extras."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._values: Dict[str, Any] = {}
        self._on_set: Dict[str, Callable[[], None]] = {}

    def on_set(self, key: str, fn: Callable[[], None]) -> None:
        """Register a callback fired after `key` is set or unset (one per
        key: the recorder re-reads its `sml.obs.*` keys through it)."""
        with self._lock:
            self._on_set[key] = fn

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            ent = _KNOWN.get(key)
            if ent is not None and not isinstance(value, type(ent.default)):
                value = ent.caster(value)
            self._values[key] = value
            # keep spark.* aliases and sml.* keys in step both ways
            alias = _ALIASES.get(key)
            if alias is not None:
                self._values[alias] = value
            hook = self._on_set.get(key)
        if hook is not None:  # outside the lock: hooks may read conf
            hook()

    def get(self, key: str, default: Optional[Any] = None) -> Any:
        with self._lock:
            if key in self._values:
                return self._values[key]
            ent = _KNOWN.get(key)
            if ent is not None:
                return ent.default
            if default is not None:
                return default
            raise KeyError(f"No such config key: {key!r} — not registered "
                           f"in sml_tpu_torch/conf.py and never set()")

    def getInt(self, key: str) -> int:
        return int(self.get(key))

    def getBool(self, key: str) -> bool:
        return _to_bool(self.get(key))

    def asDict(self) -> Dict[str, Any]:
        """Every registered key's value (its default unless set) and
        every key set: the black-box bundle's conf dump."""
        with self._lock:
            d = {k: e.default for k, e in _KNOWN.items()}
            d.update(self._values)
            return d

    def unset(self, key: str) -> None:
        with self._lock:
            self._values.pop(key, None)
            alias = _ALIASES.get(key)
            if alias is not None:
                self._values.pop(alias, None)
            hook = self._on_set.get(key)
        if hook is not None:
            hook()


def registered_keys() -> tuple:
    """Every registered key, sorted: the programmatic registry dump the
    lint's conf-key-registry rule cross-checks call sites against
    (conf.py loads by path with no dependency beyond the standard
    library for exactly this reason)."""
    return tuple(sorted(_KNOWN))


def describe() -> Dict[str, Dict[str, Any]]:
    """key -> {default, type, doc} for the full registry (the late
    registrars' keys, such as parallel.dispatch's, appear once their
    module has been imported)."""
    return {k: {"default": e.default, "type": type(e.default).__name__,
                "doc": e.doc}
            for k, e in sorted(_KNOWN.items())}


_ALIASES = {
    "spark.sql.shuffle.partitions": "sml.shuffle.partitions",
    "sml.shuffle.partitions": "spark.sql.shuffle.partitions",
    "spark.sql.execution.arrow.maxRecordsPerBatch":
        "sml.arrow.maxRecordsPerBatch",
    "sml.arrow.maxRecordsPerBatch":
        "spark.sql.execution.arrow.maxRecordsPerBatch",
    "spark.databricks.delta.retentionDurationCheck.enabled":
        "sml.delta.retentionDurationCheck.enabled",
    "sml.delta.retentionDurationCheck.enabled":
        "spark.databricks.delta.retentionDurationCheck.enabled",
}

GLOBAL_CONF = TorchConf()
