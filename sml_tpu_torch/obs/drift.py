"""Model & data drift: distribution distances over mergeable sketches.

The port's copy of `sml_tpu/obs/drift.py`: on the same sketches its
distances and noise floors equal the JAX package's bit for bit, and a
baseline either package saves loads in the other. Systems
observability (spans, counters, stragglers, stalls) does not notice when
the STATISTICS flowing through it change: serving traffic quietly stops
looking like the training data, an ingest stream skews, a model's
prediction distribution collapses — the silent failure mode systems
metrics cannot name (the monitoring-first deployment discipline of the
courseware's MLE electives, and the data-quality half of the straggler
literature's argument). This module is that layer, built entirely on
machinery the engine already owns:

- **Baselines** (`DriftBaseline`): the training distribution as the
  mergeable `DatasetSketch`/`FeatureSketch` summaries the out-of-core
  plane already builds (`frame/_chunks.py`) — per-feature quantile
  sketches (exact below the cap, weight-uniform centroids past it),
  categorical frequency tables, plus a label sketch and a sketch of the
  model's own TRAINING predictions. Tree fits stamp one into the fitted
  `_EnsembleSpec` (`capture_fit_baseline`, host numpy only: capture
  launches no kernel); it persists as `baseline.json` through the
  spec's save/load and `tracking.log_model`, so a registry version
  CARRIES its baseline.
- **Distances**: per-feature PSI over baseline-decile cells
  (`psi_distance`) and a normalized quantile-shift distance
  (`quantile_shift`) from the sketch CDF/quantile queries — both exact
  in exact mode and bucket-approximate in compressed mode; categorical
  frequency PSI from the streamed `_cat_cnt` tables
  (`categorical_psi`); the prediction sketch judged like a feature.
- **Noise-aware thresholds**: the
  flag floor is the SELF-DISTANCE of the baseline — resample n_live
  values from the baseline's own stream, measure the distance of that
  iid sample against the baseline, repeat, and take the max. An iid
  live window is statistically exchangeable with those resamples, so
  iid traffic never false-positives; the `sml.obs.driftMargin` multiple
  on top is the sensitivity knob. Floors are cached per (feature,
  rounded-down power-of-two n) — smaller n = wider floor = conservative.
- **Monitors** (`DriftMonitor` + the `DRIFT` registry): rolling-window
  live sketches fed by the serving micro-batch path (`observe_block`,
  with per-feature WORST-REQUEST trace exemplars: the most-outlying
  row's trace id per feature) and by the chunked-ingest
  sketch pass (`observe_sketch`, per-chunk drift = the refit-trigger
  signal for continuous training). `engine_health()["drift"]` and
  `ServingEndpoint.health_report()` surface every registered monitor's
  `report()`; reports land `drift.*` events/gauges in the recorder.

Hot-path contract (tests/test_torch_drift.py): every observation site is a
no-op behind ONE attribute load when `sml.obs.enabled` is false — no
sketch allocation, no lock. Report/threshold math happens at READ time
(health polls), never on the request path.

Knobs: `sml.obs.driftBaselineRows` (fit-time capture subsample; 0
disables capture), `sml.obs.driftBins` (PSI cells),
`sml.obs.driftMargin` (floor multiple), `sml.obs.driftMinRows` (rows
before a window is judged), `sml.obs.driftResamples` (noise-floor
bootstrap count), `sml.obs.driftWindowSec` (serving live window).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..conf import GLOBAL_CONF
from . import _context
from ._recorder import RECORDER

#: probability floor for PSI cell fractions (an empty cell contributes a
#: large-but-finite term instead of an infinity)
_EPS = 1e-6
#: absolute floors under the resampled noise floors: distances smaller
#: than these are below any actionable effect size regardless of n
_PSI_ABS_FLOOR = 0.02
_SHIFT_ABS_FLOOR = 0.02
#: deterministic seed base for the noise-floor resamples (obs code may
#: not draw wall-clock entropy; thresholds must reproduce run to run)
_FLOOR_SEED = 0x5D17F
#: per-chunk ingest summaries retained per monitor (bounded like the
#: skew tracker's program ring)
_MAX_CHUNKS = 256
#: report-cache TTL: `engine_health()` is documented as safe to poll,
#: so a monitor recomputes its distances at most this often — a 1 Hz
#: liveness probe pays one distance pass per TTL, not per poll
_REPORT_TTL_S = 5.0


def _psi_terms(p: np.ndarray, q: np.ndarray) -> float:
    p = np.maximum(np.asarray(p, dtype=np.float64), _EPS)
    q = np.maximum(np.asarray(q, dtype=np.float64), _EPS)
    return float(np.sum((q - p) * np.log(q / p)))


def _cell_fracs(sk, edges: np.ndarray) -> np.ndarray:
    """Mass per cell of the partition cut at `edges` (K+1 cells for K
    edges), from the sketch's weighted CDF."""
    if edges.size == 0:
        return np.ones(1, dtype=np.float64)
    c = sk.cdf(edges)
    return np.diff(np.concatenate(([0.0], c, [1.0])))


def baseline_edges(base_sk, bins: Optional[int] = None) -> np.ndarray:
    """The PSI cell cuts: the BASELINE's interior quantiles at
    `sml.obs.driftBins` equal-probability cells (collapsed duplicates —
    a near-constant feature legitimately yields fewer cells)."""
    k = int(bins or GLOBAL_CONF.getInt("sml.obs.driftBins"))
    if base_sk.n_seen == 0:
        return np.zeros(0, dtype=np.float64)
    probs = np.arange(1, k, dtype=np.float64) / k
    return np.unique(np.asarray(base_sk.quantiles(probs), dtype=np.float64))


def psi_distance(base_sk, live_sk, bins: Optional[int] = None) -> float:
    """Population stability index of `live_sk` against `base_sk` over
    the baseline's decile cells. 0.0 for identical sketches EXACTLY
    (the reload-self-check contract); rule-of-thumb scale: < 0.1 stable,
    > 0.25 shifted — but the monitors judge against the resampled noise
    floor, not the folklore cutoffs."""
    edges = baseline_edges(base_sk, bins)
    return _psi_terms(_cell_fracs(base_sk, edges),
                      _cell_fracs(live_sk, edges))


def quantile_shift(base_sk, live_sk,
                   probs: Sequence[float] = (0.1, 0.25, 0.5, 0.75,
                                             0.9)) -> float:
    """Max absolute quantile displacement live-vs-baseline, normalized
    by the baseline's [q10, q90] span — a location/scale-shift detector
    that PSI's cell counting can under-weight. 0.0 for identical
    sketches exactly."""
    if base_sk.n_seen == 0 or live_sk.n_seen == 0:
        return 0.0
    ps = np.sort(np.asarray(probs, dtype=np.float64))
    bq = np.asarray(base_sk.quantiles(ps), dtype=np.float64)
    lq = np.asarray(live_sk.quantiles(ps), dtype=np.float64)
    # the probe span doubles as the scale (ps sorted: ends = the
    # outermost probes) — no extra quantile queries in the hot floor loop
    span = float(bq[-1] - bq[0])
    scale = max(abs(span), 1e-3 * max(float(np.max(np.abs(bq))), 1e-12))
    return float(np.max(np.abs(lq - bq))) / scale


def categorical_psi(base_cnt: np.ndarray, live_cnt: np.ndarray) -> float:
    """PSI over category frequencies (the streamed `_cat_cnt` tables):
    same smoothing and zero-for-identical contract as the continuous
    distance."""
    b = np.asarray(base_cnt, dtype=np.float64)
    l = np.asarray(live_cnt, dtype=np.float64)
    bt, lt = b.sum(), l.sum()
    if bt == 0 or lt == 0:
        return 0.0
    return _psi_terms(b / bt, l / lt)


# ------------------------------------------------------- noise-aware floors
def _resampled_sketch(base_sk, n: int, rng: np.random.Generator):
    """An iid n-sample from the baseline's own retained stream, as a
    fresh sketch — what an undrifted live window of n rows looks like."""
    from ..frame._chunks import FeatureSketch
    v, w = base_sk.values_weights()
    out = FeatureSketch(buckets=base_sk.buckets,
                        exact_cap=base_sk.exact_cap)
    if v.size:
        p = w / w.sum()
        out.update(rng.choice(v, size=int(n), replace=True, p=p))
    return out


def continuous_floor(base_sk, n_live: int, feature: int = 0,
                     resamples: Optional[int] = None,
                     bins: Optional[int] = None) -> Tuple[float, float]:
    """(psi_floor, shift_floor): the max self-distance of `resamples`
    iid n_live-row resamples of the baseline against the baseline —
    the statistical noise an undrifted window of this size carries.
    Deterministic (seeded per (feature, resample))."""
    r = int(resamples or GLOBAL_CONF.getInt("sml.obs.driftResamples"))
    psis, shifts = [_PSI_ABS_FLOOR], [_SHIFT_ABS_FLOOR]
    for i in range(r):
        rng = np.random.default_rng((_FLOOR_SEED, int(feature), i))
        s = _resampled_sketch(base_sk, n_live, rng)
        psis.append(psi_distance(base_sk, s, bins))
        shifts.append(quantile_shift(base_sk, s))
    return max(psis), max(shifts)


def categorical_floor(base_cnt: np.ndarray, n_live: int, feature: int = 0,
                      resamples: Optional[int] = None) -> float:
    """PSI floor for a categorical table: max self-PSI of multinomial
    n_live-draws from the baseline frequencies."""
    b = np.asarray(base_cnt, dtype=np.float64)
    if b.sum() == 0:
        return _PSI_ABS_FLOOR
    r = int(resamples or GLOBAL_CONF.getInt("sml.obs.driftResamples"))
    p = b / b.sum()
    out = [_PSI_ABS_FLOOR]
    for i in range(r):
        rng = np.random.default_rng((_FLOOR_SEED, int(feature), i, 1))
        draw = rng.multinomial(int(n_live), p)
        out.append(categorical_psi(b, draw))
    return max(out)


def _floor_bucket(n: int) -> int:
    """Rounded-DOWN power of two: floors cache per bucket, and a smaller
    resample n has MORE noise, so the cached floor is conservative for
    every n in the bucket."""
    return 1 << max(int(n).bit_length() - 1, 0)


def _effective_n(n_live: int, n_base: int) -> int:
    """The resample size whose single-sample noise matches the TWO
    noises a real comparison carries: the live window's sampling noise
    AND the baseline's own estimation noise (it is itself an n_base-row
    sample of the true distribution). For chi-square-shaped statistics
    (PSI) the variances add — 1/n_eff = 1/n_live + 1/n_base, the
    harmonic combination. A floor resampled at n_live alone
    under-estimates exactly when the baseline is small relative to the
    window (observed first on the discrete prediction stream)."""
    n_live, n_base = max(int(n_live), 1), max(int(n_base), 1)
    return max((n_live * n_base) // (n_live + n_base), 1)


# --------------------------------------------------------------- baselines
class DriftBaseline:
    """The training distribution a fitted model carries: the feature
    `DatasetSketch` (quantile sketches + categorical tables), a label
    `FeatureSketch`, and a sketch of the model's own training-set
    predictions. JSON round-trips via to_dict/from_dict (the
    `baseline.json` the tree `_EnsembleSpec` persists); a reloaded
    baseline's distance against itself is exactly zero."""

    def __init__(self, features, label=None, prediction=None,
                 n_rows: int = 0, sampled_rows: int = 0):
        self.features = features          # DatasetSketch
        self.label = label                # FeatureSketch | None
        self.prediction = prediction      # FeatureSketch | None
        self.n_rows = int(n_rows)         # training rows the fit saw
        self.sampled_rows = int(sampled_rows)  # rows the sketch retained

    def to_dict(self) -> dict:
        out = {"n_rows": self.n_rows, "sampled_rows": self.sampled_rows,
               "features": self.features.to_dict()}
        if self.label is not None:
            out["label"] = self.label.to_dict()
        if self.prediction is not None:
            out["prediction"] = self.prediction.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "DriftBaseline":
        from ..frame._chunks import DatasetSketch, FeatureSketch
        return cls(
            DatasetSketch.from_dict(d["features"]),
            label=(FeatureSketch.from_dict(d["label"])
                   if "label" in d else None),
            prediction=(FeatureSketch.from_dict(d["prediction"])
                        if "prediction" in d else None),
            n_rows=int(d.get("n_rows", 0)),
            sampled_rows=int(d.get("sampled_rows", 0)))


def _np_forest_predict(binned: np.ndarray, trees, depth: int,
                       tree_weights, base: float, mode: str) -> np.ndarray:
    """Host-side (pure numpy) forest prediction over a binned matrix —
    the kernel's traversal and `DeviceScorer`'s finalize, kept off the
    device so baseline capture never changes a fit's kernel launches or
    staging counters."""
    binned = np.asarray(binned, dtype=np.int64)
    n = binned.shape[0]
    rows = np.arange(n)
    acc = np.zeros(n, dtype=np.float64)
    weights = ([1.0 / len(trees)] * len(trees) if tree_weights is None
               else [float(w) for w in tree_weights])
    for t, w in zip(trees, weights):
        sf = np.asarray(t.split_feature, dtype=np.int64)
        sb = np.asarray(t.split_bin, dtype=np.int64)
        lv = np.asarray(t.leaf_value, dtype=np.float64)
        node = np.zeros(n, dtype=np.int64)
        for _ in range(depth):
            f = sf[node]
            internal = f >= 0
            xbin = binned[rows, np.maximum(f, 0)]
            child = 2 * node + 1 + (xbin > sb[node]).astype(np.int64)
            node = np.where(internal, child, node)
        acc += w * lv[node]
    margin = base + acc
    if mode == "binary":
        if tree_weights is not None:
            return 1.0 / (1.0 + np.exp(-margin))
        return np.clip(margin, 0.0, 1.0)
    return margin


def _bounded_feature_copy(sk, cap: int):
    """A persistence-sized copy of one FeatureSketch: past `cap`
    retained values it compresses to the centroid budget (the source
    sketch is left untouched). Distances only need sketch accuracy
    (~1/buckets), so a persisted baseline never stores more than ~cap
    raw values per stream."""
    from ..frame._chunks import FeatureSketch
    v, w = sk.values_weights()
    if v.size <= cap:
        return sk
    b = FeatureSketch(buckets=sk.buckets,
                      exact_cap=min(sk.exact_cap, int(cap)))
    b._vals = [v]
    b._wts = [w]
    b._n = int(v.size)
    b.n_seen = sk.n_seen
    b._exact = sk.exact
    b._compress()
    return b


def _bounded_sketch_copy(dsk, cap: int):
    """`_bounded_feature_copy` over a whole DatasetSketch: baselines
    persist bounded no matter how large the fit/ingest was (the ingest's
    own sketch is untouched — it still finalizes the bin edges
    exactly)."""
    from ..frame._chunks import DatasetSketch
    if all(sk.values_weights()[0].size <= cap
           for sk in dsk.features.values()):
        return dsk
    out = DatasetSketch(dsk.n_features, dsk.categorical)
    out.n_rows = dsk.n_rows
    for f, sk in dsk.features.items():
        out.features[f] = _bounded_feature_copy(sk, cap)
    for f in dsk.categorical:
        out._cat_sum[f] = dsk._cat_sum[f].copy()
        out._cat_cnt[f] = dsk._cat_cnt[f].copy()
    return out


def capture_fit_baseline(X: Optional[np.ndarray], y: np.ndarray,
                         categorical: Optional[Dict[int, int]], spec, *,
                         binned: Optional[np.ndarray] = None,
                         sketch=None) -> Optional[DriftBaseline]:
    """Build the baseline `_fit_ensemble` stamps into a fitted spec —
    ONLY with the recorder enabled (an obs-off fit pays one attribute
    load, not a sketch pass; train with
    `sml.obs.enabled=true` to produce monitorable models). Cost is
    bounded by `sml.obs.driftBaselineRows` (0 disables): a
    deterministic row stride caps the sketched/predicted sample
    regardless of n, and persisted sketches compress to the
    `sml.data.sketchBuckets` centroid budget. The chunked path passes
    its ingest pass-1 `sketch` (the FULL-data summary, already paid
    for) instead of raw X."""
    if not RECORDER.enabled:
        return None
    cap = GLOBAL_CONF.getInt("sml.obs.driftBaselineRows")
    if cap <= 0:
        return None
    from ..frame._chunks import DatasetSketch, FeatureSketch
    persist_cap = max(GLOBAL_CONF.getInt("sml.data.sketchBuckets"), 64)
    n = len(y)
    stride = max(1, -(-n // cap))
    if sketch is not None:
        features = _bounded_sketch_copy(sketch, persist_cap)
        sampled = getattr(sketch, "n_rows", n)
    elif X is not None:
        features = DatasetSketch(X.shape[1], categorical)
        features.update(np.asarray(X)[::stride], np.asarray(y)[::stride])
        sampled = features.n_rows
        features = _bounded_sketch_copy(features, persist_cap)
    else:
        return None  # prebinned without a sketch: raw features are gone
    label = FeatureSketch()
    label.update(np.asarray(y, dtype=np.float32)[::stride])
    label = _bounded_feature_copy(label, persist_cap)
    prediction = None
    if binned is not None and getattr(spec, "trees", None):
        pred = _np_forest_predict(
            np.asarray(binned)[::stride], spec.trees, spec.depth,
            spec.tree_weights, spec.base, spec.mode)
        prediction = FeatureSketch()
        prediction.update(np.asarray(pred, dtype=np.float32))
        prediction = _bounded_feature_copy(prediction, persist_cap)
    return DriftBaseline(features, label=label, prediction=prediction,
                         n_rows=n, sampled_rows=sampled)


# ---------------------------------------------------------------- monitors
class DriftMonitor:
    """Rolling live-vs-baseline drift for one traffic stream.

    Two feed paths: `observe_block(X, preds, traces)` (the serving
    micro-batch path — raw feature rows, finalized predictions, and
    per-row trace ids for worst-request exemplars) and
    `observe_sketch(chunk_sketch, index)` (the chunked-ingest pass —
    per-chunk `DatasetSketch`es judged chunk-by-chunk AND merged into
    the window). The live window is two half-window slots rotated in
    place (`sml.obs.driftWindowSec`), so `report()` always covers
    between half and one full window.

    Both observe paths early-out on `RECORDER.enabled` behind one
    attribute load (the disabled-overhead contract). All distance
    and threshold math runs in `report()` — poll-time, not request-time.
    """

    def __init__(self, baseline: DriftBaseline, name: str = "serving",
                 window_s: Optional[float] = None):
        self._rec = RECORDER
        self.baseline = baseline
        self.name = name
        self._window_s = float(
            window_s if window_s is not None
            else GLOBAL_CONF.getInt("sml.obs.driftWindowSec"))
        self._lock = threading.Lock()
        self._slots: List[list] = []   # [t_start, DatasetSketch, pred FS]
        #: per-feature worst-request exemplar: feature -> (outlier score,
        #: value, trace id) — the literal request to go look at
        self._worst: Dict[int, tuple] = {}
        self._chunks: List[dict] = []
        self._chunks_seen = 0
        self._chunks_flagged = 0
        self._floors: Dict[tuple, tuple] = {}
        self._last_obs: Optional[float] = None
        self._report_cache: Optional[tuple] = None  # (t, result)
        # baseline center/scale per continuous feature, for exemplar
        # outlier scoring (lazily built on first traced observation)
        self._ref: Optional[Dict[int, tuple]] = None

    # ------------------------------------------------------------- feeding
    def _slot(self):
        """Current half-window slot (rotated under the caller's lock).
        Live sketches cap at `sml.obs.driftBaselineRows` retained values
        per stream, NOT the ingest-grade 262k exact cap: a busy endpoint
        must not accumulate hundreds of MB of monitoring state, and a
        compression triggered on the flush thread stays a few-ms sort
        instead of a 262k-value one."""
        from ..frame._chunks import DatasetSketch, FeatureSketch
        now = time.perf_counter()
        half = max(self._window_s / 2.0, 1e-3)
        if not self._slots or now - self._slots[-1][0] >= half:
            cap = max(GLOBAL_CONF.getInt("sml.obs.driftBaselineRows"),
                      1024)
            self._slots.append([
                now,
                DatasetSketch(self.baseline.features.n_features,
                              self.baseline.features.categorical,
                              exact_cap=cap),
                FeatureSketch(exact_cap=cap)])
            if len(self._slots) > 2:
                del self._slots[0]
        return self._slots[-1]

    def observe_block(self, X: np.ndarray,
                      preds: Optional[np.ndarray] = None,
                      traces: Optional[np.ndarray] = None) -> None:
        """Fold one scored block into the live window. `traces` is a
        per-row trace-id array (−1 = untraced) aligned with X's rows."""
        if not self._rec.enabled:
            return
        X = np.asarray(X)
        with self._lock:
            slot = self._slot()
            slot[1].update(X)
            if preds is not None:
                slot[2].update(np.asarray(preds, dtype=np.float64))
            if traces is not None:
                self._note_exemplars(X, traces)
            self._last_obs = time.perf_counter()

    def _note_exemplars(self, X: np.ndarray, traces: np.ndarray) -> None:
        """Per-feature worst-request tracking: the row most displaced
        from the baseline's [q10, q90] band, scored |x − median| /
        span, keeps its trace id (all-time, like METRICS exemplars)."""
        if self._ref is None:
            ref: Dict[int, tuple] = {}
            for f, sk in self.baseline.features.features.items():
                if sk.n_seen == 0:
                    continue
                q = np.asarray(sk.quantiles(
                    np.asarray([0.1, 0.5, 0.9], dtype=np.float64)),
                    dtype=np.float64)
                ref[f] = (float(q[1]),
                          max(float(q[2] - q[0]), 1e-9))
            self._ref = ref
        traces = np.asarray(traces)
        for f, (med, span) in self._ref.items():
            col = np.asarray(X[:, f], dtype=np.float64)
            score = np.abs(col - med) / span
            if score.size == 0 or not np.isfinite(score).any():
                continue  # an all-NaN column scores no exemplar
            i = int(np.nanargmax(score))
            if traces[i] >= 0:
                cur = self._worst.get(f)
                if cur is None or score[i] > cur[0]:
                    self._worst[f] = (float(score[i]), float(col[i]),
                                      int(traces[i]))

    def observe_sketch(self, chunk_sketch, index: int = 0) -> None:
        """Ingest-path feed: judge ONE chunk's sketch against the
        baseline (the per-chunk refit-trigger signal) and merge it into
        the live window."""
        if not self._rec.enabled:
            return
        base = self.baseline.features
        if (chunk_sketch.n_features != base.n_features
                or set(chunk_sketch.categorical) != set(base.categorical)):
            # a schema-mismatched stream cannot be judged against this
            # baseline — count it instead of crashing the data plane
            # (itself a loud drift signal)
            self._rec.counter("drift.schema_mismatch")
            return
        rows = int(getattr(chunk_sketch, "n_rows", 0))
        flagged, worst = self._judge_sketch(chunk_sketch, rows)
        with self._lock:
            slot = self._slot()
            slot[1].merge(chunk_sketch)
            entry = {"chunk": int(index), "rows": rows,
                     "flagged": flagged,
                     "max_severity": round(worst, 4)}
            self._chunks.append(entry)
            if len(self._chunks) > _MAX_CHUNKS:
                del self._chunks[0]
            self._chunks_seen += 1
            if flagged:
                self._chunks_flagged += 1
            self._last_obs = time.perf_counter()
        if flagged:
            self._rec.counter("drift.chunk_flagged")
            self._rec.emit("drift", "drift.chunk", args=entry)

    def _judge_sketch(self, live, rows: int) -> Tuple[List[str], float]:
        """(flagged feature names, max severity) of a live DatasetSketch
        against the baseline — the shared verdict of per-chunk judgment
        and report()."""
        flagged: List[str] = []
        worst = 0.0
        min_rows = GLOBAL_CONF.getInt("sml.obs.driftMinRows")
        if rows < min_rows:
            return flagged, worst
        for e in self._feature_rows(live, rows):
            worst = max(worst, e["severity"])
            if e["flagged"]:
                flagged.append(e["feature"])
        return flagged, worst

    # ------------------------------------------------------------ reporting
    def _floor_for(self, kind: str, f: int, base_sk, n: int):
        n_base = (base_sk.n_seen if kind == "cont"
                  else int(np.asarray(base_sk).sum()))
        key = (kind, f, _floor_bucket(_effective_n(n, n_base)))
        hit = self._floors.get(key)
        if hit is None:
            ne = key[2]
            hit = (continuous_floor(base_sk, ne, f) if kind == "cont"
                   else (categorical_floor(base_sk, ne, f),))
            self._floors[key] = hit
        return hit

    def _feature_rows(self, live, rows: int) -> List[dict]:
        """Per-feature distance/threshold/verdict rows for a live
        DatasetSketch (continuous + categorical + prediction handled by
        the caller)."""
        margin = float(GLOBAL_CONF.get("sml.obs.driftMargin"))
        base = self.baseline.features
        out: List[dict] = []
        for f in sorted(base.features):
            bsk = base.features[f]
            lsk = live.features.get(f)
            if bsk.n_seen == 0 or lsk is None or lsk.n_seen == 0:
                continue
            psi = psi_distance(bsk, lsk)
            shift = quantile_shift(bsk, lsk)
            fl_psi, fl_shift = self._floor_for("cont", f, bsk,
                                               lsk.n_seen)
            thr_psi, thr_shift = margin * fl_psi, margin * fl_shift
            severity = max(psi / thr_psi, shift / thr_shift)
            out.append({"feature": f"f{f}", "kind": "continuous",
                        "psi": round(psi, 5),
                        "quantile_shift": round(shift, 5),
                        "threshold_psi": round(thr_psi, 5),
                        "threshold_shift": round(thr_shift, 5),
                        "severity": round(severity, 3),
                        "flagged": bool(severity > 1.0)})
        for f in sorted(base.categorical):
            bc = base._cat_cnt[f]
            lc = live._cat_cnt.get(f)
            if lc is None or bc.sum() == 0 or lc.sum() == 0:
                continue
            psi = categorical_psi(bc, lc)
            (floor,) = self._floor_for("cat", f, bc, int(lc.sum()))
            thr = margin * floor
            severity = psi / thr
            out.append({"feature": f"f{f}", "kind": "categorical",
                        "psi": round(psi, 5),
                        "threshold_psi": round(thr, 5),
                        "severity": round(severity, 3),
                        "flagged": bool(severity > 1.0)})
        return out

    def _merged_window(self):
        from ..frame._chunks import DatasetSketch, FeatureSketch
        base = self.baseline.features
        live = DatasetSketch(base.n_features, base.categorical)
        pred = FeatureSketch()
        for _t, dsk, psk in self._slots:
            live.merge(dsk)
            pred.merge(psk)
        return live, pred

    def report(self) -> Dict[str, object]:
        """Live-vs-baseline drift for the current window: per-feature
        distances vs noise-aware thresholds, top drifting features with
        worst-request trace exemplars, prediction-distribution drift,
        and (ingest-fed monitors) the per-chunk verdicts. Lands
        `drift.*` gauges/events in the recorder when enabled.

        Judged reports are CACHED for `_REPORT_TTL_S`: the health
        surface is documented as safe to poll, so a 1 Hz probe must not
        pay the distance/floor math per poll (staleness is bounded at a
        few seconds of a multi-minute window)."""
        now = time.perf_counter()
        with self._lock:
            cached = self._report_cache
            if cached is not None and now - cached[0] < _REPORT_TTL_S:
                return cached[1]
            live, pred = self._merged_window()
            worst = dict(self._worst)
            chunks = list(self._chunks)
            chunks_seen = self._chunks_seen
            chunks_flagged = self._chunks_flagged
            last_obs = self._last_obs
        rows = live.n_rows
        min_rows = GLOBAL_CONF.getInt("sml.obs.driftMinRows")
        out: Dict[str, object] = {
            "monitor": self.name,
            "rows": rows,
            "baseline_rows": self.baseline.n_rows,
            "window_s": self._window_s,
            "ready": bool(rows >= min_rows),
        }
        if last_obs is not None:
            # staleness marker: how long since this monitor last saw
            # data (an idle ingest monitor's verdicts are historical)
            out["idle_s"] = round(now - last_obs, 1)
        if rows < min_rows:
            out["note"] = (f"{rows} live rows < sml.obs.driftMinRows="
                           f"{min_rows}; not judged")
            return out  # cheap path: never cached, fills as data lands
        feats = self._feature_rows(live, rows)
        for e in feats:
            f = int(e["feature"][1:])
            if f in worst:
                score, value, tid = worst[f]
                e["worst_value"] = value
                e["worst_score"] = round(score, 3)
                e["worst_trace"] = _context.hex_id(tid)
        feats.sort(key=lambda e: -e["severity"])
        flagged = [e["feature"] for e in feats if e["flagged"]]
        out["features"] = feats
        out["top"] = [e["feature"] for e in feats[:5]]
        out["flagged"] = flagged
        out["n_flagged"] = len(flagged)
        out["max_severity"] = feats[0]["severity"] if feats else 0.0
        margin = float(GLOBAL_CONF.get("sml.obs.driftMargin"))
        bpred = self.baseline.prediction
        if bpred is not None and pred.n_seen >= min_rows:
            psi = psi_distance(bpred, pred)
            shift = quantile_shift(bpred, pred)
            # the prediction stream's floor keys one slot past the last
            # feature (floor seeds must be non-negative and per-stream)
            fl_psi, fl_shift = self._floor_for(
                "cont", self.baseline.features.n_features, bpred,
                pred.n_seen)
            sev = max(psi / (margin * fl_psi),
                      shift / (margin * fl_shift))
            out["prediction"] = {
                "psi": round(psi, 5),
                "quantile_shift": round(shift, 5),
                "severity": round(sev, 3),
                "flagged": bool(sev > 1.0),
                "rows": pred.n_seen,
            }
            if sev > 1.0 and "prediction" not in flagged:
                flagged.append("prediction")
                out["flagged"] = flagged
                out["n_flagged"] = len(flagged)
            out["max_severity"] = max(out["max_severity"],
                                      out["prediction"]["severity"])
        if chunks:
            # `observed` is the ALL-TIME count (the retained per-chunk
            # list is bounded at _MAX_CHUNKS): flagged/observed stays a
            # coherent ratio over a long monitored ingest
            out["chunks"] = {
                "observed": chunks_seen,
                "flagged": chunks_flagged,
                "recent": chunks[-8:],
            }
        if self._rec.enabled:
            self._rec.gauge("drift.max_severity", float(out["max_severity"]))
            self._rec.gauge("drift.features_flagged", float(len(flagged)))
            self._rec.emit("drift", "drift.report", args={
                "monitor": self.name, "rows": rows,
                "flagged": list(flagged),
                "max_severity": out["max_severity"]})
        with self._lock:
            self._report_cache = (now, out)
        return out

    def reset(self) -> None:
        with self._lock:
            self._slots.clear()
            self._worst.clear()
            self._chunks.clear()
            self._chunks_seen = 0
            self._chunks_flagged = 0
            self._last_obs = None
            self._report_cache = None


def evaluate_block(baseline: DriftBaseline, X: np.ndarray,
                   preds: Optional[np.ndarray] = None,
                   name: str = "adhoc") -> Dict[str, object]:
    """One-shot drift verdict for a materialized block (the
    batch-validation shape): a throwaway monitor observes the block and
    reports. Requires the recorder enabled (observation is gated)."""
    mon = DriftMonitor(baseline, name=name)
    mon.observe_block(X, preds)
    return mon.report()


class _DriftRegistry:
    """Live monitors behind `engine_health()["drift"]`: serving
    endpoints and the chunked ingest register here; `report()` is the
    health surface's block (None when nothing is registered)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._monitors: Dict[str, DriftMonitor] = {}

    def register(self, name: str, monitor: DriftMonitor) -> None:
        with self._lock:
            self._monitors[name] = monitor

    def unregister(self, name: str,
                   expected: Optional[DriftMonitor] = None) -> None:
        """Remove `name` — but with `expected` given, only when the
        registered monitor IS that object: a closing endpoint must not
        tear down a same-named survivor's registration."""
        with self._lock:
            if expected is None or self._monitors.get(name) is expected:
                self._monitors.pop(name, None)

    def get(self, name: str) -> Optional[DriftMonitor]:
        with self._lock:
            return self._monitors.get(name)

    def report(self) -> Optional[Dict[str, object]]:
        with self._lock:
            monitors = dict(self._monitors)
        if not monitors:
            return None
        return {name: m.report() for name, m in sorted(monitors.items())}

    def reset(self) -> None:
        """Drop live windows/exemplars (monitors stay registered — they
        belong to live endpoints/ingests; `obs.reset()` semantics)."""
        with self._lock:
            monitors = list(self._monitors.values())
        for m in monitors:
            m.reset()


DRIFT = _DriftRegistry()


def drift_report(name: Optional[str] = None):
    """The health surface's drift block on demand: every registered
    monitor's verdict (None when nothing is registered), or one named
    monitor's (`"serve.<endpoint>/<stage>"` / `"ingest"`)."""
    if name is None:
        return DRIFT.report()
    mon = DRIFT.get(name)
    return None if mon is None else mon.report()
