"""Registry-backed serving endpoint: stage aliases, hot-swap, canary.

Counterpart of `sml_tpu/serving/_endpoint.py`. `ServingEndpoint("model",
"Production")` binds a NAME and a STAGE ALIAS, not a version. Resolution
goes through `tracking._store.resolve_stage`; the store's
`on_stage_transition` hook fires on every `transition_model_version_stage`
commit, so a promotion hot-swaps the serving scorer in-process: batches
in flight finish on the old version, the next batch scores on the new
one, and nothing polls.

Warm scorers come from the multi-model `ModelCache`; requests ride the
`MicroBatcher` (coalescing, admission control, and the host route
`_score_host` for the queue's overflow when `sml.serve.hostFallback` is
on). Canary mode
(`sml.serve.canaryFraction` > 0) mirrors a paced fraction of traffic to
the Staging version off the request path, on one shadow worker, on the
Staging scorer's HOST route (`score_block_host`: the shadow must not
contend for the card's queue), and keeps prediction-divergence stats:
running sums, and the `serve.canary_abs_diff` histogram with each
request's trace id as its exemplar (filled with the recorder on).

With the recorder on, a hot swap or a pin lands a `serve.swap` event.
At construction the endpoint starts the opt-in prewarm replay
(`parallel.prewarm.maybe_prewarm`, `sml.prewarm.enabled`);
`health_report()["prewarm"]` says how it went (a background replay that
failed keeps its error there).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from ..conf import GLOBAL_CONF
from ..device import resolve_device, session_device
from ..obs import _context as _trace
from ..obs._metrics import METRICS as _METRICS
from ..obs._recorder import RECORDER as _OBS
from ..tracking import _store
from ..utils.profiler import PROFILER
from ._batcher import MicroBatcher, ScoreFuture
from ._cache import MODEL_CACHE, ModelCache


def _load_scorer(name: str, version, device):
    """DeviceScorer on `device` over a registry version's native
    (spark-flavor) model payload: the load the cache amortizes."""
    from ..ml.base import load
    from ..ml.inference import DeviceScorer
    native = os.path.join(_store.model_dir(name), "versions", str(version),
                          "model", "native")
    if not os.path.isdir(native):
        raise ValueError(
            f"registered model {name!r} version {version} has no native "
            f"model payload (log it with tracking.spark.log_model)")
    return DeviceScorer(load(native), device=device)


def _fresh_canary() -> Dict[str, float]:
    return {"mirrored": 0, "rows": 0, "sum_abs_diff": 0.0,
            "max_abs_diff": 0.0, "errors": 0}


class ServingEndpoint:
    """Online scorer for `models:/<name>/<stage>`.

    `score(X)` blocks for the prediction; `submit(X)` returns a
    `ScoreFuture`. Batcher knobs (`max_batch_rows`, `flush_micros`,
    `queue_rows`, `timeout_millis`, `host_fallback`, `flush_auto`,
    `queue`, `start`) pass through to `MicroBatcher`; defaults come from
    the `sml.serve.*` conf keys.
    `device` defaults to the session's `sml.device` (the card; without
    one the endpoint raises): pass device="cpu" to serve with the plain
    PyTorch versions."""

    def __init__(self, name: str, stage: str = "Production", *,
                 model_cache: Optional[ModelCache] = None,
                 auto_update: bool = True,
                 canary_fraction: Optional[float] = None,
                 device=None, **batcher_kwargs):
        self._name = name
        self._stage = stage
        self.device = session_device() if device is None \
            else resolve_device(device)
        self._cache = model_cache or MODEL_CACHE
        self._swap_lock = threading.RLock()
        self._scorer = None
        self._version: Optional[int] = None
        self._pinned: Optional[int] = None
        self._staging_scorer = None
        self._staging_version: Optional[int] = None
        self._canary_fraction = canary_fraction
        self._canary_lock = threading.Lock()
        self._canary_acc = 0.0
        self._shadow_inflight = 0
        self._canary = _fresh_canary()
        self._shadow_pool: Optional[ThreadPoolExecutor] = None
        self._closed = False
        # opt-in manifest replay (sml.prewarm.enabled), once per process
        # and card, in the background: the first requests find the
        # kernels loaded and their first launches made
        from ..parallel import prewarm as _prewarm
        self.prewarm_thread = _prewarm.maybe_prewarm(device=self.device)
        self._refresh(initial=True)
        self._listener = self._on_transition if auto_update else None
        if self._listener is not None:
            _store.on_stage_transition(self._listener)
        self._batcher = MicroBatcher(self._score_device,
                                     host_score=self._score_host,
                                     **batcher_kwargs)

    # ----------------------------------------------------------- resolution
    def _cache_key(self, version) -> str:
        # a scorer lives on one device: endpoints on other devices sharing
        # a cache must not be handed it
        return f"{version}@{self.device}"

    def _warm(self, version):
        return self._cache.get(
            self._name, self._cache_key(version),
            lambda: _load_scorer(self._name, version, self.device))

    def _refresh(self, initial: bool = False) -> None:
        """Re-resolve the stage alias (and the Staging canary target) and
        swap the warm scorer if the resolved version changed."""
        meta = _store.resolve_stage(self._name, self._stage)
        if meta is None:
            if initial:
                raise ValueError(
                    f"no READY version of {self._name!r} holds stage "
                    f"{self._stage!r} — promote one with "
                    f"transition_model_version_stage first")
            return  # keep serving the last good version (alias emptied)
        version = meta["version"]
        with self._swap_lock:
            if self._pinned is None and version != self._version:
                self._scorer = self._warm(version)
                old, self._version = self._version, version
                if not initial:
                    PROFILER.count("serve.hot_swap")
                    if _OBS.enabled:
                        _OBS.emit("serve", "serve.swap", args={
                            "name": self._name, "stage": self._stage,
                            "from": old, "to": version})
        if self._stage != "Staging":
            smeta = _store.resolve_stage(self._name, "Staging")
            with self._swap_lock:
                changed = False
                if smeta is None:
                    changed = self._staging_version is not None
                    self._staging_scorer = self._staging_version = None
                elif smeta["version"] != self._staging_version:
                    self._staging_scorer = self._warm(smeta["version"])
                    self._staging_version = smeta["version"]
                    changed = True
            if changed:
                # the divergence stats describe the CURRENT canary target:
                # a new candidate starts from zero (the running max only
                # grows, so a past candidate's would poison later gates)
                with self._canary_lock:
                    self._canary = _fresh_canary()

    def _on_transition(self, name, version, stage, archived) -> None:
        if name != self._name or self._closed:
            return
        self._refresh()
        # an archived version holds no stage: no endpoint resolves to it,
        # so its warm scorer must not wait in the cache for LRU pressure
        for v in archived:
            self._cache.invalidate(self._name, self._cache_key(v))

    def current_version(self) -> Optional[int]:
        return self._version

    # ----------------------------------------------------------- pinning
    def pin_version(self, version: int) -> None:
        """Pin the PRIMARY scorer to an explicit registry version. Stage
        transitions keep firing (the Staging canary target still
        tracks), but the primary no longer follows the alias until
        `unpin()`."""
        version = int(version)
        with self._swap_lock:
            self._pinned = version
            if version != self._version:
                self._scorer = self._warm(version)
                old, self._version = self._version, version
                PROFILER.count("serve.hot_swap")
                if _OBS.enabled:
                    _OBS.emit("serve", "serve.swap", args={
                        "name": self._name, "stage": self._stage,
                        "from": old, "to": version, "pinned": True})

    def unpin(self) -> None:
        """Drop the pin and resolve the stage alias again."""
        with self._swap_lock:
            if self._pinned is None:
                return
            self._pinned = None
        self._refresh()

    def pinned_version(self) -> Optional[int]:
        with self._swap_lock:
            return self._pinned

    # -------------------------------------------------------------- scoring
    def _score_device(self, X: np.ndarray) -> np.ndarray:
        return self._scorer.score_block(X)

    def _score_host(self, X: np.ndarray) -> np.ndarray:
        return self._scorer.score_block_host(X)

    def submit(self, X: np.ndarray) -> ScoreFuture:
        fut = self._batcher.submit(X)
        f = self._canary_fraction
        if f is None:
            f = float(GLOBAL_CONF.get("sml.serve.canaryFraction"))
        if f > 0.0 and self._staging_scorer is not None:
            with self._canary_lock:
                self._canary_acc += min(f, 1.0)
                mirror = self._canary_acc >= 1.0
                if mirror:
                    self._canary_acc -= 1.0
            if mirror:
                self._shadow(np.asarray(X), fut)
        return fut

    def score(self, X: np.ndarray,
              timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(X).result(timeout)

    # --------------------------------------------------------------- canary
    _SHADOW_MAX_INFLIGHT = 8  # beyond this the shadow sheds, never queues

    def _shadow(self, X: np.ndarray, fut: ScoreFuture) -> None:
        with self._canary_lock:
            # a bounded mirror backlog: each queued entry pins a copy of X
            # until scored, so when the one worker falls behind, the
            # mirror drops
            if self._shadow_inflight >= self._SHADOW_MAX_INFLIGHT:
                return
            self._shadow_inflight += 1
            if self._shadow_pool is None:
                self._shadow_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="sml-serve-shadow")
            pool = self._shadow_pool
        pool.submit(self._mirror, X, fut)

    def _mirror(self, X: np.ndarray, fut: ScoreFuture) -> None:
        """Score the mirrored request on the Staging version's HOST route
        and fold the divergence into the canary stats: the running sums,
        and the `serve.canary_abs_diff` histogram with the request's
        trace id as the exemplar, so `canary_stats()` can name the
        literal worst-diverging request. It never touches the primary's
        result and never raises into the serving path, but a failed
        mirror COUNTS (`serve.canary_error` and the stats' `errors`): a
        dead canary reporting zero divergence is the silent failure this
        layer exists to name."""
        try:
            primary = np.asarray(fut.result(timeout=60.0), dtype=np.float64)
            scorer = self._staging_scorer
            if scorer is None:
                return
            shadow = np.asarray(scorer.score_block_host(X),
                                dtype=np.float64)
            diff = np.abs(shadow - primary)
            # an empty request mirrors with nothing to differ
            worst = float(diff.max()) if diff.size else 0.0
            PROFILER.count("serve.canary_mirrored")
            if diff.size:
                _METRICS.observe("serve.canary_abs_diff", worst,
                                 exemplar=fut.trace_id)
            with self._canary_lock:
                self._canary["mirrored"] += 1
                self._canary["rows"] += int(diff.size)
                self._canary["sum_abs_diff"] += float(diff.sum())
                self._canary["max_abs_diff"] = max(
                    self._canary["max_abs_diff"], worst)
        except Exception:  # noqa: BLE001 — counted: the shadow's boundary
            PROFILER.count("serve.canary_error")
            with self._canary_lock:
                self._canary["errors"] += 1
        finally:
            with self._canary_lock:
                self._shadow_inflight -= 1

    def canary_stats(self) -> Dict[str, float]:
        """The running divergence of the mirrored requests: mirrored,
        rows, sum / max / mean of |staging - primary|, errors, and the
        Staging version; with the `serve.canary_abs_diff` histogram
        (filled while the recorder is on) also its windowed p50 and p99
        of each request's largest |diff|, and the worst one with its
        request's trace id."""
        with self._canary_lock:
            out = dict(self._canary)
        out["staging_version"] = self._staging_version
        out["mean_abs_diff"] = (out["sum_abs_diff"] / out["rows"]
                                if out["rows"] else 0.0)
        hist = _METRICS.histogram("serve.canary_abs_diff")
        if hist is not None:
            window = float(GLOBAL_CONF.getInt("sml.obs.metricsWindowSec"))
            out["abs_diff_p50"] = hist.quantile(0.50, window)
            out["abs_diff_p99"] = hist.quantile(0.99, window)
            worst, tid = hist.worst()
            out["worst_abs_diff"] = float(worst)
            out["worst_trace"] = _trace.hex_id(tid)
        return out

    # ---------------------------------------------------------------- health
    def health_report(self) -> Dict[str, object]:
        """The endpoint's own live state: resolved version, pin, queue
        depth (`queued_rows`: rows queued, not yet flushed), canary
        divergence, and the traversal plan of this replica's last launch
        on the card; once a prewarm replay has started in the process,
        its state, stats and error (`prewarm.status()`) under
        "prewarm"."""
        scorer = self._scorer
        report = {"endpoint": {
            "name": self._name,
            "stage": self._stage,
            "version": self._version,
            "pinned": self._pinned,
            "staging_version": self._staging_version,
            "queued_rows": self._batcher.queued_rows(),
            "max_batch_rows": self._batcher.max_batch_rows,
            "closed": self._closed,
            "canary": self.canary_stats(),
            "kernel": scorer.kernel_spec(),
        }}
        from ..parallel import prewarm as _prewarm
        replay = _prewarm.status()
        if replay["state"] != "idle":
            report["prewarm"] = replay
        return report

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._closed = True
        if self._listener is not None:
            _store.remove_stage_listener(self._listener)
            self._listener = None
        self._batcher.close()
        with self._canary_lock:
            pool, self._shadow_pool = self._shadow_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self) -> "ServingEndpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
