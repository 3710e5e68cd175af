"""ContinuousTrainer: the controller that closes the loop.

The port's copy of `sml_tpu/ct/_trainer.py`. One cycle (`step()`, also
run on an interval by `start()`):

1. **Snapshot** the live source's fresh window (rows committed since the
   watermark). Under `sml.ct.minRefitRows` the window keeps
   accumulating and nothing advances.
2. **Judge** the window against the Production model's training
   baseline: a `DriftMonitor(name="ingest")` registered in `obs.DRIFT`
   observes every chunk's sketch, so the verdict is the
   `engine_health()["drift"]["ingest"]` block.
3. **Schedule**: a clean window advances the watermark and ends the
   cycle; severity at or above `sml.ct.warmSeverity` runs a WARM refit
   (`sml.ct.warmRounds` rounds appended under the saved bin edges:
   `hist_accumulate` and `split_scan` a level, and one `forest_traverse`
   launch for the saved rounds' margin); at or above
   `sml.ct.fullSeverity`, or on a window of another width, a FULL refit
   (re-sketch, re-bin). With a `checkpoint_dir` a refit checkpoints at
   its segment boundaries.
4. **Track**: every refit is a tracking run (params: mode, trigger
   severity, rows; metrics: the gate's RMSEs) and a new registered
   version.
5. **Promote through the canary gate**: the candidate moves to Staging,
   the gate replays the window through the endpoint and judges
   (`_gate.CanaryGate`); a pass moves it to Production (the registry's
   listeners hot-swap every bound endpoint), a failure archives it and
   dumps a black-box bundle. With `fleet=` (a `fleet.ReplicaPool`) the
   promotion is the pool's staged rollout instead (`fleet/_rollout.py`).

Every fit and score runs on the trainer's `device` (the session's,
`sml.device`, by default: the card). Cycles serialize on `_cycle_lock`;
`stats()` and `last_report` snapshot under `_lock`. The background loop
counts a cycle that raised (`ct.cycle_error`, `stats()["errors"]`) and
keeps the exception as `last_error`.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

from ..conf import GLOBAL_CONF
from ..obs import drift as _drift
from ..obs._recorder import RECORDER as _OBS
from ..tracking import _store
from ..utils.profiler import PROFILER
from ._gate import CanaryGate


def _load_production(name: str):
    """(model, spec, version) of the registered version holding
    Production: the trainer's incumbent."""
    from ..ml.base import load
    meta = _store.resolve_stage(name, "Production")
    if meta is None:
        raise ValueError(
            f"no READY version of {name!r} holds Production — register "
            f"and promote a seed model before starting the trainer")
    native = os.path.join(_store.model_dir(name), "versions",
                          str(meta["version"]), "model", "native")
    model = load(native)
    spec = getattr(model, "_spec", None)
    if spec is None or getattr(spec, "trees", None) is None:
        raise ValueError(
            f"{name!r} v{meta['version']} is not a tree-ensemble model; "
            f"the continuous trainer refits boosted tree specs")
    return model, spec, int(meta["version"])


class ContinuousTrainer:
    """Drift-triggered continuous training of one registered model over
    one live chunk source (`StreamChunkSource`, `DeltaChunkSource`, or
    any source with snapshot() and advance())."""

    def __init__(self, name: str, source, *,
                 endpoint=None, gate: Optional[CanaryGate] = None,
                 fleet=None,
                 fit_params: Optional[Dict] = None,
                 checkpoint_dir: Optional[str] = None,
                 warm_severity: Optional[float] = None,
                 full_severity: Optional[float] = None,
                 min_rows: Optional[int] = None,
                 warm_rounds: Optional[int] = None,
                 device=None):
        from ..device import resolve_device, session_device
        self._name = name
        self._source = source
        self._endpoint = endpoint
        #: a fleet.ReplicaPool (anything with promote(version, gate=, X=,
        #: y=, candidate_spec=, incumbent_spec=)): promotions run its
        #: staged rollout instead of the single-endpoint gate
        self._fleet = fleet
        self._gate = gate or CanaryGate()
        self._fit_params = dict(fit_params or {})
        self._checkpoint_dir = checkpoint_dir
        self.device = session_device() if device is None \
            else resolve_device(device)
        self._warm_severity = (
            float(warm_severity) if warm_severity is not None
            else float(GLOBAL_CONF.get("sml.ct.warmSeverity")))
        self._full_severity = (
            float(full_severity) if full_severity is not None
            else float(GLOBAL_CONF.get("sml.ct.fullSeverity")))
        self._min_rows = (
            int(min_rows) if min_rows is not None
            else GLOBAL_CONF.getInt("sml.ct.minRefitRows"))
        self._warm_rounds = (
            int(warm_rounds) if warm_rounds is not None
            else GLOBAL_CONF.getInt("sml.ct.warmRounds"))
        self._lock = threading.Lock()
        self._cycle_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll_s = float(GLOBAL_CONF.get("sml.ct.pollSec"))
        self._stats = {"cycles": 0, "clean": 0, "accumulating": 0,
                       "refits": 0, "warm_refits": 0, "full_refits": 0,
                       "promotions": 0, "rollbacks": 0, "errors": 0}
        self._last_report: Optional[Dict] = None
        self.last_error: Optional[BaseException] = None

    # ------------------------------------------------------------ one cycle
    def step(self) -> Dict[str, object]:
        """Run one cycle synchronously; returns its report (also kept as
        `last_report`)."""
        with self._cycle_lock:
            report = self._cycle()
        with self._lock:
            self._stats["cycles"] += 1
            key = {"accumulate": "accumulating", "clean": "clean",
                   "promoted": "promotions",
                   "rolled_back": "rollbacks"}.get(report["action"])
            if key:
                self._stats[key] += 1
            if report.get("refit"):
                self._stats["refits"] += 1
                self._stats["warm_refits" if report["refit"] == "warm"
                            else "full_refits"] += 1
            self._last_report = report
        if _OBS.enabled:
            _OBS.emit("ct", "ct.cycle", args={
                "name": self._name, "action": report["action"],
                "rows": report.get("rows", 0),
                "severity": report.get("severity", 0.0)})
        return report

    def _cycle(self) -> Dict[str, object]:
        PROFILER.count("ct.cycles")
        rows = int(self._source.snapshot())
        if rows < self._min_rows:
            return {"action": "accumulate", "rows": rows,
                    "need_rows": self._min_rows}
        model, spec, inc_version = _load_production(self._name)
        baseline = getattr(spec, "baseline", None)
        if baseline is None:
            return {"action": "unmonitorable", "rows": rows,
                    "note": "Production model carries no drift baseline "
                            "(train with sml.obs.enabled=true)"}
        schema_ok = (self._source.n_features
                     == baseline.features.n_features)
        severity, drift_report, sketch = 0.0, None, None
        if schema_ok:
            severity, drift_report, sketch = self._judge(baseline, spec)
        if schema_ok and severity < self._warm_severity:
            self._source.advance()
            return {"action": "clean", "rows": rows,
                    "severity": severity, "version": inc_version,
                    "drift": drift_report}
        mode = "full" if (not schema_ok
                          or severity >= self._full_severity) else "warm"
        if mode == "warm" and spec.tree_weights is None:
            mode = "full"  # a forest or a tree has no rounds to append
        return self._refit_and_promote(model, spec, inc_version, mode,
                                       rows, severity, drift_report,
                                       sketch)

    def _judge(self, baseline, spec):
        """The ingest drift pass over the frozen window: one DriftMonitor
        observes every chunk's sketch and lands in `obs.DRIFT` as
        "ingest". The merged sketch is returned and reused as the refit
        ingest's pass 1 (the same window), so a refit cycle streams the
        window twice, not three times."""
        from ..ml._chunked import sketch_source
        max_bins = spec.binning.edges.shape[1] + 1
        categorical = {f: len(r)
                       for f, r in spec.binning.cat_remap.items()}
        mon = _drift.DriftMonitor(baseline, name="ingest")
        _drift.DRIFT.register("ingest", mon)
        sketch = sketch_source(self._source, max_bins, categorical,
                               monitor=mon)
        rep = mon.report()
        return float(rep.get("max_severity", 0.0)), rep, sketch

    # ------------------------------------------------- refit and promotion
    def _refit_and_promote(self, model, spec, inc_version, mode, rows,
                           severity, drift_report, sketch=None):
        from .. import tracking as _tracking
        if mode == "warm":
            PROFILER.count("ct.refit_warm")
        else:
            PROFILER.count("ct.refit_full")
        if _OBS.enabled:
            _OBS.emit("ct", "ct.refit", args={
                "name": self._name, "mode": mode, "rows": rows,
                "severity": severity})
        Xg, yg = self._gate_window()
        new_spec = self._fit(spec, mode, sketch)
        with _tracking.start_run(run_name=f"ct-{mode}-v{inc_version}"):
            _tracking.log_params({
                "ct.mode": mode, "ct.trigger_severity": severity,
                "ct.window_rows": rows,
                "ct.incumbent_version": inc_version,
                "ct.n_trees": len(new_spec.trees)})
            _tracking.set_tags({"ct.trainer": self._name})
            _tracking.spark.log_model(type(model)(new_spec), "model",
                                      registered_model_name=self._name)
            version = int(_store.get_registered_model(
                self._name)["latest_version"])
            _store.set_version_stage(self._name, version, "Staging")
            if self._fleet is not None:
                # the staged rollout judges replica by replica and
                # commits its outcome (Production on a pass; rollback,
                # Archived and the diverging replica's eviction with its
                # bundle on a failure)
                verdict = self._fleet.promote(
                    version, gate=self._gate, X=Xg, y=yg,
                    candidate_spec=new_spec, incumbent_spec=spec)
            else:
                verdict = self._gate.run(self._endpoint, Xg, yg,
                                         new_spec, spec)
            for k in ("rmse_candidate", "rmse_incumbent"):
                if k in verdict:
                    _tracking.log_metric(f"ct.{k}", verdict[k])
            _tracking.log_metric("ct.gate_passed",
                                 1.0 if verdict["passed"] else 0.0)
        self._source.advance()
        if verdict["passed"]:
            if self._fleet is None:
                _store.set_version_stage(self._name, version,
                                         "Production",
                                         archive_existing_versions=True)
            PROFILER.count("ct.promotions")
            if _OBS.enabled:
                _OBS.emit("ct", "ct.promote", args={
                    "name": self._name, "version": version,
                    "from": inc_version,
                    "fleet": self._fleet is not None})
            action = "promoted"
        else:
            if self._fleet is None:
                _store.set_version_stage(self._name, version, "Archived")
                from ..obs import dump_blackbox
                bundle = dump_blackbox("ct-gate-failure")
            else:
                # the rollout archived the candidate and dumped the
                # evicted replica's bundle
                bundle = verdict.get("blackbox")
            PROFILER.count("ct.rollbacks")
            if _OBS.enabled:
                _OBS.emit("ct", "ct.rollback", args={
                    "name": self._name, "version": version,
                    "checks": dict(verdict.get("checks") or {}),
                    "blackbox": bundle,
                    "fleet": self._fleet is not None})
            action = "rolled_back"
        return {"action": action, "refit": mode, "rows": rows,
                "severity": severity, "version": version,
                "incumbent": inc_version, "gate": verdict,
                "drift": drift_report}

    def _fit(self, spec, mode, sketch=None):
        from ..ml._chunked import (fit_ensemble_chunked,
                                   warm_start_ensemble_chunked)
        p = self._fit_params
        seed = int(p.get("seed", 17))
        rpd = p.get("rounds_per_dispatch")
        if mode == "warm":
            kwargs = dict(n_new_trees=self._warm_rounds, seed=seed,
                          sketch=sketch,
                          subsample=float(p.get("subsample", 1.0)),
                          rounds_per_dispatch=rpd, device=self.device)
            if self._checkpoint_dir:
                from ._checkpoint import checkpointed_warm_start
                return checkpointed_warm_start(
                    spec, self._source, self._checkpoint_dir, **kwargs)
            return warm_start_ensemble_chunked(spec, self._source,
                                               **kwargs)
        kwargs = dict(
            n_trees=int(p.get("n_trees", len(spec.trees))),
            max_depth=int(p.get("max_depth", spec.depth)),
            max_bins=int(p.get("max_bins",
                               spec.binning.edges.shape[1] + 1)),
            seed=seed,
            categorical={f: len(r)
                         for f, r in spec.binning.cat_remap.items()},
            loss=p.get("loss", "logistic" if spec.mode == "binary"
                       else "squared"),
            step_size=float(p.get("step_size",
                                  float(spec.tree_weights[0])
                                  if spec.tree_weights is not None
                                  else 0.1)),
            subsample=float(p.get("subsample", 1.0)),
            rounds_per_dispatch=rpd, sketch=sketch, device=self.device)
        if self._checkpoint_dir:
            from ._checkpoint import checkpointed_fit
            return checkpointed_fit(self._source, self._checkpoint_dir,
                                    **kwargs)
        return fit_ensemble_chunked(self._source, boosting=True, **kwargs)

    def _gate_window(self):
        """Up to sml.ct.gateRows rows of the frozen window, for the gate's
        traffic and quality check (the window is re-iterable: this
        consumes nothing)."""
        cap = GLOBAL_CONF.getInt("sml.ct.gateRows")
        xs, ys, n = [], [], 0
        for X, y in self._source.chunks():
            take = min(cap - n, np.shape(X)[0])
            if take <= 0:
                break
            xs.append(np.asarray(X)[:take])
            if y is not None:
                ys.append(np.asarray(y)[:take])
            n += take
        Xg = np.concatenate(xs) if xs else np.zeros((0, 0))
        yg = np.concatenate(ys) if ys else None
        return Xg, yg

    # ------------------------------------------------------ background loop
    def start(self, poll_s: Optional[float] = None) -> None:
        """Run cycles every `poll_s` seconds (`sml.ct.pollSec`) on a
        daemon thread until stop()."""
        if self._thread is not None and self._thread.is_alive():
            return
        if poll_s is not None:
            self._poll_s = float(poll_s)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sml-ct-{self._name}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — counted and kept; the
                PROFILER.count("ct.cycle_error")  # loop outlives a cycle
                with self._lock:
                    self._stats["errors"] += 1
                    self.last_error = e

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()

    def close(self) -> None:
        self.stop()

    def __enter__(self) -> "ContinuousTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------------- state
    def stats(self) -> Dict[str, object]:
        with self._lock:
            out = dict(self._stats)
            out["last_report"] = self._last_report
        return out

    @property
    def last_report(self) -> Optional[Dict]:
        with self._lock:
            return self._last_report
