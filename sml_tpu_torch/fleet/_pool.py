"""ReplicaPool: N warm replicas; Autoscaler: occupancy and burn bands.

The port's copy of `sml_tpu/fleet/_pool.py`. A replica starts warm: its
`ServingEndpoint` starts the prewarm manifest's replay
(`parallel/prewarm.maybe_prewarm`, when `sml.prewarm.enabled` is set),
and the replay guard is keyed by (manifest, card), so the pool's first
replica pays the replay and replicas 2..N find the kernels loaded and
count `prewarm.replica_skip`.

An eviction for cause (a kill, a rollout's divergence) dumps a
black-box bundle (`obs.dump_blackbox`) before the endpoint closes, so
the bundle's ring still holds the replica's last batches and sheds. A
graceful scale-down drains without one.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..conf import GLOBAL_CONF
from ..obs._recorder import RECORDER as _OBS
from ..utils.profiler import PROFILER
from ._replica import Replica


class ReplicaPool:
    """N warm serving replicas of one registered model and stage alias.
    `endpoint_kwargs` (device, batcher knobs, canary_fraction, ...) go to
    every replica's `ServingEndpoint`."""

    def __init__(self, name: str, stage: str = "Production", *,
                 replicas: Optional[int] = None,
                 blackbox_dir: Optional[str] = None,
                 **endpoint_kwargs):
        self._name = name
        self._stage = stage
        self._endpoint_kwargs = dict(endpoint_kwargs)
        self._blackbox_dir = blackbox_dir
        self._lock = threading.Lock()
        self._replicas: Dict[int, Replica] = {}
        self._next_rid = 0
        self._closed = False
        # one staged rollout at a time; a second promote() waits here
        # (a promotion racing a rollout is caught by the per-stage alias
        # check in _rollout.py)
        self._rollout_lock = threading.Lock()
        self._last_rollout: Optional[dict] = None
        n = (int(replicas) if replicas is not None
             else GLOBAL_CONF.getInt("sml.fleet.minReplicas"))
        for _ in range(max(n, 1)):
            self.add_replica(reason="initial")
        from . import _register_pool
        _register_pool(self)

    @property
    def name(self) -> str:
        return self._name

    # ------------------------------------------------------------- topology
    def replicas(self) -> List[Replica]:
        """The current replicas in rid order (the router filters
        liveness itself)."""
        with self._lock:
            return [self._replicas[k] for k in sorted(self._replicas)]

    def size(self) -> int:
        """The live replica count."""
        return sum(1 for r in self.replicas() if r.alive)

    def occupancy(self) -> float:
        """Mean queue occupancy over the live replicas now (the
        autoscaler's signal when the router observed no traffic)."""
        live = [r for r in self.replicas() if r.alive]
        if not live:
            return 0.0
        return sum(r.pressure() for r in live) / \
            max(sum(r.queue_bound for r in live), 1)

    def get(self, rid: int) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(rid)

    # ------------------------------------------------------------ lifecycle
    def add_replica(self, reason: str = "manual") -> Replica:
        """Start one warm replica (the autoscaler's scale-up)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaPool is closed")
            rid = self._next_rid
            self._next_rid += 1
        replica = Replica(rid, self._name, self._stage,
                          **self._endpoint_kwargs)
        with self._lock:
            # a close() racing the construction above must not gain an
            # untracked live replica that nothing would ever close
            closed = self._closed
            if not closed:
                self._replicas[rid] = replica
                live = len(self._replicas)
        if closed:
            replica.retire()
            replica.close()
            raise RuntimeError("ReplicaPool is closed")
        PROFILER.count("fleet.replicas_started")
        if _OBS.enabled:
            _OBS.gauge("fleet.replicas", float(live))
            _OBS.emit("fleet", "fleet.replica_start", args={
                "rid": rid, "reason": reason,
                "version": replica.endpoint.current_version()})
        return replica

    def evict(self, rid: int, reason: str = "manual",
              blackbox: bool = True) -> Optional[str]:
        """Take one replica down: retire it (router traffic stops), dump
        its black-box bundle when `blackbox` (an eviction for cause),
        then close its endpoint (its queue drains; a poisoned replica's
        drain errors its futures, which the router re-routes). Returns
        the bundle's path, or None."""
        with self._lock:
            replica = self._replicas.pop(rid, None)
            live = len(self._replicas)
        if replica is None:
            return None
        replica.retire()
        bundle = None
        if blackbox:
            from ..obs import dump_blackbox
            bundle = dump_blackbox(f"fleet-evict:r{rid}:{reason}",
                                   directory=self._blackbox_dir)
        replica.close()
        PROFILER.count("fleet.replicas_evicted")
        if _OBS.enabled:
            _OBS.gauge("fleet.replicas", float(live))
            _OBS.emit("fleet", "fleet.replica_evict", args={
                "rid": rid, "reason": reason, "blackbox": bundle})
        return bundle

    def kill(self, rid: int) -> Optional[str]:
        """A simulated crash: poison the replica (every batch in flight
        fails fast, and the router re-routes it), then evict it with its
        bundle."""
        replica = self.get(rid)
        if replica is not None:
            replica.poison()
        return self.evict(rid, reason="killed", blackbox=True)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            replicas = list(self._replicas.values())
            self._replicas.clear()
        for r in replicas:
            r.retire()
            r.close()
        from . import _unregister_pool
        _unregister_pool(self)

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- rollout
    def promote(self, version: int, *, gate=None, X=None, y=None,
                candidate_spec=None, incumbent_spec=None) -> dict:
        """The staged rollout of registered `version` (holding Staging)
        across the pool (`_rollout.staged_rollout`); the verdict is kept
        for the health surface."""
        from ._rollout import staged_rollout
        verdict = staged_rollout(self, version, gate=gate, X=X, y=y,
                                 candidate_spec=candidate_spec,
                                 incumbent_spec=incumbent_spec)
        with self._lock:
            self._last_rollout = verdict
        return verdict

    # ---------------------------------------------------------------- state
    def report(self) -> Dict[str, object]:
        with self._lock:
            last = self._last_rollout
        rep = {
            "name": self._name,
            "stage": self._stage,
            "size": self.size(),
            "occupancy": round(self.occupancy(), 4),
            "replicas": [r.report() for r in self.replicas()],
        }
        if last is not None:
            rep["last_rollout"] = {
                "version": last.get("version"),
                "action": last.get("action"),
                "passed": last.get("passed"),
                "evicted": last.get("evicted"),
            }
        return rep


class Autoscaler:
    """Replica count control by occupancy and burn-rate bands.

    `step()` evaluates the bands once; `start()` runs it on an interval
    (`sml.fleet.autoscalePollSec`). Signals: the router's mean occupancy
    observed at admissions since the last step (else the pool's
    occupancy now) and the SLO burn rate over the metrics window. A pool
    below `minReplicas` (a killed replica) backfills whatever the bands
    say. The background loop counts a step that raised
    (`fleet.autoscale_error`) and keeps it as `last_error`."""

    def __init__(self, pool: ReplicaPool, router=None, *,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 scale_up_occupancy: Optional[float] = None,
                 scale_down_occupancy: Optional[float] = None):
        self._pool = pool
        self._router = router
        conf = GLOBAL_CONF
        self._min = (int(min_replicas) if min_replicas is not None
                     else conf.getInt("sml.fleet.minReplicas"))
        self._max = (int(max_replicas) if max_replicas is not None
                     else conf.getInt("sml.fleet.maxReplicas"))
        self._up = (float(scale_up_occupancy)
                    if scale_up_occupancy is not None
                    else float(conf.get("sml.fleet.scaleUpOccupancy")))
        self._down = (float(scale_down_occupancy)
                      if scale_down_occupancy is not None
                      else float(conf.get("sml.fleet.scaleDownOccupancy")))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll_s = float(conf.get("sml.fleet.autoscalePollSec"))
        self.last_error: Optional[BaseException] = None

    def _burn_rate(self) -> float:
        if self._router is not None:
            return self._router.burn_rate()
        from .. import obs
        window = float(GLOBAL_CONF.getInt("sml.obs.metricsWindowSec"))
        return float(obs.slo_report(window).get("burn_rate", 0.0))

    def step(self) -> Dict[str, object]:
        """Evaluate the bands once; returns the action's receipt."""
        occ = self._router.take_occupancy() \
            if self._router is not None else None
        if occ is None:
            occ = self._pool.occupancy()
        burn = self._burn_rate()
        size = self._pool.size()
        action = "hold"
        if size < self._min:
            self._pool.add_replica(reason="backfill")
            action = "backfill"
            PROFILER.count("fleet.scale_up")
        elif (occ >= self._up or burn > 1.0) and size < self._max:
            self._pool.add_replica(
                reason="occupancy" if occ >= self._up else "burn-rate")
            action = "up"
            PROFILER.count("fleet.scale_up")
        elif occ <= self._down and burn <= 1.0 and size > self._min:
            live = [r for r in self._pool.replicas() if r.alive]
            target = min(live, key=lambda r: (r.pressure(), -r.rid))
            self._pool.evict(target.rid, reason="scale-down",
                             blackbox=False)
            action = "down"
            PROFILER.count("fleet.scale_down")
        if _OBS.enabled:
            _OBS.gauge("fleet.occupancy", float(occ))
            _OBS.emit("fleet", "fleet.scale", args={
                "action": action, "occupancy": round(float(occ), 4),
                "burn_rate": round(float(burn), 4),
                "replicas": self._pool.size()})
        return {"action": action, "occupancy": float(occ),
                "burn_rate": float(burn), "replicas": self._pool.size()}

    # ------------------------------------------------------ background loop
    def start(self, poll_s: Optional[float] = None) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        if poll_s is not None:
            self._poll_s = float(poll_s)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"sml-fleet-autoscale-{self._pool.name}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — counted and kept; the
                PROFILER.count("fleet.autoscale_error")  # loop goes on
                self.last_error = e

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
