"""The multi-replica serving fleet.

The port's copy of `sml_tpu/fleet`. One `ServingEndpoint` is one
replica: one micro-batcher, one warm scorer, one admission queue. The
fleet is a tier of them on the one card:

- `Replica` / `ReplicaPool` (`_replica`, `_pool`): N warm endpoints of
  one registered model and stage. Each replica owns a
  `dispatch.QueuePressure(parent=DEVICE_QUEUE)`, so the router sees its
  standing rows while the process-wide signal still aggregates; a
  replica's start rides prewarm's per-(manifest, card) guard (the first
  replays, the rest count `prewarm.replica_skip`); an evicted replica
  dumps a black-box bundle before its endpoint closes.
- `Router` (`_router`): the least-loaded replica a request, with
  priority admission (`sml.fleet.priorities`, lowest class shed first,
  the burn-rate halving and the burst-slope pre-tightening), the top
  class handed to the least-loaded replica's own ladder, and re-routing
  off a dead replica (never a hung future).
- `Autoscaler` (`_pool`): adds and retires warm replicas by occupancy
  and burn-rate bands, and backfills a pool under its floor.
- `ReplicaPool.promote` (`_rollout`): the staged rollout, a canary gate
  (`ct.CanaryGate`) a replica, with rollback and eviction;
  `ct.ContinuousTrainer(fleet=pool)` promotes its refits through it.

`fleet_report()` is `obs.engine_health()["fleet"]` (read lazily off
`sys.modules`: None until this package is imported and a pool exists).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..conf import _register

_register("sml.fleet.minReplicas", 1, int,
          "Fleet floor: the autoscaler never retires below this many "
          "replicas and backfills a pool that fell under it (a killed "
          "replica). Also ReplicaPool's default initial size")
_register("sml.fleet.maxReplicas", 4, int,
          "Fleet ceiling: the autoscaler never adds past this many "
          "replicas (each pins a warm scorer and a standing queue, and "
          "they share one card)")
_register("sml.fleet.scaleUpOccupancy", 0.75, float,
          "Autoscaler scale-up band: mean fleet queue occupancy (standing "
          "rows over the admission bound, averaged over the router's "
          "admissions since the last step) at or above which one warm "
          "replica is added; a burn rate above 1.0 scales up whatever "
          "the occupancy")
_register("sml.fleet.scaleDownOccupancy", 0.2, float,
          "Autoscaler scale-down band: at or below this mean occupancy "
          "(with the burn rate at most 1.0) the least-loaded replica "
          "retires gracefully (its queue drains; nothing sheds)")
_register("sml.fleet.priorities", "high,normal,low", str,
          "Priority classes of fleet admission, highest first. Class i "
          "of n admits onto a replica only while its standing rows stay "
          "under (n-i)/n of the queue bound, so the lowest class sheds "
          "first; the top class goes past every bound to the endpoint's "
          "own ladder (host fallback when sml.serve.hostFallback is on, "
          "else a serve.shed.overflow shed). A burn rate above 1.0 "
          "halves every non-top class's share")
_register("sml.fleet.burstSlopeWindowSec", 10.0, float,
          "Burst anticipation: the router fits a least-squares slope to "
          "the SLO burn-rate samples within this window")
_register("sml.fleet.burstSlopeHorizonSec", 0.0, float,
          "Burst anticipation horizon: when the burn level plus its "
          "slope this many seconds ahead crosses 1.0, the non-top "
          "classes tighten (fleet.burst_tighten) before the budget is "
          "spent. 0 disables the predictor")
_register("sml.fleet.burstSlopeTighten", 0.5, float,
          "The factor on every non-top class's admission share while the "
          "burn slope predicts a breach within "
          "sml.fleet.burstSlopeHorizonSec")
_register("sml.fleet.autoscalePollSec", 2.0, float,
          "Interval of Autoscaler.start()'s background band evaluation")

from ._pool import Autoscaler, ReplicaPool  # noqa: E402
from ._replica import Replica, ReplicaGone  # noqa: E402
from ._router import FleetFuture, Router, priority_classes  # noqa: E402

__all__ = ["Replica", "ReplicaGone", "ReplicaPool", "Autoscaler",
           "Router", "FleetFuture", "fleet_report", "priority_classes"]

# the live pools, for obs.engine_health()'s fleet block
_pools_lock = threading.Lock()
_POOLS: List["ReplicaPool"] = []


def _register_pool(pool: "ReplicaPool") -> None:
    with _pools_lock:
        if pool not in _POOLS:
            _POOLS.append(pool)


def _unregister_pool(pool: "ReplicaPool") -> None:
    with _pools_lock:
        if pool in _POOLS:
            _POOLS.remove(pool)


def fleet_report() -> Optional[Dict[str, object]]:
    """The fleet block of `obs.engine_health()`: every live pool's
    replica table beside the shed-by-class counters and the rollout
    state. None while no pool exists."""
    with _pools_lock:
        pools = list(_POOLS)
    if not pools:
        return None
    # the recorder's totals and the profiler's see the same increments
    # when both are on, so max() never double-counts
    from ..obs._recorder import RECORDER
    from ..utils.profiler import PROFILER
    counters = dict(PROFILER.counters())
    for k, v in RECORDER.counters().items():
        counters[k] = max(counters.get(k, 0.0), v)
    return {
        "pools": [p.report() for p in pools],
        "shed_by_class": {c: counters.get(f"fleet.shed.{c}", 0.0)
                          for c in priority_classes()},
        "requests": counters.get("fleet.requests", 0.0),
        "reroutes": counters.get("fleet.reroutes", 0.0),
        "scale_up": counters.get("fleet.scale_up", 0.0),
        "scale_down": counters.get("fleet.scale_down", 0.0),
        "rollout_promotions": counters.get("fleet.rollout_promotions",
                                           0.0),
        "rollout_rollbacks": counters.get("fleet.rollout_rollbacks", 0.0),
    }
