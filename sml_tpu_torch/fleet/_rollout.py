"""Staged fleet rollout: a candidate earns every replica, one at a time.

The port's copy of `sml_tpu/fleet/_rollout.py`. A single-endpoint
promotion judges a Staging candidate once and flips the alias; at fleet
scale a bad flip takes every replica down at once. The staged rollout
bounds the blast radius to one replica a stage:

1. the candidate must hold Staging (every replica's canary mirror
   already shadows it);
2. each stage runs the gate (`ct/_gate.py`) on the next unpinned
   replica, still serving the incumbent, so its mirror measures the
   candidate against the incumbent on the gate's traffic;
3. a passing stage PINS that replica to the candidate
   (`ServingEndpoint.pin_version`), so a rollback is `unpin()`, not a
   registry transition;
4. after every replica passed, the alias commits (Production, the
   incumbent archived) and the pins drop: the alias now names what every
   replica serves;
5. a failed stage rolls back: every pinned replica unpins, the candidate
   is archived, and the replica whose gate failed is EVICTED with its
   black-box bundle.

Every stage re-resolves the Production alias; if another promotion moved
it during the stage, the rollout aborts down the same edge but evicts
nothing (nothing diverged), and archives the candidate only if it still
holds Staging.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..obs._recorder import RECORDER as _OBS
from ..tracking import _store
from ..utils.profiler import PROFILER
from ._replica import Replica

#: the gate's verdict fields copied onto the rollout's verdict, so that
#: a caller (the ContinuousTrainer) reads one shape either way
_VERDICT_KEYS = ("rows", "mirrored", "canary_errors", "request_errors",
                 "mean_abs_diff", "max_abs_diff", "rmse_candidate",
                 "rmse_incumbent", "quality_tol", "checks")


def _production_version(name: str) -> Optional[int]:
    meta = _store.resolve_stage(name, "Production")
    return None if meta is None else int(meta["version"])


def _archive_if_staging(name: str, version: int) -> None:
    """Archive the candidate only while it still holds Staging: a racing
    promotion may have moved it."""
    meta = _store.get_model_version(name, version)
    if meta is not None and meta.get("current_stage") == "Staging":
        _store.set_version_stage(name, version, "Archived")


def staged_rollout(pool, version: int, *, gate=None,
                   X: Optional[np.ndarray] = None,
                   y: Optional[np.ndarray] = None,
                   candidate_spec=None, incumbent_spec=None) -> dict:
    """Roll `version` (holding Staging) across `pool` replica by replica,
    rolling back on any failed stage; returns the verdict (passed,
    action, stages, the gate's fields). Rollouts of one pool serialize
    on its rollout lock."""
    if X is None or int(np.shape(X)[0]) == 0:
        raise ValueError(
            "staged_rollout needs gate traffic (X) — every stage drives "
            "it through the next replica so the canary mirror can judge "
            "the candidate against the incumbent")
    if gate is None:
        from ..ct._gate import CanaryGate
        gate = CanaryGate()
    with pool._rollout_lock:
        return _run(pool, int(version), gate, np.asarray(X), y,
                    candidate_spec, incumbent_spec)


def _run(pool, version: int, gate, X, y, candidate_spec,
         incumbent_spec) -> dict:
    name = pool.name
    vmeta = _store.get_model_version(name, version)
    if vmeta is None or vmeta.get("current_stage") != "Staging":
        found = None if vmeta is None else vmeta.get("current_stage")
        raise ValueError(
            f"rollout candidate {name!r} v{version} must hold Staging "
            f"(found {found!r}) — the replicas' canary mirrors shadow "
            f"the Staging alias")
    incumbent = _production_version(name)
    replicas = [r for r in pool.replicas() if r.alive]
    if not replicas:
        raise ValueError(f"pool {name!r} has no live replicas to roll "
                         f"the candidate onto")
    PROFILER.count("fleet.rollouts")
    stages: List[dict] = []
    pinned: List[Replica] = []
    out: dict = {"version": version, "incumbent": incumbent,
                 "replicas": len(replicas)}
    verdict: dict = {}
    for replica in replicas:
        verdict = gate.run(replica.endpoint, X, y, candidate_spec,
                           incumbent_spec)
        # did the Production alias move while this stage ran?
        moved = _production_version(name) != incumbent
        stage = {"rid": replica.rid, "passed": bool(verdict["passed"]),
                 "aborted_by_transition": moved,
                 "checks": dict(verdict.get("checks") or {})}
        stages.append(stage)
        if _OBS.enabled:
            _OBS.emit("fleet", "fleet.rollout_stage",
                      args=dict(stage, version=version))
        if verdict["passed"] and not moved:
            replica.endpoint.pin_version(version)
            pinned.append(replica)
            continue
        # the rollback edge
        for p in pinned:
            p.endpoint.unpin()
        _archive_if_staging(name, version)
        evicted = bundle = None
        if not moved:
            # the replica whose gate failed goes, with its bundle; an
            # alias-move abort evicts nothing (nothing diverged)
            evicted = replica.rid
            bundle = pool.evict(replica.rid, reason="rollout-divergence",
                                blackbox=True)
        PROFILER.count("fleet.rollout_rollbacks")
        out.update({k: verdict[k] for k in _VERDICT_KEYS if k in verdict})
        out.update({"passed": False, "action": "rolled_back",
                    "stages": stages, "evicted": evicted,
                    "blackbox": bundle, "aborted_by_transition": moved})
        if _OBS.enabled:
            _OBS.emit("fleet", "fleet.rollout", args={
                "name": name, "version": version, "passed": False,
                "evicted": evicted, "blackbox": bundle,
                "aborted_by_transition": moved})
        return out
    # every stage passed: commit, then drop the pins
    _store.set_version_stage(name, version, "Production",
                             archive_existing_versions=True)
    for p in pinned:
        p.endpoint.unpin()
    PROFILER.count("fleet.rollout_promotions")
    # the last stage's gate fields, which a caller logs either way
    out.update({k: verdict[k] for k in _VERDICT_KEYS if k in verdict})
    out.update({"passed": True, "action": "promoted", "stages": stages,
                "evicted": None, "blackbox": None,
                "aborted_by_transition": False})
    if _OBS.enabled:
        _OBS.emit("fleet", "fleet.rollout", args={
            "name": name, "version": version, "passed": True,
            "stages": len(stages)})
    return out
