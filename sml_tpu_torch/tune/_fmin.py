"""`fmin` + TPE + trial stores: the hyperopt-mode tuning engine.

The port's copy of `sml_tpu/tune/_fmin.py`. Two execution modes, the
course's (`SML/ML 08 - Hyperopt.py:17-23`):

- `Trials()`: the objective runs in-process and may itself fit on the
  card, like `fmin` over MLlib pipelines (`ML 08:91-170`);
- `TpuTrials(parallelism=k)` (alias `SparkTrials`): objectives run
  k at a time in worker threads on the session's device
  (`device.run_placed_trials`), the `SparkTrials(parallelism=2)` pattern
  of `Labs/ML 08L:89-107`; the TPE proposer stays on the host. Under a
  mesh of several ranks a generation's trials run on disjoint groups of
  ranks instead: every rank proposes the same points from the same
  `rstate` (checked: `_same_proposals`) and records every result.

The TPE is the JAX package's: split completed trials at the
γ-quantile of loss, model each group with a per-dimension KDE in unit
space, and draw a candidate in proportion to the good/bad density
ratio. Under the same `RandomState` it proposes the JAX package's
points, draw for draw.

A parallel generation's results are recorded in proposal order (the
JAX package records them as they complete), so a trial history does
not depend on thread timing. An exception in an objective is recorded
as a `STATUS_FAIL` trial, as hyperopt does; an exception in a
`score_batch` propagates, and only a `score_batch` returning None
sends its generation to the per-trial path.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ._space import Choice, Dimension, space_eval

STATUS_OK = "ok"
STATUS_FAIL = "fail"


class Trials:
    """In-process sequential trial store (hyperopt mode 1)."""

    parallelism = 1

    def __init__(self):
        self.trials: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def record(self, params: Dict[str, Any], result: Dict[str, Any]) -> None:
        with self._lock:
            tid = len(self.trials)
            self.trials.append({
                "tid": tid,
                "misc": {"vals": {k: [v] for k, v in params.items()}},
                "result": result,
                "state": 2,  # JOB_STATE_DONE
            })

    # -- hyperopt-compatible accessors ------------------------------------
    @property
    def results(self) -> List[Dict[str, Any]]:
        return [t["result"] for t in self.trials]

    def losses(self) -> List[Optional[float]]:
        return [t["result"].get("loss") for t in self.trials]

    @property
    def best_trial(self) -> Dict[str, Any]:
        ok = [t for t in self.trials
              if t["result"].get("status") == STATUS_OK
              and t["result"].get("loss") is not None]
        if not ok:
            raise ValueError("no successful trials")
        return min(ok, key=lambda t: t["result"]["loss"])

    @property
    def argmin(self) -> Dict[str, Any]:
        return {k: v[0] for k, v in self.best_trial["misc"]["vals"].items()}

    def __len__(self):
        return len(self.trials)

    def _completed(self):
        return [({k: v[0] for k, v in t["misc"]["vals"].items()},
                 t["result"]["loss"])
                for t in self.trials
                if t["result"].get("status") == STATUS_OK
                and t["result"].get("loss") is not None]


class TpuTrials(Trials):
    """Parallel trial store: objectives fan out `parallelism`-wide (the
    `SparkTrials` replacement; each trial is a host thread driving the
    session's device instead of a Spark task on an executor)."""

    def __init__(self, parallelism: int = 2, timeout: Optional[float] = None):
        super().__init__()
        self.parallelism = max(1, int(parallelism))
        self.timeout = timeout


SparkTrials = TpuTrials  # drop-in name for course code


# ---------------------------------------------------------------------------
def _bw(obs: np.ndarray) -> float:
    """Unit-space KDE bandwidth, shared by the proposal sampler and the
    scoring density (one constant, one formula — they must stay in sync).
    The 0.1 floor keeps exploration alive once the good set clusters."""
    return max(float(np.std(obs)) * max(len(obs), 1) ** -0.2, 0.1)


def _kde_logpdf(x: np.ndarray, obs: np.ndarray) -> np.ndarray:
    """1-D Gaussian-KDE log-density in unit space, mixed with a uniform
    prior (weight 0.2) the way TPE keeps its prior component alive."""
    if len(obs) == 0:
        return np.zeros_like(x)
    bw = _bw(obs)
    d = (x[:, None] - obs[None, :]) / bw
    kde = np.mean(np.exp(-0.5 * d * d), axis=1) / (bw * np.sqrt(2 * np.pi))
    return np.log(0.9 * kde + 0.1 + 1e-300)


def _tpe_propose(space: Dict[str, Dimension], completed, rng: np.random.RandomState,
                 gamma: float = 0.25, n_candidates: int = 64) -> Dict[str, Any]:
    losses = np.array([l for _, l in completed])
    # good set = best γ-quantile, capped at 25 (hyperopt's linear schedule;
    # an r2-era √n schedule kept the set at ~3 clustered points, collapsing
    # the KDE bandwidth to its floor and freezing the search on plateaus)
    n_good = min(25, max(3, int(np.ceil(gamma * len(losses)))))
    cut = np.sort(losses)[n_good - 1]
    good = [p for p, l in completed if l <= cut][:n_good]
    bad = [p for p, l in completed if l > cut]
    out: Dict[str, Any] = {}
    for name, dim in space.items():
        if isinstance(dim, Choice):
            k = len(dim.options)
            cg = np.ones(k)
            cb = np.ones(k)
            for p in good:
                cg[int(p[name])] += 1
            for p in bad:
                cb[int(p[name])] += 1
            score = np.log(cg / cg.sum()) - np.log(cb / cb.sum())
            # sample ∝ good-probability · exp(score), mirroring the
            # continuous branch: a deterministic argmax freezes categorical
            # dims on plateaus exactly like it froze continuous ones
            w = (cg / cg.sum()) * np.exp(score - score.max())
            out[name] = int(rng.choice(k, p=w / w.sum()))
        else:
            g = np.array([dim.to_unit(p[name]) for p in good])
            b = np.array([dim.to_unit(p[name]) for p in bad])
            # candidates: 3/4 drawn around good observations (adaptive
            # bandwidth), 1/4 uniform exploration — the prior mixture that
            # keeps TPE from collapsing onto an early local mode
            n_exploit = (3 * n_candidates) // 4 if len(g) else 0
            bw = _bw(g) if len(g) else 1.0
            exploit = np.clip(g[rng.randint(0, max(len(g), 1), n_exploit)]
                              + rng.normal(0, bw, n_exploit), 0, 1) \
                if n_exploit else np.zeros(0)
            explore = rng.uniform(0, 1, n_candidates - n_exploit)
            cands = np.concatenate([exploit, explore])
            score = _kde_logpdf(cands, g) - _kde_logpdf(cands, b)
            # SAMPLE ∝ exp(score) instead of argmax: a deterministic argmax
            # re-proposes the good-set mode forever (nothing new ever enters
            # the good set — the r2 search could stall on plateaus and lose
            # to random); the softmax draw is the exploration TPE needs
            w = np.exp(score - score.max())
            out[name] = dim.from_unit(
                float(cands[rng.choice(len(cands), p=w / w.sum())]))
    return out


class _TPE:
    n_startup_trials = 10

    def suggest(self, space, trials: Trials, rng) -> Dict[str, Any]:
        completed = trials._completed()
        if len(completed) < self.n_startup_trials:
            return {k: d.sample(rng) for k, d in space.items()}
        return _tpe_propose(space, completed, rng)


class _Rand:
    def suggest(self, space, trials, rng) -> Dict[str, Any]:
        return {k: d.sample(rng) for k, d in space.items()}


tpe = _TPE()
rand = _Rand()
anneal = _Rand()


def _normalize_result(res) -> Dict[str, Any]:
    if isinstance(res, dict):
        if "status" not in res:
            res = {**res, "status": STATUS_OK}
        return res
    return {"loss": float(res), "status": STATUS_OK}


def _same_proposals(proposals: List[Dict[str, Any]]) -> None:
    """Under a mesh of several ranks, raise unless every rank proposed
    the same generation: one MIN and one MAX all-reduce of a hash of the
    proposals. Ranks proposing apart would run different trials on one
    group and hang or record a wrong history."""
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    if mesh is None or mesh.size <= 1:
        return
    import hashlib

    import torch

    from ..parallel import collectives as coll
    h = hashlib.blake2b(repr(proposals).encode(), digest_size=7)
    mine = torch.tensor([int.from_bytes(h.digest(), "little")],
                        dtype=torch.int64, device=mesh.device)
    if not torch.equal(coll.pmin(mine, mesh=mesh), coll.pmax(mine,
                                                             mesh=mesh)):
        raise ValueError(f"the {mesh.size} ranks of the mesh proposed "
                         f"different trials: give fmin the same rstate on "
                         f"every rank")


def fmin(fn: Callable, space: Dict[str, Dimension], algo=None,
         max_evals: int = 10, trials: Optional[Trials] = None,
         rstate: Optional[np.random.RandomState] = None,
         verbose: bool = False, show_progressbar: bool = False) -> Dict[str, Any]:
    """Minimize `fn` over `space`. Returns the best raw point
    (hp.choice dims as indices, like hyperopt; use `space_eval` to resolve)."""
    algo = algo or tpe
    suggest = algo.suggest if hasattr(algo, "suggest") else algo
    trials = trials if trials is not None else Trials()
    if rstate is None:
        rstate = np.random.RandomState()
    if isinstance(rstate, np.random.Generator):
        rstate = np.random.RandomState(rstate.integers(0, 2 ** 31))

    def evaluate(params: Dict[str, Any]) -> Dict[str, Any]:
        try:
            return _normalize_result(fn(space_eval(space, params)))
        except Exception as e:  # a failed trial, recorded not raised
            return {"status": STATUS_FAIL, "error": repr(e)}

    def record(params: Dict[str, Any], res: Dict[str, Any]) -> None:
        trials.record(params, res)
        if verbose:
            print(f"trial {len(trials)}/{max_evals}: "
                  f"{space_eval(space, params)} -> {res.get('loss')}")

    width = getattr(trials, "parallelism", 1)
    # batch-capable objectives (fn.score_batch(values_list) -> losses):
    # candidates are proposed and scored a generation at a time, so an
    # objective backed by the grid-fused tree fits
    # (ml.tuning.fused_param_scores) pays one fused fit per generation
    # instead of one per trial. score_batch returning None sends that
    # generation to the per-trial path (same proposals, same losses)
    score_batch = getattr(fn, "score_batch", None)
    from ..conf import GLOBAL_CONF
    gen = GLOBAL_CONF.getInt("sml.tune.candidatesPerDispatch") \
        if callable(score_batch) else 1
    if max(width, gen) <= 1:
        while len(trials) < max_evals:
            params = suggest(space, trials, rstate)
            record(params, evaluate(params))
    else:
        from ..device import run_placed_trials
        while len(trials) < max_evals:
            batch = min(max(width, gen), max_evals - len(trials))
            # a generation's proposals draw from one posterior; the rng
            # advances per proposal, so the generation is diverse
            proposals = [suggest(space, trials, rstate) for _ in range(batch)]
            _same_proposals(proposals)
            results = None
            if callable(score_batch) and batch > 1:
                results = score_batch([space_eval(space, p)
                                       for p in proposals])
            if results is None:
                # concurrency is the user's parallelism, never the
                # generation size: a declined score_batch on a
                # parallelism=1 store runs its trials one by one
                results = run_placed_trials(proposals, evaluate,
                                            min(width, len(proposals)))
            else:
                results = [_normalize_result(r) for r in results]
            for p, res in zip(proposals, results):
                record(p, res)
    return trials.argmin
