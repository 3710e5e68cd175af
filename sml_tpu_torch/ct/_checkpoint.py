"""Round-level boost checkpoints: an interrupted fit resumes mid-boost.

The port's copy of `sml_tpu/ct/_checkpoint.py`. `BoostCheckpoint`
persists the partial ensemble at every segment boundary of a boosted fit
(the `on_rounds(t_done, trees, base)` hook of
`tree_impl.fit_ensemble_on_device` / `resume_ensemble_on_device`, every
`rounds_per_dispatch` rounds), and `checkpointed_fit` wraps the chunked
fit so that a re-run on the same directory loads the newest checkpoint
and warm-starts the remaining rounds. The resumed model equals the
uninterrupted one bit for bit: the appended rounds draw under the keys
of their round index, and the margin replay is the fit's f32 carry.

Layout (the pointer file is written last, so a kill mid-save leaves the
previous checkpoint whole):

    <dir>/rounds-<t>/        the partial spec (`_EnsembleSpec.save`)
    <dir>/LATEST.json        {"t": t, "path": "rounds-<t>", ...meta}

The partial spec is saved in the JAX package's format, so a checkpoint
written by either package loads in the other.

Under a mesh of ranks (`parallel.mesh.get_mesh()`) every rank fits, and
every rank calls `save` and `clear` at the same points; the ranks share
one filesystem, so only the mesh's lowest rank writes, prunes and
removes, and every rank then waits for it (one MAX all-reduce of its
failure flag, `_writer`) before any of them reads the directory again.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np

from ..utils.profiler import PROFILER

_LATEST = "LATEST.json"

#: the warm-start params a checkpoint carries so that a resume runs the
#: same rounds (the seed rides separately)
_RESUME_PARAMS = ("step_size", "subsample", "min_instances",
                  "min_info_gain", "reg_lambda", "gamma", "loss")


def _meta_match(saved: dict, want: dict, keys) -> bool:
    """Whether a checkpoint belongs to this fit: mode, target, seed and
    the resume params all agree. Any other checkpoint is cleared and the
    fit starts clean, never resuming into the wrong ensemble."""
    return all(saved.get(k) == want.get(k) for k in keys)


def _writer(body) -> None:
    """Run `body` on the mesh's lowest rank only (on this process when
    there is no mesh of several ranks), then hold every rank of the mesh
    until it is done: one MAX all-reduce of its failure flag, which
    doubles as the barrier, so that when the writer raises, whatever it
    raises, every rank raises: the writer its own exception, the others
    an OSError naming it."""
    import torch

    from ..parallel import collectives as coll
    from ..parallel.mesh import get_mesh
    mesh = get_mesh()
    if mesh is None or mesh.size <= 1:
        body()
        return
    error = None
    if mesh.rank == 0:
        try:
            body()
        except Exception as e:  # noqa: BLE001 — re-raised below, once
            error = e           # every rank has joined the flag's pmax
    failed = coll.pmax(torch.tensor([int(error is not None)],
                                    device=mesh.device), mesh=mesh)
    if error is not None:
        raise error
    if int(failed[0]):
        raise OSError(f"rank {mesh.ranks[0]} of the mesh failed to write "
                      f"the checkpoint")


class BoostCheckpoint:
    """One fit's checkpoint directory. `save()` runs on the fit's thread
    at segment boundaries; `load()` and `clear()` on the caller's. A save
    writes a temporary directory and renames it, then swings the
    LATEST pointer the same way. Under a mesh of ranks only the lowest
    rank writes (`_writer`)."""

    def __init__(self, directory: str, keep: int = 2):
        self._dir = directory
        self._keep = max(int(keep), 1)
        self._lock = threading.Lock()

    @property
    def directory(self) -> str:
        return self._dir

    def save(self, partial_spec, t_done: int, meta: dict) -> None:
        """Persist the partial ensemble after round `t_done` with `meta`
        (the target, the seed and `_RESUME_PARAMS`)."""
        with self._lock:
            _writer(lambda: self._write(partial_spec, t_done, meta))
            PROFILER.count("ct.checkpoints")

    def _write(self, partial_spec, t_done: int, meta: dict) -> None:
        os.makedirs(self._dir, exist_ok=True)
        rel = f"rounds-{int(t_done)}"
        tmp = os.path.join(self._dir, rel + ".tmp")
        final = os.path.join(self._dir, rel)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        partial_spec.save(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        pointer = dict(meta)
        pointer.update({"t": int(t_done), "path": rel})
        ptmp = os.path.join(self._dir, _LATEST + ".tmp")
        with open(ptmp, "w") as fh:
            json.dump(pointer, fh)
        os.replace(ptmp, os.path.join(self._dir, _LATEST))
        self._prune(keep_rel=rel)

    def _prune(self, keep_rel: str) -> None:
        rounds = sorted(
            (d for d in os.listdir(self._dir) if d.startswith("rounds-")
             and not d.endswith(".tmp")),
            key=lambda d: int(d.split("-", 1)[1]))
        for d in rounds[:-self._keep]:
            if d != keep_rel:
                shutil.rmtree(os.path.join(self._dir, d),
                              ignore_errors=True)

    def load(self):
        """(partial `_EnsembleSpec`, meta) of the newest committed
        checkpoint, or None when the directory holds none."""
        from ..ml._tree_models import _EnsembleSpec
        with self._lock:
            try:
                with open(os.path.join(self._dir, _LATEST)) as fh:
                    pointer = json.load(fh)
            except (OSError, ValueError):
                return None
            path = os.path.join(self._dir, pointer["path"])
            if not os.path.isdir(path):
                return None
            return _EnsembleSpec.load(path), pointer

    def clear(self) -> None:
        with self._lock:
            _writer(lambda: shutil.rmtree(self._dir, ignore_errors=True))


def _snapshot_spec(trees, step_size: float, depth: int, binning, base,
                   n_features: int, mode: str):
    """A boosted `_EnsembleSpec` of the rounds so far."""
    from ..ml._tree_models import _EnsembleSpec
    w = np.full(len(trees), float(step_size), dtype=np.float32)
    return _EnsembleSpec(list(trees), depth, binning, w, float(base),
                         n_features, mode)


def checkpointed_warm_start(spec, source, checkpoint_dir: str, *,
                            n_new_trees: int, seed: int = 17, sketch=None,
                            device=None, **resume_kwargs):
    """`warm_start_ensemble_chunked` with round-level checkpoints: an
    interrupted warm start resumes from its last segment boundary and
    finishes equal to the uninterrupted one bit for bit (the partial
    ensemble is itself a warm-start seed). The checkpoint carries
    mode="warm" and (target, seed, params); only a matching re-run
    resumes it, anything else clears it, and `checkpointed_fit` keeps
    the same guard the other way."""
    from ..ml._chunked import warm_start_ensemble_chunked
    ck = BoostCheckpoint(checkpoint_dir)
    step = float(resume_kwargs["step_size"]
                 if resume_kwargs.get("step_size") is not None
                 else spec.tree_weights[0])
    n_target = len(spec.trees) + int(n_new_trees)
    meta = {"mode": "warm", "n_target": n_target, "seed": int(seed),
            "step_size": step,
            "subsample": float(resume_kwargs.get("subsample", 1.0)),
            "loss": resume_kwargs.get("loss")
            or ("logistic" if spec.mode == "binary" else "squared")}
    start, remaining = spec, int(n_new_trees)
    resume = ck.load()
    if resume is not None:
        partial, saved = resume
        if _meta_match(saved, meta, ("mode", "n_target", "seed",
                                     "step_size", "subsample", "loss")) \
                and len(spec.trees) < len(partial.trees) <= n_target:
            PROFILER.count("ct.resumes")
            start, remaining = partial, n_target - len(partial.trees)
        else:
            ck.clear()

    def hook(t_done, new_trees, base):
        snap = _snapshot_spec(list(start.trees) + list(new_trees), step,
                              spec.depth, spec.binning, base,
                              spec.n_features, spec.mode)
        ck.save(snap, t_done, meta)

    out = warm_start_ensemble_chunked(
        start, source, n_new_trees=remaining, seed=seed, sketch=sketch,
        device=device, on_rounds=hook, **resume_kwargs)
    ck.clear()
    return out


def checkpointed_fit(source, checkpoint_dir: str, *, n_trees: int,
                     max_depth: int, max_bins: int, seed: int = 17,
                     categorical=None, loss: str = "squared",
                     step_size: float = 0.1, subsample: float = 1.0,
                     min_instances: int = 1, min_info_gain: float = 0.0,
                     reg_lambda: float = 0.0, gamma: float = 0.0,
                     rounds_per_dispatch: Optional[int] = None,
                     drift_baseline=None, sketch=None, on_checkpoint=None,
                     device=None):
    """A chunked boosting fit on `device` that survives interruption:
    every segment boundary (`rounds_per_dispatch` rounds apart; one
    segment has no boundary) checkpoints the partial ensemble, and a
    re-run on the same directory and source warm-starts the remaining
    rounds from the newest checkpoint, but only when its (mode, target,
    seed, params) match this request; any other checkpoint is cleared.
    Returns the finished `_EnsembleSpec`, bit for bit the uninterrupted
    fit's, and clears the checkpoints. `on_checkpoint(t_done)` fires
    after each checkpoint is committed (an exception it raises aborts
    the fit, not the checkpoint). A fresh fit's ingest judges each chunk
    against `drift_baseline` (`ingest_source`), and its pass-1 sketch is
    the model's baseline."""
    from ..ml._chunked import ingest_source, warm_start_ensemble_chunked
    from ..ml._tree_models import _fit_ensemble

    ck = BoostCheckpoint(checkpoint_dir)
    meta = {"mode": "fresh", "n_target": int(n_trees), "seed": int(seed),
            "step_size": float(step_size), "subsample": float(subsample),
            "min_instances": int(min_instances),
            "min_info_gain": float(min_info_gain),
            "reg_lambda": float(reg_lambda), "gamma": float(gamma),
            "loss": loss, "rounds_per_dispatch": rounds_per_dispatch}
    resume = ck.load()
    if resume is not None:
        partial, saved = resume
        if not _meta_match(saved, meta,
                           ("mode", "n_target", "seed") + _RESUME_PARAMS):
            ck.clear()
            resume = None
    if resume is not None:
        partial, saved = resume
        PROFILER.count("ct.resumes")
        remaining = int(saved["n_target"]) - len(partial.trees)
        if remaining <= 0:
            ck.clear()
            return partial

        def warm_hook(t_done, new_trees, base):
            snap = _snapshot_spec(
                list(partial.trees) + list(new_trees),
                float(saved["step_size"]), partial.depth, partial.binning,
                base, partial.n_features, partial.mode)
            ck.save(snap, t_done, saved)
            if on_checkpoint is not None:
                on_checkpoint(int(t_done))

        spec = warm_start_ensemble_chunked(
            partial, source, n_new_trees=remaining,
            seed=int(saved["seed"]), on_rounds=warm_hook, sketch=sketch,
            rounds_per_dispatch=saved.get("rounds_per_dispatch"),
            device=device, **{k: saved[k] for k in _RESUME_PARAMS})
        ck.clear()
        return spec

    # a fresh fit: ingest once, then the prebinned fit with a hook that
    # saves (trees so far, the fit's base, the ingest's binning)
    mode = "binary" if loss == "logistic" else "regression"
    categorical = categorical or {}
    ing = ingest_source(source, max_bins, categorical, sketch=sketch,
                        device=device, label="ct_fit",
                        drift_baseline=drift_baseline)
    if ing.y is None:
        raise ValueError("checkpointed_fit needs a labeled ChunkSource")

    def fresh_hook(t_done, trees_so_far, base):
        snap = _snapshot_spec(trees_so_far, step_size, max_depth,
                              ing.binning, base, source.n_features, mode)
        ck.save(snap, t_done, meta)
        if on_checkpoint is not None:
            on_checkpoint(int(t_done))

    spec = _fit_ensemble(
        None, ing.y, categorical=categorical, max_depth=max_depth,
        max_bins=max_bins, min_instances=min_instances,
        min_info_gain=min_info_gain, n_trees=n_trees, feature_k=None,
        bootstrap=False, subsample=subsample, seed=seed, loss=loss,
        step_size=step_size, reg_lambda=reg_lambda, gamma=gamma,
        boosting=True, rounds_per_dispatch=rounds_per_dispatch,
        prebinned=(ing.binned, ing.binning), baseline_sketch=ing.sketch,
        on_rounds=fresh_hook, block=ing.block, device=device)
    ck.clear()
    return spec
