"""Faults planted in the program, to show that `correct` catches them.

Each is a context manager that patches the port's fit path for the
enclosed fits (by the module attributes the estimators call):

- `stale_state`: a round that leaves the fit's state as it was: a
  boosted fit never moves its margin (every round fits the start's
  gradients), a forest draws every round under round 0's keys.
- `half_batch`: the fit sees only the first half of its rows, their
  mean taken over that half.
- `altered_answer`: one leaf of every tree, its most covered, is off by
  1% where the fit produces it.
- `second_best`: below the root, every node splits on the best candidate
  of the features other than its best one (the split scan's answer
  altered where it is produced).

The cells run on one card, so no fault drops an exchange between chips.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("stale_state", "half_batch", "altered_answer", "second_best")


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def planted(fault: str, boosting: bool):
    from sml_tpu_torch.ml import _tree_models as tm
    from sml_tpu_torch.ml import tree_impl as ti
    if fault == "stale_state" and boosting:
        def make(orig):
            def fit(binned, y, es, *a, **k):
                return orig(binned, y, es._replace(step_size=0.0), *a, **k)
            return fit
        return _patched(tm, "fit_ensemble_on_device", make)
    if fault == "stale_state":
        def make(orig):
            def keys(rngs, n_trees, depth):
                k = orig(rngs, n_trees, depth)
                return np.ascontiguousarray(np.broadcast_to(k[:1], k.shape))
            return keys
        return _patched(ti, "fit_keys", make)
    if fault == "half_batch":
        def make(orig):
            def fit(binned, y, *a, **k):
                half = binned.shape[0] // 2
                return orig(binned[:half], y[:half], *a, **k)
            return fit
        return _patched(tm, "fit_ensemble_on_device", make)
    if fault == "altered_answer":
        def make(orig):
            def fit(*a, **k):
                trees, base = orig(*a, **k)
                out = []
                for t in trees:
                    leaf = t.leaf_value.copy()
                    n = len(leaf)
                    parent = np.maximum((np.arange(n) - 1) // 2, 0)
                    reached = (t.split_feature < 0) & (t.cover > 0) \
                        & ((t.split_feature[parent] >= 0) | (np.arange(n) == 0))
                    i = int(np.argmax(np.where(reached, t.cover, -1.0)))
                    leaf[i] = leaf[i] * np.float32(1.01)
                    out.append(t._replace(leaf_value=leaf))
                return out, base
            return fit
        return _patched(tm, "fit_ensemble_on_device", make)
    if fault == "second_best":
        import torch

        from sml_tpu_torch.native import hist_kernel as hk

        def make(orig):
            def scan(hist, fmask, min_inst, **k):
                pack = orig(hist, fmask, min_inst, **k)
                if hist.shape[2] < 2:
                    return pack
                m = fmask.clone()
                m[torch.arange(m.shape[0], device=m.device),
                  pack[0].long()] = 0
                return orig(hist, m, min_inst, **k)
            return scan
        return _patched(hk, "split_scan", make)
    raise ValueError(f"unknown fault {fault!r}")
