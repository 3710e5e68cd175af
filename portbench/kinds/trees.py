"""Tree ensembles as the harness reads them from the port.

A configuration of `kind` "trees" names its estimator and the model the
reference holds it to (`model`). This file reads what a fit returned
(through the model's own saved format, `data.npz`, in the keys both
packages share, and its outputs on the held-out rows), the work of one
fit, and the shapes the traced run's per-layer metrics read.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict

import numpy as np


def model_arrays(model) -> Dict[str, np.ndarray]:
    """The fitted model as the saved format holds it: (T, N)
    `split_feature`, `split_bin`, `leaf_value`, the (F, B-1) `edges`,
    `tree_weights` and `base`."""
    path = tempfile.mkdtemp(prefix="portbench-model-")
    try:
        target = os.path.join(path, "model")
        model.save(target)
        with np.load(os.path.join(target, "data.npz"),
                     allow_pickle=False) as z:
            d = {k: np.array(z[k]) for k in ("split_feature", "split_bin",
                                             "leaf_value", "edges",
                                             "tree_weights", "scalars")}
    finally:
        shutil.rmtree(path, ignore_errors=True)
    d["base"] = float(d.pop("scalars")[1])
    return d


def outputs(model, cfg: dict, X: np.ndarray, device=None) -> np.ndarray:
    """The model's output on rows X: P(class 1) of a classifier, the
    prediction of a regressor."""
    if cfg["model"]["output"] == "probability":
        return np.asarray(model.predict_probability(X, device), np.float64)
    return np.asarray(model.predict(X, device), np.float64)


def answer(model, cfg: dict, host: dict, device=None) -> dict:
    """What the reference judges of one fit: its saved arrays and
    `heldout`, its output on the held-out rows."""
    return dict(model_arrays(model),
                heldout=outputs(model, cfg, host["X_test"], device))


def work(cfg: dict, host: dict) -> dict:
    """One fit's work: its training rows, trees and depth."""
    m = cfg["model"]
    return {"rows": int(host["y"].shape[0]), "trees": int(m["n_trees"]),
            "depth": int(m["max_depth"])}


def shape(cfg: dict, host: dict) -> dict:
    """The shapes the roofline and the whole fit's share are read at."""
    m = cfg["model"]
    return {"n": int(host["y"].shape[0]), "F": int(host["X"].shape[1]),
            "B": int(m["max_bins"]), "D": int(m["max_depth"]),
            "T": int(m["n_trees"]), "boosting": bool(m["boosting"]),
            "mode": m["row_weights"], "rate": float(m["rate"])}


def shrink(cfg: dict, scale: dict) -> None:
    """Cut the configuration's rounds to `scale["rounds"]` (tests)."""
    if "rounds" in scale:
        est = cfg["estimator"]
        est["params"][est["rounds_param"]] = int(scale["rounds"])
        cfg["model"]["n_trees"] = int(scale["rounds"])
