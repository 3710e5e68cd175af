"""Loader of the on-disk model format written by the JAX package.

A saved model is a directory holding `metadata.json` ({class, uid,
params, extra}) and `data.npz` with its array state
(`sml_tpu/ml/base.py`, `Saveable._save_to` and `save_arrays`). The
class named in `metadata.json` is the JAX package's; it maps to the
port's class through `MODEL_CLASSES`, a plain table, so loading never
imports the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """The arrays of `<path>/data.npz` ({} when there is none). Object
    arrays are refused: the format holds numbers only."""
    fp = os.path.join(path, "data.npz")
    if not os.path.exists(fp):
        return {}
    with np.load(fp, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _model_classes() -> dict:
    from .. import xgboost
    from . import _tree_models as tm
    return {
        "sml_tpu.ml._tree_models.DecisionTreeRegressionModel":
            tm.DecisionTreeRegressionModel,
        "sml_tpu.ml._tree_models.DecisionTreeClassificationModel":
            tm.DecisionTreeClassificationModel,
        "sml_tpu.ml._tree_models.RandomForestRegressionModel":
            tm.RandomForestRegressionModel,
        "sml_tpu.ml._tree_models.RandomForestClassificationModel":
            tm.RandomForestClassificationModel,
        "sml_tpu.ml._tree_models.GBTRegressionModel": tm.GBTRegressionModel,
        "sml_tpu.ml._tree_models.GBTClassificationModel":
            tm.GBTClassificationModel,
        "sml_tpu.xgboost.XgboostRegressorModel":
            xgboost.XgboostRegressorModel,
        "sml_tpu.xgboost.XgboostClassifierModel":
            xgboost.XgboostClassifierModel,
    }


def load_model(path: str):
    """The port's model for a directory saved by the JAX package's
    `model.save(path)`. Raises ValueError for a class the port does not
    carry yet."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    klass = _model_classes().get(meta["class"])
    if klass is None:
        raise ValueError(f"{path}: the port cannot load {meta['class']!r} "
                         f"yet (tree-ensemble models only)")
    return klass._load(path, meta)
