"""Tree-ensemble models, host binning and scoring (`sml_tpu.ml`)."""

from ._tree_models import spec_from_arrays
from .base import load_model
from .inference import DeviceScorer, forest_eval_fn, predict_forest_sharded

__all__ = ["DeviceScorer", "forest_eval_fn", "load_model",
           "predict_forest_sharded", "spec_from_arrays"]
