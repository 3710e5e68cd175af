"""Hyperopt-compatible Bayesian tuning (the port's `sml_tpu.tune`).

The course's two hyperopt modes:

    from sml_tpu_torch.tune import fmin, hp, tpe, Trials, SparkTrials, STATUS_OK

`SparkTrials` is an alias of `TpuTrials`: trials run in host threads
on the session's device rather than on Spark executors.
"""

from ._fmin import (STATUS_FAIL, STATUS_OK, SparkTrials, TpuTrials, Trials,
                    anneal, fmin, rand, tpe)
from ._space import hp, space_eval

__all__ = ["fmin", "hp", "tpe", "rand", "anneal", "Trials", "TpuTrials",
           "SparkTrials", "STATUS_OK", "STATUS_FAIL", "space_eval"]
