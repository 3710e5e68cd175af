"""Course-code compatibility shims: run the course's code unchanged on
the port.

The port's copy of `sml_tpu/compat.py`, for the import names whose
modules the port has. `install_shims()` registers the port's modules
under the names the course imports —

    pyspark / pyspark.sql (functions, types, dataframe)
    pyspark.ml (pipeline, feature, regression, classification,
                clustering, recommendation, evaluation, tuning, linalg)
    hyperopt (fmin / tpe / hp / Trials / SparkTrials / STATUS_OK)
    sparkdl / sparkdl.xgboost (XgboostRegressor / XgboostClassifier)
    mlflow (.tracking, .spark, .sklearn, .pyfunc, .models,
            .models.signature, .tracking.client)
    databricks / databricks.automl / databricks.feature_store /
        databricks.koalas

— so `from pyspark.ml.feature import StringIndexer` resolves to
`sml_tpu_torch.ml.feature` and `import mlflow` to
`sml_tpu_torch.tracking`. Only missing names are registered: a real
installation of a package, if present, always wins, and the first
package to install a shim keeps it (`sys.modules.setdefault`).
Installing loads no pandas: `databricks.koalas` (`pandas_api`) and
`pyspark.sql.functions.pandas_udf` import it when called.
"""

from __future__ import annotations

import importlib.util
import sys
import types
from typing import Dict


def _module(name: str, **attrs) -> types.ModuleType:
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def _real_package(root: str) -> bool:
    """True when an actual installation of `root` exists (imported or
    merely installed): a shim never shadows a real package."""
    if root in sys.modules and not getattr(sys.modules[root],
                                           "__sml_tpu_shim__", False):
        return True
    try:
        return importlib.util.find_spec(root) is not None
    except (ImportError, ValueError):
        return False


def _register(mods: Dict[str, types.ModuleType]) -> None:
    skipped_roots = {name.split(".")[0] for name in mods
                     if "." not in name and _real_package(name)}
    for name, mod in mods.items():
        if name.split(".")[0] in skipped_roots:
            continue  # real package present: leave its whole tree alone
        mod.__sml_tpu_shim__ = True
        sys.modules.setdefault(name, mod)
        # wire submodule attributes, so `import pyspark.sql.functions as F`
        # and `pyspark.sql.functions.col` both resolve
        if "." in name:
            parent, _, child = name.rpartition(".")
            if parent in sys.modules:
                setattr(sys.modules[parent], child, sys.modules[name])


def install_shims() -> None:
    """Alias the port under the course's import names (idempotent)."""
    from . import automl as automl_mod
    from . import feature_store as fs_mod
    from . import pandas_api
    from . import tracking
    from . import tune as hyperopt_mod
    from . import xgboost as xgb_mod
    from .frame import functions as F
    from .frame import types as T
    from .frame.dataframe import DataFrame
    from .frame.session import TpuSession as SparkSession
    from .ml import base as ml_base
    from .ml import (classification, clustering, evaluation, feature,
                     linalg, recommendation, regression, tuning)

    mods = {
        "pyspark": _module("pyspark", SparkSession=SparkSession),
        "pyspark.sql": _module("pyspark.sql", SparkSession=SparkSession,
                               DataFrame=DataFrame, functions=F, types=T,
                               Row=T.Row),
        "pyspark.sql.functions": F,
        "pyspark.sql.types": T,
        "pyspark.sql.dataframe": _module("pyspark.sql.dataframe",
                                         DataFrame=DataFrame),
        "pyspark.ml": _module(
            "pyspark.ml", Pipeline=ml_base.Pipeline,
            PipelineModel=ml_base.PipelineModel,
            Transformer=ml_base.Transformer, Estimator=ml_base.Estimator,
            Model=ml_base.Model),
        "pyspark.ml.pipeline": _module(
            "pyspark.ml.pipeline", Pipeline=ml_base.Pipeline,
            PipelineModel=ml_base.PipelineModel),
        "pyspark.ml.feature": feature,
        "pyspark.ml.regression": regression,
        "pyspark.ml.classification": classification,
        "pyspark.ml.clustering": clustering,
        "pyspark.ml.recommendation": recommendation,
        "pyspark.ml.evaluation": evaluation,
        "pyspark.ml.tuning": tuning,
        "pyspark.ml.linalg": linalg,
        # hyperopt surface (ML 08 / 08L)
        "hyperopt": hyperopt_mod,
        # sparkdl xgboost surface (ML 11)
        "sparkdl": _module("sparkdl", xgboost=xgb_mod),
        "sparkdl.xgboost": xgb_mod,
        # databricks namespaces (ML 09 / 10 / 14)
        "databricks": _module("databricks", automl=automl_mod,
                              feature_store=fs_mod, koalas=pandas_api),
        "databricks.automl": automl_mod,
        "databricks.feature_store": fs_mod,
        "databricks.koalas": pandas_api,
    }
    _register(mods)
    if _real_package("mlflow"):
        return
    tracking.install_mlflow_shim()
    # mlflow.models.signature / mlflow.tracking.client spellings
    sys.modules.setdefault(
        "mlflow.models", _module("mlflow.models",
                                 signature=_module(
                                     "mlflow.models.signature",
                                     infer_signature=tracking.infer_signature,
                                     ModelSignature=tracking.ModelSignature)))
    sys.modules.setdefault("mlflow.models.signature",
                           sys.modules["mlflow.models"].signature)
    sys.modules.setdefault(
        "mlflow.tracking.client",
        _module("mlflow.tracking.client",
                MlflowClient=tracking.MlflowClient))
