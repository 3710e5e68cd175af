"""MLflow-compatible tracking and model registry, file-backed.

The port's copy of `sml_tpu/tracking/__init__.py`, over a store that
either package reads (`_store`). Usage is a drop-in for the course's
calls:

    from sml_tpu_torch import tracking as mlflow
    with mlflow.start_run(run_name="LR-model") as run:
        mlflow.log_param("label", "price")
        mlflow.log_metric("rmse", rmse)
        mlflow.spark.log_model(pipeline_model, "model")
    mlflow.search_runs(exp_id, order_by=["metrics.rmse ASC"])

Covers: runs, params, metrics, artifacts and figures (`SML/ML 04 -
MLflow Tracking.py:70-228`), nested runs, the spark / sklearn / pyfunc
model flavors with `runs:/` and `models:/` URIs (`SML/ML 05 - MLflow
Model Registry.py:197-210`), the registry with stage transitions, the
filter-string run search and the autolog stubs. `install_mlflow_shim()`
aliases this module as `mlflow` in sys.modules.

Where the JAX package hands pandas objects around, the port does not:
`search_runs` returns the port's DataFrame (the same columns in the
same order, NULL where a run lacks a key); `infer_signature` describes
a port DataFrame, a mapping of columns or a numpy array; an
`input_example` is written as `input_example.json` in pandas'
`orient="split"` shape by the standard library's `json`;
`PyFuncModel.predict` takes a port DataFrame or a mapping of columns,
and `spark_udf` returns a port `Column`.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import sys
import threading
import types
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from . import _store
from ._store import get_tracking_uri, set_tracking_uri

_active_runs = threading.local()
_active_experiment = {"id": None}


# ------------------------------------------------------------------ run facade
class RunInfo:
    def __init__(self, meta: Dict[str, Any]):
        self.run_id = meta["run_id"]
        self.run_uuid = meta["run_id"]
        self.experiment_id = meta["experiment_id"]
        self.run_name = meta.get("run_name")
        self.status = meta.get("status")
        self.artifact_uri = meta.get("artifact_uri")
        self.start_time = meta.get("start_time")
        self.end_time = meta.get("end_time")


class RunData:
    def __init__(self, params, metrics, tags):
        self.params = params
        self.metrics = metrics
        self.tags = tags


class Run:
    def __init__(self, meta, params=None, metrics=None, tags=None):
        self.info = RunInfo(meta)
        self.data = RunData(params or {}, metrics or {}, tags or {})


class ActiveRun(Run):
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        end_run("FAILED" if exc_type else "FINISHED")
        return False


def _run_stack() -> List[ActiveRun]:
    if not hasattr(_active_runs, "stack"):
        _active_runs.stack = []
    return _active_runs.stack


def set_experiment(name: str):
    exp = _store.get_or_create_experiment(name)
    _active_experiment["id"] = exp["experiment_id"]
    return types.SimpleNamespace(**exp)


def _current_experiment_id() -> str:
    if _active_experiment["id"] is None:
        _active_experiment["id"] = _store.default_experiment()["experiment_id"]
    return _active_experiment["id"]


def start_run(run_id: Optional[str] = None, run_name: Optional[str] = None,
              nested: bool = False, tags: Optional[Dict[str, str]] = None,
              experiment_id: Optional[str] = None) -> ActiveRun:
    stack = _run_stack()
    if stack and not nested:
        raise RuntimeError("a run is already active; use nested=True")
    exp_id = experiment_id or _current_experiment_id()
    parent = stack[-1].info.run_id if stack else None
    meta = _store.create_run(exp_id, run_name=run_name, tags=tags,
                             parent_run_id=parent)
    run = ActiveRun(meta)
    stack.append(run)
    return run


def end_run(status: str = "FINISHED") -> None:
    stack = _run_stack()
    if stack:
        run = stack.pop()
        _store.end_run(run.info.experiment_id, run.info.run_id, status)


def active_run() -> Optional[ActiveRun]:
    stack = _run_stack()
    return stack[-1] if stack else None


def _require_run() -> ActiveRun:
    run = active_run()
    if run is None:
        return start_run()
    return run


def log_param(key: str, value: Any) -> None:
    r = _require_run()
    _store.log_kv(r.info.experiment_id, r.info.run_id, "params", key, value)


def log_params(params: Dict[str, Any]) -> None:
    for k, v in params.items():
        log_param(k, v)


def log_metric(key: str, value: float, step: Optional[int] = None) -> None:
    r = _require_run()
    _store.log_kv(r.info.experiment_id, r.info.run_id, "metrics", key, value,
                  step=step)


def log_metrics(metrics: Dict[str, float], step: Optional[int] = None) -> None:
    for k, v in metrics.items():
        log_metric(k, v, step=step)


def log_engine_metrics(metrics: Dict[str, float],
                       step: Optional[int] = None) -> None:
    """Log engine metrics to the ACTIVE run (no implicit run creation:
    system metrics must never spawn runs). Keys are namespaced under
    `engine.` if not already."""
    if active_run() is None:
        return
    log_metrics({(k if k.startswith("engine.") else f"engine.{k}"):
                 float(v) for k, v in metrics.items()}, step=step)


def set_tag(key: str, value: Any) -> None:
    r = _require_run()
    _store.log_kv(r.info.experiment_id, r.info.run_id, "tags", key, value)


def set_tags(tags: Dict[str, Any]) -> None:
    for k, v in tags.items():
        set_tag(k, v)


def _artifact_dir(artifact_path: Optional[str] = None) -> str:
    r = _require_run()
    d = _store.run_dir(r.info.experiment_id, r.info.run_id)
    out = os.path.join(d, "artifacts", artifact_path or "")
    os.makedirs(out, exist_ok=True)
    return out


def log_artifact(local_path: str, artifact_path: Optional[str] = None) -> None:
    shutil.copy(local_path, _artifact_dir(artifact_path))


def log_artifacts(local_dir: str, artifact_path: Optional[str] = None) -> None:
    shutil.copytree(local_dir, _artifact_dir(artifact_path),
                    dirs_exist_ok=True)


def _artifact_file(artifact_file: str) -> str:
    return os.path.join(_artifact_dir(os.path.dirname(artifact_file) or None),
                        os.path.basename(artifact_file))


def log_figure(figure, artifact_file: str) -> None:
    figure.savefig(_artifact_file(artifact_file))


def log_text(text: str, artifact_file: str) -> None:
    with open(_artifact_file(artifact_file), "w") as f:
        f.write(text)


def log_dict(d: Dict, artifact_file: str) -> None:
    with open(_artifact_file(artifact_file), "w") as f:
        json.dump(d, f, indent=1, default=str)


def get_run(run_id: str) -> Run:
    d = _store.find_run(run_id)
    if d is None:
        raise ValueError(f"run {run_id!r} not found")
    rec = _store.read_run(d)
    return Run(rec["meta"], rec["params"], rec["metrics"], rec["tags"])


# -------------------------------------------------------------- model flavors
class ModelSignature:
    def __init__(self, inputs, outputs):
        self.inputs = inputs
        self.outputs = outputs

    def to_dict(self):
        return {"inputs": self.inputs, "outputs": self.outputs}

    def __repr__(self):
        return f"inputs:\n  {self.inputs}\noutputs:\n  {self.outputs}"


def infer_signature(model_input, model_output) -> ModelSignature:
    """The columns (name and type) of a port DataFrame or of a mapping
    of columns, or the type and shape of an array."""
    from ..frame.dataframe import DataFrame
    from ..frame.session import column_array

    def describe(x):
        if isinstance(x, DataFrame):
            return [{"name": f.name, "type": f.dataType.simpleString()}
                    for f in x.schema.fields]
        if isinstance(x, Mapping):
            return [{"name": str(c), "type": str(column_array(v).dtype)}
                    for c, v in x.items()]
        arr = np.asarray(x)
        return [{"type": str(arr.dtype), "shape": list(arr.shape)}]
    return ModelSignature(describe(model_input), describe(model_output))


def _resolve_model_uri(model_uri: str) -> str:
    """runs:/<id>/<path>, models:/<name>/<version|Stage>, or a local path."""
    if model_uri.startswith("runs:/"):
        rest = model_uri[len("runs:/"):]
        run_id, _, sub = rest.partition("/")
        d = _store.find_run(run_id)
        if d is None:
            raise ValueError(f"run {run_id!r} not found")
        return os.path.join(d, "artifacts", sub)
    if model_uri.startswith("models:/"):
        rest = model_uri[len("models:/"):]
        name, _, selector = rest.partition("/")
        versions = _store.list_model_versions(name)
        if not versions:
            raise ValueError(f"registered model {name!r} has no versions")
        if selector and selector.isdigit():
            pick = next((v for v in versions if str(v["version"]) == selector),
                        None)
        elif selector:  # stage name
            staged = [v for v in versions if v["current_stage"] == selector]
            pick = staged[-1] if staged else None
        else:
            pick = versions[-1]
        if pick is None:
            raise ValueError(f"no version of {name!r} matches {selector!r}")
        return os.path.join(_store.model_dir(name), "versions",
                            str(pick["version"]), "model")
    return model_uri


def _columns_of(data) -> tuple:
    """(column names, {name: column array}) of a port DataFrame, a
    mapping of columns, a pandas frame (read with no pandas import) or
    a 1-D / 2-D array (columns 0..k-1, as pandas names an array's)."""
    from ..frame.dataframe import DataFrame
    from ..frame.session import column_array
    if isinstance(data, DataFrame):
        block = data._whole()
        return data.columns, block
    if isinstance(data, Mapping):
        block = {str(c): column_array(v) for c, v in data.items()}
        return list(block), block
    if hasattr(data, "columns"):
        from ..frame._pandas import block_from_pandas
        block = block_from_pandas(data)
        return list(block), block
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr[:, None]
    block = {str(j): arr[:, j] for j in range(arr.shape[1])}
    return list(range(arr.shape[1])), block


def _json_value(v):
    """A cell as JSON holds it: numpy scalars as Python numbers, a vector
    as a list, NaN as null (pandas' writer)."""
    if isinstance(v, np.ndarray):
        return [_json_value(x) for x in v.tolist()]
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        return None
    return v


def _write_input_example(example, path: str) -> None:
    """`input_example.json` in pandas' `orient="split"` layout:
    {"columns": [...], "index": [0..n-1], "data": [[row], ...]}."""
    names, block = _columns_of(example)
    cols = [block[str(c)] for c in names]
    n = len(cols[0]) if cols else 0
    data = [[_json_value(c[i]) for c in cols] for i in range(n)]
    with open(path, "w") as f:
        json.dump({"columns": names, "index": list(range(n)), "data": data},
                  f, separators=(",", ":"))


def _log_model_dir(artifact_path: str, save_fn, registered_model_name=None,
                   signature=None, input_example=None, flavor="sml") -> str:
    run = _require_run()
    out = os.path.join(_store.run_dir(run.info.experiment_id, run.info.run_id),
                       "artifacts", artifact_path)
    os.makedirs(out, exist_ok=True)
    save_fn(out)
    meta = {"flavor": flavor, "run_id": run.info.run_id}
    if signature is not None:
        meta["signature"] = signature.to_dict()
    _store._write_json(os.path.join(out, "MLmodel.json"), meta)
    if input_example is not None:
        _write_input_example(input_example,
                             os.path.join(out, "input_example.json"))
    if registered_model_name:
        register_model(f"runs:/{run.info.run_id}/{artifact_path}",
                       registered_model_name)
    return out


class _SparkFlavor:
    """Flavor for a port PipelineModel / any `ml.base.Saveable`: the
    model's directory in the format both packages load, under
    `native/`."""

    @staticmethod
    def log_model(model, artifact_path: str, signature=None,
                  input_example=None, registered_model_name=None, **kw):
        return _log_model_dir(
            artifact_path, lambda d: model._save_to(os.path.join(d, "native")),
            registered_model_name=registered_model_name, signature=signature,
            input_example=input_example, flavor="spark")

    @staticmethod
    def save_model(model, path: str):
        model._save_to(os.path.join(path, "native"))
        _store._write_json(os.path.join(path, "MLmodel.json"),
                           {"flavor": "spark"})

    @staticmethod
    def load_model(model_uri: str):
        from ..ml.base import load
        return load(os.path.join(_resolve_model_uri(model_uri), "native"))


class _SklearnFlavor:
    """Any object with a `predict`, pickled."""

    @staticmethod
    def log_model(model, artifact_path: str, signature=None,
                  input_example=None, registered_model_name=None, **kw):
        def save(d):
            with open(os.path.join(d, "model.pkl"), "wb") as f:
                pickle.dump(model, f)
        return _log_model_dir(artifact_path, save,
                              registered_model_name=registered_model_name,
                              signature=signature, input_example=input_example,
                              flavor="sklearn")

    @staticmethod
    def save_model(model, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model.pkl"), "wb") as f:
            pickle.dump(model, f)
        _store._write_json(os.path.join(path, "MLmodel.json"),
                           {"flavor": "sklearn"})

    @staticmethod
    def load_model(model_uri: str):
        path = _resolve_model_uri(model_uri)
        with open(os.path.join(path, "model.pkl"), "rb") as f:
            return pickle.load(f)


class PyFuncModel:
    """Uniform `predict` over any logged flavor. It takes a port
    DataFrame, a pandas frame or a mapping of column name to values.

    A native model whose last stage is a tree ensemble or a linear model
    scores through `DeviceScorer.__call__` on the session's device
    (`sml.device`); any other native model through its `transform`,
    returning the `prediction` column. The route is read from the
    model's type when it loads. A pickled (sklearn-flavor) model gets the
    columns as one 2-D array, in column order."""

    def __init__(self, path: str):
        self._path = path
        self.metadata = types.SimpleNamespace(
            **_store._read_json(os.path.join(path, "MLmodel.json")))
        flavor = getattr(self.metadata, "flavor", "sklearn")
        self._scorer = None
        if flavor == "spark" or os.path.isdir(os.path.join(path, "native")):
            from ..ml.base import load
            from ..ml.inference import DeviceScorer
            self._native = load(os.path.join(path, "native"))
            self._kind = "scorer" if DeviceScorer.supports(self._native) \
                else "transform"
        else:
            with open(os.path.join(path, "model.pkl"), "rb") as f:
                self._native = pickle.load(f)
            self._kind = "sklearn"

    def predict(self, data) -> np.ndarray:
        if self._kind == "sklearn":
            names, block = _columns_of(data)
            X = np.column_stack([block[str(c)] for c in names])
            return np.asarray(self._native.predict(X))
        if self._kind == "scorer":
            if self._scorer is None:
                from ..device import session_device
                from ..ml.inference import DeviceScorer
                self._scorer = DeviceScorer(self._native,
                                            device=session_device())
            return self._scorer(data)
        from ..frame.dataframe import DataFrame
        from ..frame.session import get_session
        df = data if isinstance(data, DataFrame) \
            else get_session().createDataFrame(
                data if hasattr(data, "columns") else dict(data))
        out = self._native.transform(df)
        col = "prediction" if "prediction" in out.columns else out.columns[-1]
        return out.select(col)._whole()[col]

    def unwrap_python_model(self):
        return self._native


class _PyfuncFlavor:
    @staticmethod
    def load_model(model_uri: str) -> PyFuncModel:
        return PyFuncModel(_resolve_model_uri(model_uri))

    @staticmethod
    def spark_udf(session, model_uri: str, result_type: str = "double"):
        """Column function for batch scoring (`ML 09:80-81`, `Solutions/
        Labs/ML 12L`): `df.withColumn("pred", predict(*df.columns))`.
        Each partition's argument columns reach the model as a mapping
        of column name to block."""
        model = PyFuncModel(_resolve_model_uri(model_uri))
        from ..frame.column import Column, ensure_column

        def udf(*cols):
            cols = [ensure_column(c) for c in cols]

            def ev(block, ctx):
                data = {c._name: c._eval(block, ctx) for c in cols}
                return np.asarray(model.predict(data), dtype=np.float64)

            return Column(ev, "prediction")

        return udf


spark = _SparkFlavor()
sklearn = _SklearnFlavor()
pyfunc = _PyfuncFlavor()


# --------------------------------------------------------------------- search
def _match_filter(rec: Dict[str, Any], filter_string: Optional[str]) -> bool:
    if not filter_string:
        return True
    for clause in re.split(r"\s+and\s+", filter_string, flags=re.I):
        m = re.match(r"\s*(params|metrics|tags|attributes)\."
                     r"(\"[^\"]+\"|[\w.]+)"
                     r"\s*(=|!=|>=|<=|>|<|LIKE)\s*(.+?)\s*$", clause, re.I)
        if not m:
            raise ValueError(f"cannot parse filter clause {clause!r}")
        kind, key, op, val = m.groups()
        key = key.strip('"')
        val = val.strip().strip("'").strip('"')
        bucket = rec["meta"] if kind == "attributes" else rec[kind]
        have = bucket.get(key)
        if have is None:
            return False
        if kind == "metrics":
            have, val = float(have), float(val)
        else:
            have = str(have)
        if op.upper() == "LIKE":
            ok = isinstance(have, str) and val.replace("%", "") in have
        else:
            ok = {"=": have == val, "!=": have != val,
                  ">": have > val, "<": have < val,
                  ">=": have >= val, "<=": have <= val}[op]
        if not ok:
            return False
    return True


def _sorted_recs(recs, order_by: Optional[List[str]]):
    if not order_by:
        return recs
    for clause in reversed(order_by):
        parts = clause.split()
        key = parts[0]
        desc = len(parts) > 1 and parts[1].upper() == "DESC"
        kind, _, name = key.partition(".")

        def sort_key(r, kind=kind, name=name):
            if kind == "attributes":
                return r["meta"].get(name) or 0
            v = r.get(kind, {}).get(name)
            return (v is None, v)

        recs = sorted(recs, key=sort_key, reverse=desc)
    return recs


def _runs_frame(recs):
    """The runs as a port DataFrame: one row a run, the columns in order
    of first appearance (run_id, experiment_id, status, start_time,
    end_time, artifact_uri, then params.*, metrics.*, tags.*), NULL where
    a run lacks a key; each column typed as pandas types a list."""
    from ..frame.session import get_session
    rows = []
    for r in recs:
        row = {"run_id": r["meta"]["run_id"],
               "experiment_id": r["meta"]["experiment_id"],
               "status": r["meta"].get("status"),
               "start_time": r["meta"].get("start_time"),
               "end_time": r["meta"].get("end_time"),
               "artifact_uri": r["meta"].get("artifact_uri")}
        for kind in ("params", "metrics", "tags"):
            for k, v in r[kind].items():
                row[f"{kind}.{k}"] = v
        rows.append(row)
    names: Dict[str, None] = {}
    for row in rows:
        names.update(dict.fromkeys(row))
    return get_session().createDataFrame(
        {c: [row.get(c) for row in rows] for c in names})


def search_runs(experiment_ids=None, filter_string: Optional[str] = None,
                order_by: Optional[List[str]] = None,
                max_results: int = 1000, output_format: str = "frame"):
    """The runs of `experiment_ids` that pass `filter_string`, sorted by
    `order_by`: a port DataFrame, or with output_format="list" a list
    of `Run`."""
    if experiment_ids is None:
        experiment_ids = [_current_experiment_id()]
    if isinstance(experiment_ids, str):
        experiment_ids = [experiment_ids]
    recs = []
    for e in experiment_ids:
        recs.extend(_store.list_runs(e))
    recs = [r for r in recs if _match_filter(r, filter_string)]
    recs = _sorted_recs(recs, order_by)[:max_results]
    if output_format == "list":
        return [Run(r["meta"], r["params"], r["metrics"], r["tags"])
                for r in recs]
    return _runs_frame(recs)


def register_model(model_uri: str, name: str):
    src = _resolve_model_uri(model_uri)
    run_id = None
    if model_uri.startswith("runs:/"):
        run_id = model_uri[len("runs:/"):].partition("/")[0]
    meta = _store.create_model_version(name, src, run_id=run_id)
    return types.SimpleNamespace(**meta)


# --------------------------------------------------------------------- client
class MlflowClient:
    """The `MlflowClient` query and registry surface (`ML 04:196-228`,
    `ML 05:134-331`)."""

    def __init__(self, tracking_uri: Optional[str] = None):
        if tracking_uri:
            set_tracking_uri(tracking_uri)

    # tracking ----------------------------------------------------------
    def create_experiment(self, name: str) -> str:
        return _store.get_or_create_experiment(name)["experiment_id"]

    def get_experiment(self, experiment_id: str):
        meta = _store.get_experiment(experiment_id)
        return types.SimpleNamespace(**meta) if meta else None

    def get_experiment_by_name(self, name: str):
        for e in _store.list_experiments():
            if e["name"] == name:
                return types.SimpleNamespace(**e)
        return None

    def search_experiments(self):
        return [types.SimpleNamespace(**e) for e in _store.list_experiments()]

    list_experiments = search_experiments

    def get_run(self, run_id: str) -> Run:
        return get_run(run_id)

    def search_runs(self, experiment_ids, filter_string=None, order_by=None,
                    max_results=1000):
        return search_runs(experiment_ids, filter_string=filter_string,
                           order_by=order_by, max_results=max_results,
                           output_format="list")

    def list_artifacts(self, run_id: str, path: Optional[str] = None):
        d = _store.find_run(run_id)
        base = os.path.join(d, "artifacts", path or "")
        out = []
        for root, _dirs, files in os.walk(base):
            for f in files:
                rel = os.path.relpath(os.path.join(root, f),
                                      os.path.join(d, "artifacts"))
                out.append(types.SimpleNamespace(path=rel, is_dir=False))
        return out

    def set_tag(self, run_id: str, key: str, value) -> None:
        d = _store.find_run(run_id)
        rec = _store.read_run(d)
        _store.log_kv(rec["meta"]["experiment_id"], run_id, "tags", key, value)

    # registry ----------------------------------------------------------
    def create_registered_model(self, name: str, description: str = ""):
        return types.SimpleNamespace(
            **_store.create_registered_model(name, description))

    def get_registered_model(self, name: str):
        meta = _store.get_registered_model(name)
        if meta is None:
            raise ValueError(f"registered model {name!r} not found")
        ns = types.SimpleNamespace(**meta)
        ns.latest_versions = [types.SimpleNamespace(**v)
                              for v in _store.list_model_versions(name)]
        return ns

    def update_registered_model(self, name: str, description: str = ""):
        return types.SimpleNamespace(
            **_store.update_registered_model(name, description))

    def create_model_version(self, name: str, source: str, run_id=None,
                             description: str = ""):
        return types.SimpleNamespace(
            **_store.create_model_version(name, source, run_id, description))

    def get_model_version(self, name: str, version):
        meta = _store.get_model_version(name, version)
        if meta is None:
            raise ValueError(f"model version {name}/{version} not found")
        return types.SimpleNamespace(**meta)

    def update_model_version(self, name: str, version, description: str = ""):
        return types.SimpleNamespace(
            **_store.update_model_version(name, version, description))

    def transition_model_version_stage(
            self, name: str, version, stage: str,
            archive_existing_versions: bool = False):
        return types.SimpleNamespace(**_store.set_version_stage(
            name, version, stage, archive_existing_versions))

    def get_latest_versions(self, name: str,
                            stages: Optional[List[str]] = None):
        versions = _store.list_model_versions(name)
        if stages:
            by_stage = {}
            for v in versions:
                if v["current_stage"] in stages:
                    by_stage[v["current_stage"]] = v
            return [types.SimpleNamespace(**v) for v in by_stage.values()]
        return [types.SimpleNamespace(**v) for v in versions[-1:]]

    def search_model_versions(self, filter_string: str):
        m = re.match(r"\s*name\s*=\s*'([^']+)'", filter_string)
        if not m:
            raise ValueError(f"unsupported filter {filter_string!r}")
        return [types.SimpleNamespace(**v)
                for v in _store.list_model_versions(m.group(1))]

    def delete_model_version(self, name: str, version) -> None:
        _store.delete_model_version(name, version)

    def delete_registered_model(self, name: str) -> None:
        _store.delete_registered_model(name)


# -------------------------------------------------------------------- autolog
class _AutologState:
    enabled = False
    log_models = True


def autolog(log_models: bool = True, disable: bool = False, **kw) -> None:
    _AutologState.enabled = not disable
    _AutologState.log_models = log_models


class _PysparkMLNamespace:
    autolog = staticmethod(autolog)


class _PysparkNamespace:
    ml = _PysparkMLNamespace()


pyspark = _PysparkNamespace()


# `mlflow.tracking.MlflowClient` parity: the module aliases itself as its
# own `tracking` submodule (`ML 04:196`, `ML 05` use both spellings)
tracking = sys.modules[__name__]


def install_mlflow_shim() -> None:
    """Alias this module as `mlflow` so course code imports run unchanged
    (a name already in sys.modules keeps its module)."""
    mod = sys.modules[__name__]
    sys.modules.setdefault("mlflow", mod)
    sys.modules.setdefault("mlflow.tracking", mod)
    sys.modules.setdefault("mlflow.spark", spark)   # type: ignore[arg-type]
    sys.modules.setdefault("mlflow.sklearn", sklearn)  # type: ignore[arg-type]
    sys.modules.setdefault("mlflow.pyfunc", pyfunc)  # type: ignore[arg-type]


__all__ = ["start_run", "end_run", "active_run", "log_param", "log_params",
           "log_metric", "log_metrics", "log_engine_metrics",
           "log_artifact", "log_artifacts",
           "log_figure", "log_text", "log_dict", "set_tag", "set_tags",
           "set_experiment", "set_tracking_uri", "get_tracking_uri",
           "get_run", "search_runs", "register_model", "infer_signature",
           "MlflowClient", "spark", "sklearn", "pyfunc", "pyspark",
           "autolog", "install_mlflow_shim", "ModelSignature", "PyFuncModel"]
