"""File-based tracking store (runs, params, metrics, artifacts, registry).

The port's copy of `sml_tpu/tracking/_store.py`, byte-compatible with
it on disk, so either package reads a store the other wrote. The
reference logs through MLflow (`SML/ML 04 - MLflow Tracking.py:70-228`,
registry `SML/ML 05 - MLflow Model Registry.py`); this store keeps the
same data model on the local filesystem:

    <root>/experiments/<exp_id>/meta.json
    <root>/experiments/<exp_id>/<run_id>/{meta,params,metrics,tags}.json
    <root>/experiments/<exp_id>/<run_id>/artifacts/...
    <root>/registry/<name>/meta.json
    <root>/registry/<name>/versions/<v>/{meta.json, model/...}

Writes are atomic (tmp+rename) so concurrent trial threads can't tear
JSON files.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional
from ..utils.profiler import PROFILER, wallclock

_lock = threading.RLock()
_tracking_root: Optional[str] = None

DEFAULT_DIRNAME = "smlruns"


def set_tracking_uri(path: str) -> None:
    global _tracking_root
    with _lock:
        _tracking_root = path.replace("file://", "")


def get_tracking_uri() -> str:
    global _tracking_root
    with _lock:
        if _tracking_root is None:
            _tracking_root = os.environ.get(
                "SML_TRACKING_DIR", os.path.join(os.getcwd(), DEFAULT_DIRNAME))
        os.makedirs(_tracking_root, exist_ok=True)
        return _tracking_root


def _write_json(path: str, obj: Any) -> None:
    tmp = f"{path}.tmp{os.getpid()}{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=str)
    os.replace(tmp, path)


def _read_json(path: str, default=None):
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {} if default is None else default


def new_id() -> str:
    return uuid.uuid4().hex


# ----------------------------------------------------------------- experiments
def experiments_dir() -> str:
    d = os.path.join(get_tracking_uri(), "experiments")
    os.makedirs(d, exist_ok=True)
    return d


def get_or_create_experiment(name: str) -> Dict[str, Any]:
    with _lock:
        for exp in list_experiments():
            if exp["name"] == name:
                return exp
        exp_id = new_id()[:12]
        meta = {"experiment_id": exp_id, "name": name,
                "creation_time": wallclock(), "lifecycle_stage": "active"}
        d = os.path.join(experiments_dir(), exp_id)
        os.makedirs(d, exist_ok=True)
        _write_json(os.path.join(d, "meta.json"), meta)
        return meta


def get_experiment(exp_id: str) -> Optional[Dict[str, Any]]:
    meta = _read_json(os.path.join(experiments_dir(), exp_id, "meta.json"))
    return meta or None


def list_experiments() -> List[Dict[str, Any]]:
    out = []
    for e in sorted(os.listdir(experiments_dir())):
        meta = _read_json(os.path.join(experiments_dir(), e, "meta.json"))
        if meta:
            out.append(meta)
    return out


def default_experiment() -> Dict[str, Any]:
    return get_or_create_experiment("Default")


# ----------------------------------------------------------------------- runs
def run_dir(exp_id: str, run_id: str) -> str:
    return os.path.join(experiments_dir(), exp_id, run_id)


def find_run(run_id: str) -> Optional[str]:
    """Locate a run's directory by id across experiments."""
    for e in os.listdir(experiments_dir()):
        d = run_dir(e, run_id)
        if os.path.isdir(d):
            return d
    return None


def create_run(exp_id: str, run_name: Optional[str] = None,
               tags: Optional[Dict[str, str]] = None,
               parent_run_id: Optional[str] = None) -> Dict[str, Any]:
    run_id = new_id()
    d = run_dir(exp_id, run_id)
    os.makedirs(os.path.join(d, "artifacts"), exist_ok=True)
    meta = {"run_id": run_id, "experiment_id": exp_id,
            "run_name": run_name or f"run-{run_id[:8]}",
            "status": "RUNNING", "start_time": wallclock(), "end_time": None,
            "artifact_uri": os.path.join(d, "artifacts")}
    _write_json(os.path.join(d, "meta.json"), meta)
    t = dict(tags or {})
    if run_name:
        t["mlflow.runName"] = run_name
    if parent_run_id:
        t["mlflow.parentRunId"] = parent_run_id
    _write_json(os.path.join(d, "tags.json"), t)
    _write_json(os.path.join(d, "params.json"), {})
    _write_json(os.path.join(d, "metrics.json"), {})
    return meta


def end_run(exp_id: str, run_id: str, status: str = "FINISHED") -> None:
    d = run_dir(exp_id, run_id)
    meta = _read_json(os.path.join(d, "meta.json"))
    meta["status"] = status
    meta["end_time"] = wallclock()
    _write_json(os.path.join(d, "meta.json"), meta)


def log_kv(exp_id: str, run_id: str, kind: str, key: str, value: Any,
           step: Optional[int] = None) -> None:
    with _lock:
        d = run_dir(exp_id, run_id)
        path = os.path.join(d, f"{kind}.json")
        data = _read_json(path)
        if kind == "metrics":
            hist = data.get(key, [])
            hist.append({"value": float(value), "step": step or len(hist),
                         "timestamp": wallclock()})
            data[key] = hist
        else:
            data[key] = str(value) if kind == "params" else value
        _write_json(path, data)


def read_run(d: str) -> Dict[str, Any]:
    meta = _read_json(os.path.join(d, "meta.json"))
    metrics_hist = _read_json(os.path.join(d, "metrics.json"))
    return {
        "meta": meta,
        "params": _read_json(os.path.join(d, "params.json")),
        "metrics": {k: v[-1]["value"] for k, v in metrics_hist.items() if v},
        "metrics_history": metrics_hist,
        "tags": _read_json(os.path.join(d, "tags.json")),
    }


def list_runs(exp_id: str) -> List[Dict[str, Any]]:
    base = os.path.join(experiments_dir(), exp_id)
    out = []
    if not os.path.isdir(base):
        return out
    for r in os.listdir(base):
        d = os.path.join(base, r)
        if os.path.isdir(d) and os.path.exists(os.path.join(d, "meta.json")):
            out.append(read_run(d))
    out.sort(key=lambda r: r["meta"].get("start_time", 0), reverse=True)
    return out


# -------------------------------------------------------------------- registry
def registry_dir() -> str:
    d = os.path.join(get_tracking_uri(), "registry")
    os.makedirs(d, exist_ok=True)
    return d


def model_dir(name: str) -> str:
    return os.path.join(registry_dir(), name)


def get_registered_model(name: str) -> Optional[Dict[str, Any]]:
    meta = _read_json(os.path.join(model_dir(name), "meta.json"))
    return meta or None


def create_registered_model(name: str, description: str = "") -> Dict[str, Any]:
    with _lock:
        existing = get_registered_model(name)
        if existing:
            return existing
        meta = {"name": name, "description": description,
                "creation_timestamp": wallclock(), "latest_version": 0}
        os.makedirs(os.path.join(model_dir(name), "versions"), exist_ok=True)
        _write_json(os.path.join(model_dir(name), "meta.json"), meta)
        return meta


def update_registered_model(name: str, description: str) -> Dict[str, Any]:
    with _lock:
        meta = get_registered_model(name)
        if meta is None:
            raise ValueError(f"registered model {name!r} not found")
        meta["description"] = description
        meta["last_updated_timestamp"] = wallclock()
        _write_json(os.path.join(model_dir(name), "meta.json"), meta)
        return meta


def create_model_version(name: str, source: str, run_id: Optional[str] = None,
                         description: str = "") -> Dict[str, Any]:
    with _lock:
        meta = create_registered_model(name)
        v = int(meta.get("latest_version", 0)) + 1
        meta["latest_version"] = v
        meta["last_updated_timestamp"] = wallclock()
        _write_json(os.path.join(model_dir(name), "meta.json"), meta)
        vd = os.path.join(model_dir(name), "versions", str(v))
        os.makedirs(vd, exist_ok=True)
        if os.path.isdir(source):
            shutil.copytree(source, os.path.join(vd, "model"), dirs_exist_ok=True)
        vmeta = {"name": name, "version": v, "source": source,
                 "run_id": run_id, "current_stage": "None",
                 "status": "READY", "description": description,
                 "creation_timestamp": wallclock()}
        _write_json(os.path.join(vd, "meta.json"), vmeta)
        return vmeta


def get_model_version(name: str, version) -> Optional[Dict[str, Any]]:
    vd = os.path.join(model_dir(name), "versions", str(version))
    meta = _read_json(os.path.join(vd, "meta.json"))
    return meta or None


def list_model_versions(name: str) -> List[Dict[str, Any]]:
    base = os.path.join(model_dir(name), "versions")
    if not os.path.isdir(base):
        return []
    out = []
    for v in sorted(os.listdir(base), key=lambda s: int(s)):
        meta = _read_json(os.path.join(base, v, "meta.json"))
        if meta:
            out.append(meta)
    return out


# Stage-transition listeners: the serving layer subscribes so an endpoint
# bound to `models:/<name>/<stage>` hot-swaps the moment a promotion lands
# instead of polling the registry. Fired OUTSIDE the store lock (listeners
# re-read the store; an endpoint swap may block briefly on an in-flight
# batch) with (name, version, stage, archived_versions).
_stage_listeners: List[Any] = []


def on_stage_transition(fn) -> None:
    """Register `fn(name, version, stage, archived_versions)` to fire after
    every `set_version_stage` commit. Idempotent per function object."""
    with _lock:
        if fn not in _stage_listeners:
            _stage_listeners.append(fn)


def remove_stage_listener(fn) -> None:
    with _lock:
        try:
            _stage_listeners.remove(fn)
        except ValueError:
            pass


def set_version_stage(name: str, version, stage: str,
                      archive_existing_versions: bool = False) -> Dict[str, Any]:
    """Move a version to `stage`. With `archive_existing_versions=True`
    (MLflow's promote semantics) every OTHER version currently holding the
    target stage moves to "Archived" in the same locked commit, so readers
    never observe two Production holders. The target version is validated
    BEFORE anything is archived — a bad version id must not half-apply the
    transition (the pre-fix order archived the incumbents and then raised,
    leaving the stage empty)."""
    archived: List[Any] = []
    with _lock:
        vd = os.path.join(model_dir(name), "versions", str(version))
        meta = _read_json(os.path.join(vd, "meta.json"))
        if not meta:
            raise ValueError(f"model version {name}/{version} not found")
        if archive_existing_versions:
            for other in list_model_versions(name):
                if other["current_stage"] == stage and \
                        str(other["version"]) != str(version):
                    other["current_stage"] = "Archived"
                    other["last_transition_timestamp"] = wallclock()
                    od = os.path.join(model_dir(name), "versions",
                                      str(other["version"]))
                    _write_json(os.path.join(od, "meta.json"), other)
                    archived.append(other["version"])
        meta["current_stage"] = stage
        meta["last_transition_timestamp"] = wallclock()
        _write_json(os.path.join(vd, "meta.json"), meta)
        listeners = list(_stage_listeners)
    for fn in listeners:  # outside the lock: listeners re-read the store
        try:
            fn(name, meta["version"], stage, list(archived))
        except Exception:  # noqa: BLE001 — listener hygiene: the commit
            # already landed; one raising listener (a half-closed
            # endpoint, a torn subscriber) must neither prevent LATER
            # listeners from observing the transition nor bubble into
            # the promoter, leaving the stage move half-observed.
            # Counted (like serve.canary_error) so a dead subscriber is
            # visible in the engine counters instead of silent
            PROFILER.count("tracking.listener_error")
    return meta


def resolve_stage(name: str, stage: str) -> Optional[Dict[str, Any]]:
    """The version meta a stage alias ("Production"/"Staging") currently
    resolves to: the LATEST READY version holding that stage, or None.
    The lookup the serving endpoint performs at bind time and again on
    every transition event."""
    picked = None
    for v in list_model_versions(name):
        if v.get("current_stage") == stage and v.get("status") == "READY":
            picked = v
    return picked


def update_model_version(name: str, version, description: str) -> Dict[str, Any]:
    with _lock:
        vd = os.path.join(model_dir(name), "versions", str(version))
        meta = _read_json(os.path.join(vd, "meta.json"))
        if not meta:
            raise ValueError(f"model version {name}/{version} not found")
        meta["description"] = description
        _write_json(os.path.join(vd, "meta.json"), meta)
        return meta


def delete_model_version(name: str, version) -> None:
    vd = os.path.join(model_dir(name), "versions", str(version))
    shutil.rmtree(vd, ignore_errors=True)


def delete_registered_model(name: str) -> None:
    shutil.rmtree(model_dir(name), ignore_errors=True)
