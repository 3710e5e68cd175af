"""Prewarm manifest: pay a process's first calls before its first request.

The port's copy of `sml_tpu/parallel/prewarm.py`. Eager torch compiles
nothing per shape, but a fresh process still pays at its first calls:
each kernel library's load and its module's first launch, the caching
allocator's first blocks, and the first cuBLAS and cuSOLVER calls'
handle set-up.

- RECORDING (always on): every kernel launch through
  `native/build.launch_on_stream` whose wrapper passes a signature, and
  every bin matrix `DeviceScorer` stages, records a replayable entry: the
  kernel, its operand shapes and dtypes (and the wrapper's scalar
  arguments), and the launch plan it resolved to, into
  `prewarm_manifest.json` in `sml.compile.cacheDir` (else
  `sml_tpu_torch/native/build/`). The row count is bucketed
  (`replay_rows`): rounded up to a power of two and capped at
  `REPLAY_ROWS`, so a server's many batch sizes make a handful of
  entries and no entry replays a large fit's operands. An
  entry is keyed by the card's name, the device count and the mesh of
  ranks it ran over (its data width and host groups; [1, 1] without
  one), as the JAX package keys it by its mesh. Recording is a set lookup in memory; the
  manifest is written at exit and on `flush()`, never from a launch, and
  a write MERGES with the file on disk under a file lock, so processes
  sharing a manifest add to it rather than overwrite each other.

- REPLAY (opt-in, `sml.prewarm.enabled`, or a direct `prewarm()` call):
  loads each recorded kernel library, runs the set-up the path's first
  calls pay (a cuBLAS and a cuSOLVER handle, the dispatcher's
  calibration of the card), and makes each recorded launch once on zero
  operands of the recorded shapes (each staging once), from a
  `sml.prewarm.workers`-wide thread pool. An entry recorded on another
  card, under another device count or over another mesh, is skipped, as
  the JAX package skips a mesh that does not match.

`speculative_prewarm(fn, shapes)` first-calls a scoring function on
zero blocks of declared shapes (the load harness's width mix,
`loadgen.prewarm_widths`) instead of the manifest.

Each replay is its own trace and holds a watchdog ticket; `prewarm.*`
counters and events go to the profiler and the flight recorder. A replay
that fails is counted, and `prewarm()` raises the first failure once the
pool has finished: a failed build or launch is never hidden. A
background replay (`maybe_prewarm`) keeps its outcome, error included,
in `status()`, which a serving endpoint's `health_report` carries.
"""

from __future__ import annotations

import atexit
import fcntl
import hashlib
import importlib
import json
import os
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..conf import GLOBAL_CONF, _register, _to_bool
from ..obs import _context as _trace
from ..obs._recorder import RECORDER as _OBS
from ..obs._watchdog import WATCHDOG as _WATCHDOG
from ..utils.profiler import PROFILER, now as _now

_register("sml.prewarm.enabled", False, _to_bool,
          "Replay the prewarm manifest when a serving endpoint opens: load "
          "every recorded kernel library, set up cuBLAS and cuSOLVER, and "
          "make every recorded launch once on zero operands, from a "
          "background thread pool (sml.prewarm.workers wide), so a fresh "
          "process's first calls are paid before its first request. "
          "Recording into the manifest is always on; this key gates only "
          "the replay")
_register("sml.prewarm.workers", 4, int,
          "Thread-pool width of the manifest replay")

_MANIFEST_VERSION = 2
_MANIFEST_NAME = "prewarm_manifest.json"
#: entries a manifest keeps at most: a new signature past it is counted
#: (`prewarm.manifest_full`) and dropped
MAX_ENTRIES = 1024
#: the most rows a recorded launch or staging replays (row counts are
#: rounded up to a power of two, then capped here)
REPLAY_ROWS = 65536
_lock = threading.Lock()
_state: Dict[str, Any] = {"path": None, "entries": None, "dirty": False}
_seen: set = set()
#: raw launch signatures seen (shapes before bucketing): a launch's
#: check, one set lookup; cleared when full, which only costs a
#: re-bucketing
_raw_seen: set = set()
_RAW_MAX = 65536
_tls = threading.local()  # replay re-entrancy guard
#: replay guard, keyed per (manifest path, device signature): a second
#: endpoint in the process shares the first one's warm state
_ran: Dict[Any, bool] = {}
#: the outcome of the process's last replay (`status()`)
_status: Dict[str, Any] = {"state": "idle", "stats": None, "error": None}


class _Kernel(NamedTuple):
    module: str                     # the wrapper's module
    wrapper: str                    # the wrapper's name
    source: str                     # the kernel library's source
    row_operands: Tuple[int, ...]   # operands whose dim 0 is the rows
    row_scalars: Tuple[str, ...]    # keyword arguments that hold the rows
    #                                 (an int count, or a tensor of dim 0
    #                                 rows; a float or None is kept)


_KERNELS = {
    "forest_traverse": _Kernel("sml_tpu_torch.native.traverse_kernel",
                               "forest_traverse", "forest_traverse", (0,),
                               ("init",)),
    "hist_accumulate": _Kernel("sml_tpu_torch.native.hist_kernel",
                               "hist_accumulate", "hist_accumulate",
                               (0, 1, 2, 3, 4), ()),
    "split_scan": _Kernel("sml_tpu_torch.native.hist_kernel", "split_scan",
                          "split_scan", (), ()),
    "row_weights": _Kernel("sml_tpu_torch.native.prng_kernel",
                           "fit_row_weights", "threefry", (), ("n_pad",)),
    "feature_mask": _Kernel("sml_tpu_torch.native.prng_kernel",
                            "fit_feature_masks", "threefry", (), ()),
}


def replay_rows(n: int) -> int:
    """The rows a recording of an n-row launch or staging replays: n
    rounded up to a power of two, at most `REPLAY_ROWS`."""
    n = int(n)
    return min(1 << max(n - 1, 0).bit_length(), REPLAY_ROWS) if n else 0


def _mesh_signature(device) -> list:
    """[data width, host groups] of the mesh of ranks a program on
    `device` runs over (`dispatch.mesh_for`); [1, 1] without one."""
    from .dispatch import mesh_for
    mesh = mesh_for(torch.device(device))
    if mesh is None:
        return [1, 1]
    return [mesh.size, mesh.hosts or 1]


def device_signature(device) -> list:
    """[card name, device count, mesh data width, mesh host groups] of a
    CUDA device; ["cpu", 1, width, groups] for the CPU: what must match
    for a recorded entry to replay."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return [torch.cuda.get_device_name(index),
                torch.cuda.device_count()] + _mesh_signature(dev)
    return [dev.type, 1] + _mesh_signature(dev)


def manifest_path() -> str:
    """`prewarm_manifest.json` in `sml.compile.cacheDir`, else beside the
    built kernel libraries (`native/build/`, not committed)."""
    from ..native import build
    d = str(GLOBAL_CONF.get("sml.compile.cacheDir") or "").strip()
    return os.path.join(d or build.BUILD_DIR, _MANIFEST_NAME)


def _load(path: str) -> Dict[str, dict]:
    with _lock:
        if _state["path"] == path and _state["entries"] is not None:
            return _state["entries"]
    entries = _read(path)
    with _lock:
        if _state["path"] != path:
            _flush_locked()  # the old manifest's pending entries first
            _state.update(path=path, entries=entries, dirty=False)
            _seen.clear()
            _raw_seen.clear()
        return _state["entries"]


def _read(path: str) -> Dict[str, dict]:
    """The entries of the manifest on disk ({} when there is none, or it
    is of another version or unreadable)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if doc.get("version") != _MANIFEST_VERSION:
        return {}
    return dict(doc.get("entries", {}))


def _flush_locked() -> None:
    """Merge the unwritten entries into the manifest on disk, under a
    file lock so that processes sharing it add to it instead of
    overwriting each other, and write it atomically (a temporary file
    renamed into place: a process starting meanwhile never reads a torn
    one). Called under `_lock`."""
    path = _state["path"]
    if not _state["dirty"] or path is None:
        return
    mine = _state["entries"] or {}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(f"{path}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            merged = _read(path)
            for key, entry in mine.items():
                if key not in merged and len(merged) < MAX_ENTRIES:
                    merged[key] = entry
            with open(tmp, "w") as f:
                json.dump({"version": _MANIFEST_VERSION, "entries": merged},
                          f, sort_keys=True)
            os.replace(tmp, path)
    except OSError:
        return  # recording is best-effort: it never fails a launch
    _state["entries"] = merged
    _state["dirty"] = False


def flush() -> None:
    """Write the recorded entries that are not on disk yet."""
    with _lock:
        _flush_locked()


atexit.register(flush)


def _spec(shape, dtype) -> list:
    return [list(shape), str(dtype).replace("torch.", "")]


def _entry_key(entry: dict) -> str:
    """An entry's key: everything but the plan it was recorded under
    (the replay's wrapper makes its own plan for the bucketed rows)."""
    meta = {k: v for k, v in entry["meta"].items() if k != "plan"}
    blob = json.dumps(dict(entry, meta=meta), sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def _add(entry: dict) -> None:
    path = manifest_path()
    _load(path)
    key = _entry_key(entry)
    with _lock:
        entries = _state["entries"]
        if _state["path"] != path or entries is None or key in entries:
            return
        full = len(entries) >= MAX_ENTRIES
        if not full:
            entries[key] = entry
            _state["dirty"] = True
    if full:
        PROFILER.count("prewarm.manifest_full")
    else:
        PROFILER.count("prewarm.recorded")


def _bucketed(shape, rows: bool) -> tuple:
    if rows and shape:
        return (replay_rows(shape[0]),) + tuple(shape[1:])
    return tuple(shape)


def record_launch(device, kernel: str, plan, tensors: List[torch.Tensor],
                  scalars: Optional[dict] = None) -> None:
    """Record one kernel launch: `kernel` (a key of `_KERNELS`), its plan
    (a NamedTuple or None), the wrapper's tensor operands in its
    positional order and its scalar (or tensor) keyword arguments, the
    rows bucketed (`replay_rows`). A signature seen before in this
    process costs one set lookup of its raw shapes."""
    if getattr(_tls, "replaying", False):
        return  # a replay must not re-record its own entries
    scalars = scalars or {}
    mesh = tuple(_mesh_signature(device))
    raw = (kernel, device, mesh, tuple([t.shape for t in tensors]),
           tuple([t.dtype for t in tensors]),
           tuple([(k, (v.shape, v.dtype) if isinstance(v, torch.Tensor)
                   else v) for k, v in scalars.items()]))
    if raw in _raw_seen:
        return
    if len(_raw_seen) >= _RAW_MAX:
        _raw_seen.clear()
    _raw_seen.add(raw)
    spec = _KERNELS[kernel]
    operands = tuple((_bucketed(t.shape, i in spec.row_operands), t.dtype)
                     for i, t in enumerate(tensors))
    args = []
    for k, v in sorted(scalars.items()):
        rows = k in spec.row_scalars
        if isinstance(v, torch.Tensor):
            args.append((k, "tensor", _bucketed(v.shape, rows), v.dtype))
        elif rows and isinstance(v, int):  # a row count, not a number
            args.append((k, replay_rows(v)))  # such as traversal's init
        else:
            args.append((k, v))
    fast = (kernel, device, mesh, operands, tuple(args))
    with _lock:
        if fast in _seen:
            return
        _seen.add(fast)
    meta = {"operands": [_spec(*o) for o in operands],
            "scalars": {a[0]: ({"tensor": _spec(a[2], a[3])}
                               if len(a) == 4 else a[1]) for a in args},
            "plan": None if plan is None else dict(plan._asdict())}
    _add({"kind": "launch", "kernel": kernel, "meta": meta,
          "device": device_signature(device)})


def record_stage(device, shape, dtype) -> None:
    """Record one staging copy of a bin matrix onto `device`
    (`DeviceScorer`'s), its rows bucketed."""
    if getattr(_tls, "replaying", False):
        return
    shape = _bucketed(shape, True)
    fast = ("stage", device, tuple(_mesh_signature(device)), shape, dtype)
    with _lock:
        if fast in _seen:
            return
        _seen.add(fast)
    _add({"kind": "stage", "kernel": None,
          "meta": {"shape": list(shape), "dtype": str(np.dtype(dtype))},
          "device": device_signature(device)})


def entries() -> Dict[str, dict]:
    """The manifest's entries (a copy)."""
    return dict(_load(manifest_path()))


def _zeros(spec: list, device) -> torch.Tensor:
    shape, dtype = spec
    return torch.zeros(shape, dtype=getattr(torch, dtype), device=device)


def _replay_launch(entry: dict, device) -> None:
    spec = _KERNELS[entry["kernel"]]
    wrapper = getattr(importlib.import_module(spec.module), spec.wrapper)
    meta = entry["meta"]
    args = [_zeros(s, device) for s in meta["operands"]]
    kwargs = {k: (_zeros(v["tensor"], device) if isinstance(v, dict)
                  else v) for k, v in meta["scalars"].items()}
    wrapper(*args, **kwargs)


def _replay_stage(entry: dict, device) -> None:
    meta = entry["meta"]
    host = np.zeros(meta["shape"], dtype=np.dtype(meta["dtype"]))
    torch.from_numpy(host).to(device, copy=True)


_REPLAYS: Dict[str, Callable[[dict, Any], None]] = {
    "launch": _replay_launch, "stage": _replay_stage}


def _replay_one(entry: dict, device, stats: dict, stats_lock,
                errors: list) -> None:
    _tls.replaying = True
    t0 = _now()
    ok = True
    # each replay is its own trace; a wedged replay is a watchdog ticket
    ctx = _trace.new_trace()
    name = entry["kernel"] or entry["kind"]
    try:
        with _trace.activate(ctx), \
                _WATCHDOG.watch("prewarm", f"prewarm.{name}", trace=ctx):
            _REPLAYS[entry["kind"]](entry, device)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
    except Exception as e:  # noqa: BLE001 — counted, and raised by prewarm
        ok = False
        errors.append(e)
    finally:
        _tls.replaying = False
    dt = _now() - t0
    with stats_lock:
        stats["replayed" if ok else "failed"] += 1
        stats["serial_s"] += dt
    if ok:
        PROFILER.count("prewarm.replayed")
    else:
        PROFILER.count("prewarm.failed")
    if _OBS.enabled:
        args = {"kind": name, "ok": ok, "seconds": round(dt, 4)}
        if ctx is not None:
            args["trace"] = ctx.trace_id
        _OBS.emit("prewarm", "prewarm.replay", args=args)


def _setup(device, sources: List[str]) -> None:
    """On the card: load the recorded kernels' libraries, make the first
    cuBLAS and cuSOLVER calls (their handles are created there) and take
    the dispatcher's calibration (the first routed call's). On the CPU
    the wrappers run their plain versions: nothing to load."""
    if device.type != "cuda":
        return
    from ..native import build
    from . import dispatch
    for src in sources:
        build.load(src)
    a = torch.eye(8, dtype=torch.float32, device=device)
    (a @ a).sum().item()
    torch.linalg.cholesky(a.double()).sum().item()
    dispatch.CALIBRATION.ensure(device)


def prewarm(device=None, workers: Optional[int] = None) -> dict:
    """Replay every manifest entry recorded on this device's signature.
    Returns {programs, replayed, failed, skipped, setup_s, wall_s,
    serial_s}: serial_s is what the replays would cost one at a time.
    Raises the first replay's error after the pool has finished."""
    from ..device import resolve_device
    device = resolve_device(device)
    path = manifest_path()
    sig = device_signature(device)
    with _lock:
        _ran[(path, tuple(sig))] = True
    recorded = _load(path)
    todo = [e for e in recorded.values()
            if e.get("device") == sig and e.get("kind") in _REPLAYS
            and (e["kind"] != "launch" or e.get("kernel") in _KERNELS)]
    stats = {"programs": len(todo), "replayed": 0, "failed": 0,
             "skipped": len(recorded) - len(todo), "setup_s": 0.0,
             "wall_s": 0.0, "serial_s": 0.0}
    if stats["skipped"]:
        PROFILER.count("prewarm.skipped", float(stats["skipped"]))
    if not todo:
        return stats
    if workers is None:
        workers = GLOBAL_CONF.getInt("sml.prewarm.workers")
    workers = max(1, int(workers))
    PROFILER.count("prewarm.programs", float(len(todo)))
    if _OBS.enabled:
        _OBS.emit("prewarm", "prewarm.start",
                  args={"programs": len(todo), "workers": workers})
    t0 = _now()
    _setup(device, sorted({_KERNELS[e["kernel"]].source for e in todo
                           if e["kind"] == "launch"}))
    stats["setup_s"] = _now() - t0
    stats_lock = threading.Lock()
    errors: list = []
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="sml-prewarm") as pool:
        for f in [pool.submit(_replay_one, e, device, stats, stats_lock,
                              errors) for e in todo]:
            f.result()
    stats["wall_s"] = _now() - t0
    if _OBS.enabled:
        _OBS.emit("prewarm", "prewarm.done", args=dict(stats))
    if errors:
        raise errors[0]
    return stats


def speculative_prewarm(fn: Callable, shapes: List[tuple],
                        workers: Optional[int] = None) -> dict:
    """Shape-bucket prewarm keyed off a DECLARED width mix instead of the
    recorded manifest: call `fn` once on a zero f32 block of each
    distinct (rows, features) shape, from a `workers`-wide thread pool
    (`sml.prewarm.workers` by default), so a load trace's widths find
    their first calls paid. Each call is its own trace and holds a
    watchdog ticket. Returns {programs, warmed, failed, wall_s,
    serial_s}, the JAX package's keys. A failed call is counted, and the
    first failure is raised once the pool has finished, as `prewarm()`
    raises (the JAX package counts it and returns)."""
    todo = sorted({tuple(int(d) for d in s) for s in shapes})
    stats = {"programs": len(todo), "warmed": 0, "failed": 0,
             "wall_s": 0.0, "serial_s": 0.0}
    if not todo:
        return stats
    if workers is None:
        workers = GLOBAL_CONF.getInt("sml.prewarm.workers")
    workers = max(1, int(workers))
    PROFILER.count("prewarm.speculative", float(len(todo)))
    stats_lock = threading.Lock()
    errors: list = []

    def _warm_one(shape: tuple) -> None:
        t0 = _now()
        ok = True
        ctx = _trace.new_trace()
        try:
            with _trace.activate(ctx), \
                    _WATCHDOG.watch("prewarm", "prewarm.speculative",
                                    trace=ctx):
                fn(np.zeros(shape, dtype=np.float32))
        except Exception as e:  # noqa: BLE001 — counted, and raised below
            ok = False
            errors.append(e)
        dt = _now() - t0
        with stats_lock:
            stats["warmed" if ok else "failed"] += 1
            stats["serial_s"] += dt
        if not ok:
            PROFILER.count("prewarm.failed")
        if _OBS.enabled:
            args = {"shape": list(shape), "ok": ok,
                    "seconds": round(dt, 4)}
            if ctx is not None:
                args["trace"] = ctx.trace_id
            _OBS.emit("prewarm", "prewarm.speculative", args=args)

    t0 = _now()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="sml-spec-prewarm") as pool:
        for f in [pool.submit(_warm_one, s) for s in todo]:
            f.result()
    stats["wall_s"] = _now() - t0
    if _OBS.enabled:
        _OBS.emit("prewarm", "prewarm.speculative_done", args=dict(stats))
    if errors:
        raise errors[0]
    return stats


def maybe_prewarm(block: bool = False, device=None) -> Optional[object]:
    """The opt-in start hook of a serving endpoint: replay the manifest
    once per (manifest, device signature) when `sml.prewarm.enabled` is
    set, in a background thread by default (returned, so a caller may
    join it), so a model's load overlaps the warm-up. A second endpoint
    under the same manifest and card skips (counted
    `prewarm.replica_skip`)."""
    if not GLOBAL_CONF.getBool("sml.prewarm.enabled"):
        return None
    from ..device import resolve_device
    device = resolve_device(device)
    key = (manifest_path(), tuple(device_signature(device)))
    with _lock:
        # claim BEFORE starting: two endpoints opened back to back must
        # not both replay
        if _ran.get(key):
            PROFILER.count("prewarm.replica_skip")
            return None
        _ran[key] = True
    if block:
        return prewarm(device)
    with _lock:
        _status.update(state="running", stats=None, error=None)
    t = threading.Thread(target=_background, args=(device,), daemon=True,
                         name="sml-prewarm")
    t.start()
    return t


def _background(device) -> None:
    """`maybe_prewarm`'s thread: the replay, its outcome kept for
    `status()` (a thread's exception would otherwise be lost)."""
    try:
        stats = prewarm(device)
    except Exception as e:  # noqa: BLE001 — kept and reported, not hidden
        PROFILER.count("prewarm.background_failed")
        with _lock:
            _status.update(state="failed", error=f"{type(e).__name__}: {e}")
        if _OBS.enabled:
            _OBS.emit("prewarm", "prewarm.failed",
                      args={"error": _status["error"]})
        return
    with _lock:
        _status.update(state="done", stats=stats)


def status() -> dict:
    """The process's last background replay: {"state": "idle",
    "running", "done" or "failed", "stats": prewarm()'s stats or None,
    "error": the failure or None}."""
    with _lock:
        return dict(_status)


def reset() -> None:
    """Forget the in-process state (the loaded manifest, the signatures
    seen, the replay guards); the file on disk stays."""
    with _lock:
        _flush_locked()
        _state.update(path=None, entries=None, dirty=False)
        _seen.clear()
        _raw_seen.clear()
        _ran.clear()
        _status.update(state="idle", stats=None, error=None)
