"""Black-box postmortem: a forensics bundle that survives the process.

The port's copy of `sml_tpu/obs/blackbox.py`, writing the same bundle
layout (the unchanged `scripts/blackbox_view.py` renders a port bundle).
The flight recorder's ring, the streaming metrics, the dispatch audit,
and the in-flight watchdog tickets all live in process memory — when a
run crashes or hangs, everything a postmortem needs dies with it. This
module is the ejector seat: `dump_blackbox()` writes a self-contained
bundle to `sml.obs.blackboxDir`, triggered three ways:

- **explicitly** — `obs.dump_blackbox("why")` anywhere;
- **on unhandled exception** — `install()` chains `sys.excepthook` /
  `threading.excepthook` (the prior hooks still run);
- **on a hard stall** — `install()` registers a once-per-process
  `WATCHDOG.on_stall` hook, so the first flagged ticket dumps the
  bundle while the hang is still live.

Bundle layout (all best-effort: a failing section is skipped, never
fatal — the dump path must work in a dying process):

    blackbox-<utc>-<pid>/
      MANIFEST.json   reason, epoch_unix + dump wallclock, version,
                      conf dump, engine counters, exception traceback,
                      in-flight tickets (with trace ids), thread stacks
      events.jsonl    the ring, one event per line (sink line shape,
                      header line first) — replayable into a Chrome
                      trace by `_tracefmt` loaded by file path
      metrics.json    METRICS snapshot (incl. exemplars), SLO, skew
      audit.json      dispatch audit records + the rendered report
      ledger.json     device memory ledger snapshot

The port's `obs/_tracefmt.py`, loaded by file path, renders a bundle's
events to `trace.json` (Perfetto); the postmortem machine needs python
and nothing else. No section calls the device.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from typing import Dict, Optional

from ..conf import GLOBAL_CONF
from ._recorder import RECORDER, event_record
from ._watchdog import WATCHDOG, all_thread_stacks

BUNDLE_VERSION = 1

_lock = threading.Lock()
_state = {"installed": False, "stall_dumped": False,
          "prev_excepthook": None, "prev_threading_hook": None}


def _bundle_root(directory: Optional[str]) -> str:
    if directory:
        return directory
    return str(GLOBAL_CONF.get("sml.obs.blackboxDir") or "blackbox")


def _utc_stamp() -> str:
    import datetime
    from ..utils.profiler import wallclock
    dt = datetime.datetime.fromtimestamp(wallclock(),
                                         tz=datetime.timezone.utc)
    return dt.strftime("%Y%m%dT%H%M%S")


def _write_json(path: str, doc) -> None:
    try:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
    except Exception:
        pass  # best-effort per section


def _exception_block(exc) -> Optional[Dict[str, object]]:
    """Normalize `exc` — an exception instance, a sys.exc_info() tuple,
    or None — into the manifest's exception section."""
    if exc is None:
        return None
    if isinstance(exc, BaseException):
        tp, val, tb = type(exc), exc, exc.__traceback__
    else:
        tp, val, tb = exc
    if tp is None:
        return None
    return {
        "type": getattr(tp, "__name__", str(tp)),
        "value": str(val),
        "traceback": [ln.rstrip() for ln in
                      traceback.format_exception(tp, val, tb)],
    }


def dump_blackbox(reason: str = "manual", exc=None,
                  directory: Optional[str] = None) -> Optional[str]:
    """Write one forensics bundle; returns its path (None only if even
    the directory could not be created). Safe to call from any thread,
    with the recorder on or off (an empty ring still yields the conf
    dump, stacks, and in-flight table), and NEVER raises."""
    try:
        root = _bundle_root(directory)
        bundle = os.path.join(root, f"blackbox-{_utc_stamp()}-{os.getpid()}")
        os.makedirs(bundle, exist_ok=True)
    except Exception:
        return None
    from ..utils.profiler import wallclock
    try:
        epoch_unix = RECORDER.epoch_unix()
    except Exception:
        epoch_unix = None

    # ---- events.jsonl: header line + the ring, sink line shape --------
    try:
        with open(os.path.join(bundle, "events.jsonl"), "w") as f:
            f.write(json.dumps(
                {"ts": 0.0, "kind": "meta", "name": "obs.header",
                 "args": {"version": BUNDLE_VERSION,
                          "epoch_unix": epoch_unix,
                          "reason": reason}}) + "\n")
            for ev in RECORDER.events():
                f.write(json.dumps(event_record(ev), default=str) + "\n")
    except Exception:
        pass

    # ---- MANIFEST.json ------------------------------------------------
    import platform
    from ..version import __version__
    manifest: Dict[str, object] = {
        "bundle_version": BUNDLE_VERSION,
        "reason": reason,
        "epoch_unix": epoch_unix,
        "dumped_unix": wallclock(),
        # the bundle format's key (scripts/blackbox_view.py reads it),
        # holding the port's version; "package" names which wrote it
        "sml_tpu_version": __version__,
        "package": "sml_tpu_torch",
        "python": sys.version,
        "platform": platform.platform(),
        "pid": os.getpid(),
        "recorder_enabled": RECORDER.enabled,
        "dropped_events": RECORDER.dropped,
    }
    for key, fn in (("conf", GLOBAL_CONF.asDict),
                    ("counters", RECORDER.counters),
                    ("inflight", WATCHDOG.inflight),
                    ("thread_stacks", all_thread_stacks)):
        try:
            manifest[key] = fn()
        except Exception:
            manifest[key] = None
    try:
        manifest["exception"] = _exception_block(exc)
    except Exception:
        manifest["exception"] = None
    _write_json(os.path.join(bundle, "MANIFEST.json"), manifest)

    # ---- metrics / audit / ledger (lazy imports: the obs package may
    # be mid-teardown when an excepthook fires) -------------------------
    try:
        from ._metrics import METRICS
        from ._skew import SKEW
        from . import slo_report
        _write_json(os.path.join(bundle, "metrics.json"), {
            "metrics": METRICS.snapshot(),
            "slo": slo_report(),
            "skew": SKEW.straggler_report(),
        })
    except Exception:
        pass
    try:
        from . import _audit
        _write_json(os.path.join(bundle, "audit.json"), {
            "records": [vars(r) for r in _audit.records()],
            "report": _audit.report(),
        })
    except Exception:
        pass
    try:
        from ._ledger import LEDGER
        _write_json(os.path.join(bundle, "ledger.json"), LEDGER.snapshot())
    except Exception:
        pass

    if RECORDER.enabled:
        RECORDER.emit("blackbox", "blackbox.dump",
                      args={"reason": reason, "path": bundle})
        RECORDER.counter("blackbox.dumps")
    return bundle


# ------------------------------------------------------------ arming hooks
def _stall_hook(ticket: dict) -> None:
    """Once-per-process auto-dump on the FIRST hard stall (every later
    stall is in the first bundle's ring anyway; a stall storm must not
    fill the disk with bundles)."""
    with _lock:
        if _state["stall_dumped"]:
            return
        _state["stall_dumped"] = True
    dump_blackbox(f"hard-stall:{ticket.get('name')}")


def install(directory: Optional[str] = None) -> None:
    """Arm the automatic triggers (idempotent): unhandled exceptions on
    any thread and the first hard stall each dump a bundle. `directory`
    overrides `sml.obs.blackboxDir` for this process."""
    with _lock:
        if directory:
            GLOBAL_CONF.set("sml.obs.blackboxDir", directory)
        if _state["installed"]:
            return
        _state["installed"] = True
    WATCHDOG.on_stall(_stall_hook)

    prev = sys.excepthook
    _state["prev_excepthook"] = prev

    def _hook(tp, val, tb):
        try:
            dump_blackbox("unhandled-exception", exc=(tp, val, tb))
        finally:
            prev(tp, val, tb)

    sys.excepthook = _hook

    prev_t = threading.excepthook
    _state["prev_threading_hook"] = prev_t

    def _thread_hook(args):
        try:
            dump_blackbox(
                f"unhandled-exception:{getattr(args.thread, 'name', '?')}",
                exc=(args.exc_type, args.exc_value, args.exc_traceback))
        finally:
            prev_t(args)

    threading.excepthook = _thread_hook
