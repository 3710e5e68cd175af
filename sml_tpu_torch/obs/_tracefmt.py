"""Pure Chrome/Perfetto trace-event conversion over recorded event dicts.

The port's own copy of `sml_tpu/obs/_tracefmt.py`, the same track
layout and flow events; only the host process's name differs
("sml_tpu_torch host"). STDLIB-ONLY and free of package-relative imports
BY DESIGN: this module is the one converter behind the port's
`obs._trace.export_chrome_trace` (live ring -> trace.json), and it
renders a black-box bundle's `events.jsonl` loaded by file path, on a
machine with nothing but Python. Input records are plain dicts, exactly
the JSONL sink / blackbox `events.jsonl` line shape:

    {"ts": s, "kind": str, "name": str, "dur": s?, "tid": int, "args": {}}

Track layout (the Spark-UI executor-timeline equivalent):

- pid 1 "sml_tpu_torch host": one lane per recording host thread; span events
  render as complete ("X") events, nested spans stack as measured.
- pid 2 "device (dispatched programs)": `program.*` spans whose dispatch
  route was "device", one lane per dispatching thread.
- pid 3 "per-device (skew attribution)": `skew.compute` / `skew.wait`
  lanes, one per device (obs/_skew.py).
- counter tracks ("C", pid 1): `*_bytes*` counters and `hbm.*` gauges.
- everything else renders as an instant marker.

Causal FLOW EVENTS (`ph:"s"/"t"/"f"`): any event whose args carry
a `trace` id — admission spans, coalesced-flush spans, dispatch events,
collective notes, prewarm replays — becomes an anchor point of that
trace's flow; a flush span's `parent_traces` list additionally anchors
every parent trace (the fan-in edge). Each trace id with >= 2 anchors
emits a start ("s") at its first anchor, steps ("t") in between, and an
end ("f", bp:"e") at its last — Perfetto renders the arrows across host
threads and the virtual device track, so one serving request's causal
path is a click, not a grep.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

PID_HOST = 1
PID_DEVICE = 2
PID_SKEW = 3  # per-device straggler attribution: one lane per device

FLOW_NAME = "trace"  # flow events bind by (name, cat, id)


def _is_counter_track(name: str) -> bool:
    return ("_bytes" in name or name.endswith(".bytes")
            or name.startswith("hbm."))


def _is_device_span(name: str, args: dict) -> bool:
    return name.startswith("program.") and args.get("route") == "device"


def _anchor_ids(args: dict) -> List[int]:
    """Trace ids this event anchors: its own riding context plus any
    fan-in parents recorded on a coalescing span."""
    ids: List[int] = []
    t = args.get("trace")
    if isinstance(t, int):
        ids.append(t)
    parents = args.get("parent_traces")
    if isinstance(parents, (list, tuple)):
        ids.extend(p for p in parents if isinstance(p, int))
    return ids


def to_trace_dicts(records: Iterable[dict]) -> List[dict]:
    """Convert recorded event dicts to Chrome trace events (metadata +
    slices + counters + instants + causal flows)."""
    out: List[dict] = [
        {"ph": "M", "pid": PID_HOST, "tid": 0, "name": "process_name",
         "args": {"name": "sml_tpu_torch host"}},
        {"ph": "M", "pid": PID_DEVICE, "tid": 0, "name": "process_name",
         "args": {"name": "device (dispatched programs)"}},
        {"ph": "M", "pid": PID_SKEW, "tid": 0, "name": "process_name",
         "args": {"name": "per-device (skew attribution)"}},
    ]
    seen_tids = set()
    #: trace id -> [(ts_us, pid, tid)] anchor points, in record order
    flows: Dict[int, List[Tuple[float, int, int]]] = {}
    for ev in records:
        name = str(ev.get("name", ""))
        kind = str(ev.get("kind", ""))
        args = ev.get("args") or {}
        ts_us = float(ev.get("ts", 0.0)) * 1e6
        tid = int(ev.get("tid", 0))
        if kind == "span":
            if name.startswith("skew."):
                # straggler attribution renders ONE LANE PER DEVICE —
                # the per-executor timeline, with compute and wait spans
                # stacked per device (obs/_skew.py)
                pid, lane = PID_SKEW, int(args.get("device", 0))
                label = "device"
            else:
                pid = PID_DEVICE if _is_device_span(name, args) else PID_HOST
                lane = tid
                label = ("dispatch-thread" if pid == PID_DEVICE
                         else "host-thread")
            key = (pid, lane)
            if key not in seen_tids:
                seen_tids.add(key)
                out.append({"ph": "M", "pid": pid, "tid": lane,
                            "name": "thread_name",
                            "args": {"name": f"{label}-{lane}"}})
            out.append({"ph": "X", "pid": pid, "tid": lane,
                        "ts": ts_us,
                        "dur": max(float(ev.get("dur") or 0.0), 0.0) * 1e6,
                        "name": name, "cat": kind, "args": dict(args)})
            for fid in _anchor_ids(args):
                flows.setdefault(fid, []).append((ts_us, pid, lane))
        elif kind == "counter":
            if _is_counter_track(name):
                out.append({"ph": "C", "pid": PID_HOST, "tid": 0,
                            "ts": ts_us, "name": name, "cat": "counter",
                            "args": {"value": args.get("total", 0.0)}})
        else:
            # every other typed event (dispatch, cache, collective,
            # compile, serve, infer, skew, health, regress, stall,
            # blackbox, ...) renders as an instant marker: a visible pin
            # without a lane
            out.append({"ph": "i", "s": "t", "pid": PID_HOST,
                        "tid": tid, "ts": ts_us, "name": name,
                        "cat": kind, "args": dict(args)})
            for fid in _anchor_ids(args):
                flows.setdefault(fid, []).append((ts_us, PID_HOST, tid))
    for fid, anchors in flows.items():
        if len(anchors) < 2:
            continue  # a flow needs somewhere to go
        anchors.sort(key=lambda a: a[0])
        last = len(anchors) - 1
        for i, (ts_us, pid, lane) in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == last else "t")
            fev = {"ph": ph, "id": fid, "pid": pid, "tid": lane,
                   "ts": ts_us, "name": FLOW_NAME, "cat": "trace"}
            if ph == "f":
                fev["bp"] = "e"  # bind to the enclosing slice, not the next
            out.append(fev)
    return out


def trace_doc(records: Iterable[dict], *, dropped: int = 0,
              epoch_unix: Optional[float] = None,
              producer: str = "sml_tpu_torch.obs") -> dict:
    """The full trace.json document, with the wall-clock anchor
    (`epoch_unix` = Unix time of ts 0) in otherData so a postmortem can
    line the timeline up against external logs."""
    other = {"producer": producer, "dropped_events": dropped}
    if epoch_unix is not None:
        other["epoch_unix"] = round(float(epoch_unix), 6)
    return {"traceEvents": to_trace_dicts(records),
            "displayTimeUnit": "ms",
            "otherData": other}
