"""Chrome/Perfetto `trace.json` exporter over the flight-recorder ring.

The port's copy of `sml_tpu/obs/_trace.py`. The conversion itself lives
in `_tracefmt` (pure, stdlib-only, dict in / dict out) so a postmortem
bundle renders with the SAME track layout without importing this
package (or torch); this module binds it to the live ring and the
filesystem. See
`_tracefmt`'s docstring for the track layout and the causal flow-event
pass; load exported files at chrome://tracing or
https://ui.perfetto.dev.
"""

from __future__ import annotations

import json
from typing import List

from ._recorder import RECORDER, Event
from ._tracefmt import PID_DEVICE, PID_HOST, PID_SKEW, to_trace_dicts, \
    trace_doc

__all__ = ["PID_HOST", "PID_DEVICE", "PID_SKEW", "to_trace_events",
           "export_chrome_trace"]


def _as_records(events: List[Event]) -> List[dict]:
    return [{"ts": ev.ts, "kind": ev.kind, "name": ev.name, "dur": ev.dur,
             "tid": ev.tid, "args": ev.args} for ev in events]


def to_trace_events(events: List[Event]) -> List[dict]:
    return to_trace_dicts(_as_records(events))


def export_chrome_trace(path: str) -> str:
    """Write the recorder's current ring as a Chrome trace; returns the
    path (so callers can log it as a tracking artifact). The document's
    otherData carries `epoch_unix` — the wall-clock instant of ts 0 —
    so the timeline correlates with external logs."""
    doc = trace_doc(_as_records(RECORDER.events()),
                    dropped=RECORDER.dropped,
                    epoch_unix=RECORDER.epoch_unix())
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return path
