"""Causal trace-context propagation across the port's thread hops.

The port's copy of `sml_tpu/obs/_context.py`. A serving request's life
crosses threads: the client thread that admits it, the micro-batcher
thread that coalesces and launches it, and (for prewarm replays) the
pool worker. A `TraceContext(trace_id, span_id, parent_id)` minted at
admission rides a `contextvars.ContextVar` through every synchronous
hop and is handed across threads and queues EXPLICITLY (capture the
context with the work item, `activate` it where the work runs:
contextvars do not cross threads by themselves).

The fan-in is first-class: one coalesced micro-batch flush span records
its N parent request span and trace ids (`fan_in`, `parent_ids`,
`parent_traces`).

Hot-path contract (tests/test_torch_obs.py): with the recorder disabled,
`current()` / `mint_request()` / `fan_in()` are no-ops behind one
attribute load: no ContextVar read, no allocation.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

from ._recorder import RECORDER

#: per-process random tag (16 bits) + a 36-bit counter: ids stay inside
#: 2**52 < 2**53 so they survive a JSON round-trip through readers that
#: parse to double, the counter space (~68e9 ids) outlives any serving
#: process, and two processes' bundles merge without collision except at
#: the 1/65536 tag-clash odds — acceptable for display, never used as a
#: key across processes
_PROC_TAG = int.from_bytes(os.urandom(2), "big") << 36
_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return _PROC_TAG | (next(_ids) & 0xFFFFFFFFF)


def hex_id(ident: Optional[int]) -> Optional[str]:
    """Display form of a trace/span id (reports, canary stats)."""
    return None if ident is None else f"0x{ident:013x}"


@dataclass(frozen=True)
class TraceContext:
    """One logical unit of work's position in the causal tree."""
    trace_id: int
    span_id: int
    parent_id: Optional[int] = None

    def child(self) -> "TraceContext":
        """A child unit within the SAME trace (new span id, this span as
        parent) — a dispatch launched on behalf of a request."""
        return TraceContext(self.trace_id, _next_id(), self.span_id)


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("sml_tpu_torch_trace", default=None)


def current() -> Optional[TraceContext]:
    """The active context on this thread (None when the recorder is off
    — the one-attribute-load disabled path — or nothing is active)."""
    if not RECORDER.enabled:
        return None
    return _CURRENT.get()


def new_trace() -> Optional[TraceContext]:
    """Mint a fresh root context (None when the recorder is off)."""
    if not RECORDER.enabled:
        return None
    return TraceContext(_next_id(), _next_id(), None)


def mint_request(rows: Optional[int] = None,
                 ts: Optional[float] = None) -> Optional[TraceContext]:
    """Admission point of a serving request: mint a root context AND land
    its admission span (a zero-duration `trace.request` span on the
    admitting thread's lane — the flow arrows' source anchor)."""
    ctx = new_trace()
    if ctx is not None:
        args = {"trace": ctx.trace_id, "span": ctx.span_id}
        if rows is not None:
            args["rows"] = int(rows)
        RECORDER.emit("span", "trace.request", dur=0.0, ts=ts, args=args)
    return ctx


def fan_in(parents: Sequence[TraceContext]) -> Optional[TraceContext]:
    """The coalescing edge: N parent units merge into ONE downstream unit
    (a micro-batch flush). Returns a fresh context for the merged work —
    the caller records the parent span/trace ids on the flush span
    (`parent_traces` / `parent_spans` args) so the exporter can draw one
    arrow per parent into it."""
    if not RECORDER.enabled or not parents:
        return None
    return TraceContext(_next_id(), _next_id(), None)


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Install a CAPTURED context on the current thread for the duration
    of a block — the explicit cross-thread/cross-queue handoff. A None
    context (recorder off at capture time) is a no-op."""
    if ctx is None:
        yield None
        return
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def trace_args(args: Optional[dict] = None) -> dict:
    """`args` (or a fresh dict) with the active context's trace/span ids
    folded in — the one-liner for emit sites that should tag their event
    when (and only when) a context is riding the thread."""
    out = dict(args) if args else {}
    ctx = current()
    if ctx is not None:
        out.setdefault("trace", ctx.trace_id)
        out.setdefault("span", ctx.span_id)
    return out


def parent_ids(parents: Sequence[TraceContext]) -> List[int]:
    return [p.span_id for p in parents]


def parent_traces(parents: Sequence[TraceContext]) -> List[int]:
    return [p.trace_id for p in parents]
