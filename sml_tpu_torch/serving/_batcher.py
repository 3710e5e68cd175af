"""Continuous micro-batching: many small requests, one kernel launch.

Counterpart of `sml_tpu/serving/_batcher.py`. Requests are admitted into
a rows-bounded queue; the flush worker coalesces everything queued (of
one feature width) into one block, scores it with one `score_block`
call, and splits the result back per request.

Flush policy, whichever comes first:
- rows: a full batch (`sml.serve.maxBatchRows`) flushes at once;
- deadline: the OLDEST queued request has waited the flush deadline
  (`sml.serve.flushMicros`, or the auto-tuned `flush_micros` under
  `sml.serve.flushAutoTune`).

Degradation ladder (admission -> flush):
1. the queue has room -> enqueue (the rows also feed
   `parallel.dispatch.DEVICE_QUEUE`, the dispatcher's pressure signal,
   or the `QueuePressure` the caller passes);
2. the queue is saturated (`sml.serve.queueRows` rows queued or in
   flight toward the card) and the caller asked for the host fallback
   (`sml.serve.hostFallback`, off by default, or `host_fallback=True`)
   -> score on the HOST route in the caller's thread (counted
   `serve.host_routed`): the caller pays its own overflow;
3. host fallback off -> shed (`RequestShed`, `serve.shed.overflow`, or
   `serve.shed.closed` on a closed batcher) instead of deadlocking;
4. at flush time, queued requests past `sml.serve.requestTimeoutMillis`
   shed: a deadline the caller already gave up on is not worth a launch.

A flushed batch's rows leave the queue as soon as its `score_block`
returns, before its futures resolve (the JAX package releases them after
the futures and the drift observer), so a caller that submits again on
its result never finds its own rows still counted against the bound.

With the flight recorder on, each request's trace context is minted at
admission and fanned in at flush (the `serve.batch` span carries its
requests' `parent_traces` and `parent_spans`), each flush holds a
`serve.flush` watchdog ticket, and the `serve.batch_ms` and
`serve.request_ms` histograms fill (the auto-tuner's floor and the SLO
report's input).

`score_block` runs on the flush worker's thread, so its kernel launches
on that thread's current CUDA stream, and its copy back to the host
waits for them.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional

import numpy as np

from ..conf import GLOBAL_CONF
from ..obs import _context as _trace
from ..obs._metrics import METRICS as _METRICS
from ..obs._recorder import RECORDER as _OBS
from ..obs._watchdog import WATCHDOG as _WATCHDOG
from ..parallel import dispatch
from ..utils.profiler import PROFILER, now


class RequestShed(RuntimeError):
    """The admission controller refused (queue full and no host
    fallback, or the batcher closed) or the request's deadline passed
    before its batch flushed."""


class RequestTimeout(TimeoutError):
    """A caller's bounded `result(timeout=)` wait expired before the
    batch resolved the future. The future stays resolvable: the batch in
    flight still completes it (counted `serve.timeout`)."""


class ScoreFuture:
    """Handle for one submitted request: `result()` blocks for the
    per-request prediction slice (or raises what the batch raised).
    `trace_id` is the request's causal trace id (obs/_context.py): the
    handle clients and tests use to find THIS request among the recorded
    events; None with the recorder off."""

    def __init__(self, n_rows: int):
        self._event = threading.Event()
        self._n_rows = n_rows
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self.trace_id: Optional[int] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            PROFILER.count("serve.timeout")
            raise RequestTimeout(
                "serving request still queued/in flight after the "
                "caller's bounded wait (the future remains resolvable)")
        # snapshot: the flush worker writes `_error`/`_value` before
        # `_event.set()`, but a second setter (close() draining a queue
        # the worker is still flushing) may rebind between our check and
        # the raise — one load each makes the read atomic
        err = self._error
        if err is not None:
            raise err
        return self._value

    def _set(self, value: np.ndarray) -> None:
        self._value = value
        self._event.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class _Pending:
    __slots__ = ("X", "n", "future", "t_enqueue", "deadline", "ctx")

    def __init__(self, X: np.ndarray, deadline: Optional[float]):
        self.X = X
        self.n = int(X.shape[0])
        self.future = ScoreFuture(self.n)
        self.t_enqueue = now()
        self.deadline = deadline
        # causal trace context minted at ADMISSION (obs/_context.py):
        # lands a trace.request span on the admitting thread and rides
        # the queue to the coalesced flush — the cross-queue handoff
        self.ctx = _trace.mint_request(rows=self.n, ts=self.t_enqueue)
        self.future.trace_id = None if self.ctx is None \
            else self.ctx.trace_id


class MicroBatcher:
    """Coalesce concurrent `submit(X)` calls into batches scored by
    `score_block` (any callable with `DeviceScorer.score_block`'s
    contract). `host_score` is the synchronous overflow route
    (`DeviceScorer.score_block_host`); None disables host fallback
    whatever the conf says. `queue` is the pressure signal the batcher
    feeds and reads (`dispatch.DEVICE_QUEUE` by default; a
    `QueuePressure(parent=DEVICE_QUEUE)` gives one batcher's own rows).

    `start=False` leaves the flush worker paused (`start()` arms it), so
    a test can stage a queue before the first flush.

    `observer` (optional) is called after each delivered batch with
    `(X, preds, traces)`: the batch's feature block, its predictions and
    a per-row trace-id array (-1 = untraced). It feeds the drift
    monitors (obs/drift.py) and runs ONLY with the recorder on (one
    attribute load otherwise); the results are already delivered, so an
    observer that raises is counted (`drift.observe_error`), never
    served."""

    def __init__(self, score_block: Callable[[np.ndarray], np.ndarray], *,
                 host_score: Optional[Callable] = None,
                 max_batch_rows: Optional[int] = None,
                 flush_micros: Optional[int] = None,
                 queue_rows: Optional[int] = None,
                 timeout_millis: Optional[int] = None,
                 host_fallback: Optional[bool] = None,
                 flush_auto: Optional[bool] = None,
                 observer: Optional[Callable] = None,
                 queue: Optional[dispatch.QueuePressure] = None,
                 start: bool = True):
        self._score_block = score_block
        self._host_score = host_score
        self._observer = observer
        self._queue = dispatch.DEVICE_QUEUE if queue is None else queue
        conf = GLOBAL_CONF
        self.max_batch_rows = max(int(
            conf.getInt("sml.serve.maxBatchRows")
            if max_batch_rows is None else max_batch_rows), 1)
        micros = (conf.getInt("sml.serve.flushMicros")
                  if flush_micros is None else flush_micros)
        self._flush_s = max(int(micros), 0) / 1e6
        self._flush_auto = (conf.getBool("sml.serve.flushAutoTune")
                            if flush_auto is None else bool(flush_auto))
        # measured arrival intensity for the deadline auto-tuner:
        # (t, rows) admission marks, appended under the condition lock
        # the flush worker reads them with
        self._arrivals: deque = deque(maxlen=512)
        self.queue_rows = max(int(
            conf.getInt("sml.serve.queueRows")
            if queue_rows is None else queue_rows), 1)
        millis = (conf.getInt("sml.serve.requestTimeoutMillis")
                  if timeout_millis is None else timeout_millis)
        self._timeout_s = max(int(millis), 0) / 1e3 or None
        self._host_fallback = (conf.getBool("sml.serve.hostFallback")
                               if host_fallback is None else
                               bool(host_fallback)) \
            and host_score is not None
        self._cond = threading.Condition()
        self._q: deque = deque()
        self._queued_rows = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Arm the flush worker (idempotent)."""
        with self._cond:
            if self._thread is not None or self._closed:
                return
            self._thread = threading.Thread(
                target=self._loop, name="sml-serve-batcher", daemon=True)
            self._thread.start()

    def close(self) -> None:
        """Drain the queue (remaining requests still score) and stop."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        # a never-started batcher still owes its queued callers an answer
        batch = self._take_batch()
        while batch:
            self._run_batch(batch)
            batch = self._take_batch()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ admission
    def submit(self, X: np.ndarray) -> ScoreFuture:
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[None, :]
        n = int(X.shape[0])
        PROFILER.count("serve.requests")
        PROFILER.count("serve.rows", float(n))
        deadline = (now() + self._timeout_s) if self._timeout_s else None
        pending = _Pending(X, deadline)
        with self._cond:
            if self._flush_auto:
                self._arrivals.append((pending.t_enqueue, n))
            closed = self._closed
            saturated = closed or \
                self._queue.rows() + n > self.queue_rows
            if not saturated:
                self._queue.add(n)
                self._q.append(pending)
                self._queued_rows += n
                queued = self._queued_rows
                self._cond.notify()
        if saturated:
            return self._overflow(pending, closed)
        if _OBS.enabled:
            _OBS.gauge("serve.queue_rows", float(queued))
        return pending.future

    def _overflow(self, pending: _Pending, closed: bool) -> ScoreFuture:
        """Degradation ladder past admission: the host route in the
        caller's thread, else shed. Every shed is reason-tagged
        (`serve.shed.<reason>` beside the `serve.shed` total)."""
        if self._host_fallback:
            PROFILER.count("serve.host_routed")
            try:
                pending.future._set(np.asarray(
                    self._host_score(pending.X), dtype=np.float64))
                _METRICS.observe(
                    "serve.request_ms",
                    (now() - pending.t_enqueue) * 1e3,
                    exemplar=None if pending.ctx is None
                    else pending.ctx.trace_id)
            except Exception as e:  # noqa: BLE001 — the future carries it
                pending.future._set_error(e)
            return pending.future
        reason = "closed" if closed else "overflow"
        PROFILER.count("serve.shed")
        PROFILER.count(f"serve.shed.{reason}")
        pending.future._set_error(RequestShed(
            "batcher is closed" if closed else
            f"serving queue saturated ({self._queue.rows()} rows "
            f"queued toward the device, bound {self.queue_rows}) and host "
            f"fallback is off"))
        return pending.future

    # ---------------------------------------------------------------- flush
    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    @property
    def flush_micros(self) -> int:
        """The LIVE flush deadline (µs): the conf/ctor value unless
        `sml.serve.flushAutoTune` is adapting it."""
        return int(self._flush_s * 1e6)

    #: auto-tune EWMA step: fraction of each adjustment applied at once
    TUNE_ALPHA = 0.5
    #: fraction of the SLO target the flush wait may consume (the rest
    #: is headroom for the drain itself plus queueing jitter)
    TUNE_SLO_SLACK = 0.5
    #: trailing window the arrival-intensity estimate averages over
    TUNE_WINDOW_S = 2.0

    def _autotune(self) -> None:
        """`sml.serve.flushAutoTune`: adapt the flush deadline between
        the measured drain time and the SLO budget, under the MEASURED
        arrival intensity (the JAX package's rule, constant for
        constant). Floor: the median flush wall this process's batchers
        paid (`serve.batch_ms`, observed at the flush site; before the
        first flush, the dispatch audit's routed-program walls stand
        in): flushing faster than the card drains only queues batches.
        Ceiling: TUNE_SLO_SLACK of `sml.serve.sloMillis` minus the drain:
        a deadline past that spends the request's error budget waiting
        for batch mates. Between the bounds the target is the time the
        measured arrival intensity needs to FILL one batch. The
        histograms fill only with the recorder on; without them the
        deadline stays."""
        hist = _METRICS.histogram("serve.batch_ms")
        if hist is None:
            # no flush has landed through this process's batchers yet:
            # the audit's routed-program walls stand in
            hist = _METRICS.histogram("dispatch.device_ms")
        if hist is None:
            hist = _METRICS.histogram("dispatch.host_ms")
        if hist is None:
            return
        drain_ms = float(hist.quantile(0.5))
        if drain_ms <= 0.0:
            return
        slo_ms = float(GLOBAL_CONF.getInt("sml.serve.sloMillis"))
        ceil_ms = max(slo_ms * self.TUNE_SLO_SLACK - drain_ms, drain_ms)
        t = now()
        with self._cond:
            rows = sum(r for ts, r in self._arrivals
                       if t - ts <= self.TUNE_WINDOW_S)
        rate = rows / self.TUNE_WINDOW_S
        fill_ms = (self.max_batch_rows / rate * 1e3) if rate > 0 \
            else ceil_ms
        target_ms = min(max(fill_ms, drain_ms), ceil_ms)
        flush_ms = self._flush_s * 1e3
        flush_ms += self.TUNE_ALPHA * (target_ms - flush_ms)
        self._flush_s = flush_ms / 1e3
        if _OBS.enabled:
            _OBS.gauge("serve.flush_micros", round(flush_ms * 1e3, 1))

    def _rows_for_width(self, width: int) -> int:
        return sum(p.n for p in self._q if p.X.shape[1] == width)

    def _take_batch(self) -> List[_Pending]:
        """Pop one shape-bucket batch (FIFO within the oldest request's
        feature width, up to max_batch_rows; a single over-wide request
        still forms its own batch). Requests of other widths keep their
        queue position."""
        with self._cond:
            if not self._q:
                return []
            width = self._q[0].X.shape[1]
            batch: List[_Pending] = []
            rows = 0
            rest: deque = deque()
            while self._q:
                p = self._q.popleft()
                if p.X.shape[1] != width or \
                        (batch and rows + p.n > self.max_batch_rows):
                    rest.append(p)
                    continue
                batch.append(p)
                rows += p.n
                if rows >= self.max_batch_rows:
                    break
            while self._q:
                rest.append(self._q.popleft())
            self._q = rest
            self._queued_rows -= rows
            queued = self._queued_rows
        if _OBS.enabled:
            _OBS.gauge("serve.queue_rows", float(queued))
        return batch

    def _loop(self) -> None:
        while True:
            if self._flush_auto:
                self._autotune()
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait(0.05)
                if self._closed and not self._q:
                    return
                first = self._q[0]
                flush_at = first.t_enqueue + self._flush_s
                width = first.X.shape[1]
                while (not self._closed
                       and self._rows_for_width(width) < self.max_batch_rows
                       and now() < flush_at):
                    self._cond.wait(max(flush_at - now(), 1e-4))
            batch = self._take_batch()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: List[_Pending]) -> None:
        t = now()
        queue = self._queue
        live: List[_Pending] = []
        for p in batch:
            if p.deadline is not None and t > p.deadline:
                PROFILER.count("serve.expired")
                PROFILER.count("serve.shed")
                PROFILER.count("serve.shed.deadline")
                queue.sub(p.n)
                p.future._set_error(RequestShed(
                    "request exceeded sml.serve.requestTimeoutMillis "
                    "before its batch flushed"))
                continue
            live.append(p)
        if not live:
            return
        total = sum(p.n for p in live)
        X = live[0].X if len(live) == 1 else \
            np.concatenate([p.X for p in live], axis=0)
        # the FAN-IN edge (obs/_context.py): N request contexts merge
        # into one flush context; the flush span records every parent
        # span and trace id, and the flush context rides into the
        # dispatch decision and the program spans downstream
        parents = [p.ctx for p in live if p.ctx is not None]
        bctx = _trace.fan_in(parents)
        fan_meta = {} if bctx is None else {
            "parent_traces": _trace.parent_traces(parents),
            "parent_spans": _trace.parent_ids(parents)}
        ticket = _WATCHDOG.open("serve.flush", "serve.batch", trace=bctx)
        try:
            t_flush = now()
            try:
                with _trace.activate(bctx):
                    with PROFILER.span("serve.batch", rows=total,
                                       requests=len(live), **fan_meta):
                        out = np.asarray(self._score_block(X),
                                         dtype=np.float64)
            finally:
                # the batch has left the queue: its rows are released
                # before any caller hears its result, so a caller that
                # submits again on it never finds its own rows standing
                queue.sub(total)
            # one flush's launch + drain wall, measured at the flush site
            # whatever route score_block took: the drain floor
            # `_autotune` reads
            _METRICS.observe("serve.batch_ms", (now() - t_flush) * 1e3,
                             exemplar=None if bctx is None
                             else bctx.trace_id)
            PROFILER.count("serve.batches")
            # rows that entered a batch (serve.rows also counts shed and
            # host-routed admissions)
            PROFILER.count("serve.batch_rows", float(total))
            lo = 0
            done = now()
            for p in live:
                p.future._set(out[lo:lo + p.n])
                lo += p.n
                # per-request latency (admission -> result): the SLO
                # report's histogram; the request's OWN trace id is the
                # exemplar, so the worst bucket names a literal request
                _METRICS.observe("serve.request_ms",
                                 (done - p.t_enqueue) * 1e3,
                                 exemplar=None if p.ctx is None
                                 else p.ctx.trace_id)
            # drift observation: the delivered block, its predictions and
            # each row's trace id feed the endpoint's live window. The
            # results are out already, so a failing observer is counted,
            # never served as an error
            if self._observer is not None and _OBS.enabled:
                try:
                    traces = np.concatenate([
                        np.full(p.n,
                                -1 if p.ctx is None else p.ctx.trace_id,
                                dtype=np.int64) for p in live])
                    self._observer(X, out, traces)
                except Exception:  # noqa: BLE001 — counted, see above
                    PROFILER.count("drift.observe_error")
        except Exception as e:  # noqa: BLE001 — the futures carry it
            for p in live:
                p.future._set_error(e)
        finally:
            _WATCHDOG.close(ticket)
