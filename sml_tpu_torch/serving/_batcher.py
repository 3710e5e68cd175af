"""Continuous micro-batching: many small requests, one kernel launch.

Counterpart of `sml_tpu/serving/_batcher.py`. Requests are admitted into
a rows-bounded queue; the flush worker coalesces everything queued (of
one feature width) into one block, scores it with one `score_block`
call, and splits the result back per request.

Flush policy, whichever comes first:
- rows: a full batch (`sml.serve.maxBatchRows`) flushes at once;
- deadline: the OLDEST queued request has waited `sml.serve.flushMicros`.

Degradation:
1. the queue has room -> enqueue;
2. rows queued or in flight would pass `sml.serve.queueRows` -> shed
   (`RequestShed`) at admission, instead of deadlocking. (The JAX
   package can route this overflow to a host scorer,
   `sml.serve.hostFallback`; the port has none yet, so it behaves as
   that package does with the fallback off);
3. at flush time, queued requests past `sml.serve.requestTimeoutMillis`
   shed: a deadline the caller already gave up on is not worth a launch.

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
from ..utils.profiler import PROFILER, now


class RequestShed(RuntimeError):
    """The admission controller refused (queue full) or the request's
    deadline passed before its batch flushed."""


class RequestTimeout(TimeoutError):
    """A caller's bounded `result(timeout=)` wait expired before the
    batch resolved the future. The future stays resolvable: the batch in
    flight still completes it."""


class ScoreFuture:
    """Handle for one submitted request: `result()` blocks for the
    per-request prediction slice (or raises what the batch raised)."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            PROFILER.count("serve.timeout")
            raise RequestTimeout(
                "serving request still queued/in flight after the "
                "caller's bounded wait (the future remains resolvable)")
        err = self._error  # one load: a second setter may rebind it
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
    __slots__ = ("X", "n", "future", "t_enqueue", "deadline")

    def __init__(self, X: np.ndarray, deadline: Optional[float]):
        self.X = X
        self.n = int(X.shape[0])
        self.future = ScoreFuture()
        self.t_enqueue = now()
        self.deadline = deadline


class MicroBatcher:
    """Coalesce concurrent `submit(X)` calls into batches scored by
    `score_block` (any callable with `DeviceScorer.score_block`'s
    contract).

    `start=False` leaves the flush worker paused (`start()` arms it), so
    a test can stage a queue before the first flush."""

    def __init__(self, score_block: Callable[[np.ndarray], np.ndarray], *,
                 max_batch_rows: Optional[int] = None,
                 flush_micros: Optional[int] = None,
                 queue_rows: Optional[int] = None,
                 timeout_millis: Optional[int] = None,
                 start: bool = True):
        self._score_block = score_block
        conf = GLOBAL_CONF
        self.max_batch_rows = max(int(
            conf.getInt("sml.serve.maxBatchRows")
            if max_batch_rows is None else max_batch_rows), 1)
        micros = (conf.getInt("sml.serve.flushMicros")
                  if flush_micros is None else flush_micros)
        self._flush_s = max(int(micros), 0) / 1e6
        self.queue_rows = max(int(
            conf.getInt("sml.serve.queueRows")
            if queue_rows is None else queue_rows), 1)
        millis = (conf.getInt("sml.serve.requestTimeoutMillis")
                  if timeout_millis is None else timeout_millis)
        self._timeout_s = max(int(millis), 0) / 1e3 or None
        self._cond = threading.Condition()
        self._q: deque = deque()
        #: rows admitted and not yet answered (queued or in flight): the
        #: admission bound's measure
        self._open_rows = 0
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
            closed = self._closed
            saturated = closed or self._open_rows + n > self.queue_rows
            if not saturated:
                self._open_rows += n
                self._q.append(pending)
                self._cond.notify()
        if saturated:
            self._shed(pending, closed)
        return pending.future

    def _shed(self, pending: _Pending, closed: bool) -> None:
        """Refuse at admission; every shed is reason-tagged
        (`serve.shed.<reason>` beside the `serve.shed` total)."""
        reason = "closed" if closed else "overflow"
        PROFILER.count("serve.shed")
        PROFILER.count(f"serve.shed.{reason}")
        pending.future._set_error(RequestShed(
            "batcher is closed" if closed else
            f"serving queue saturated ({self.open_rows()} rows queued or "
            f"in flight, bound {self.queue_rows})"))

    # ---------------------------------------------------------------- flush
    def open_rows(self) -> int:
        with self._cond:
            return self._open_rows

    def _rows_for_width(self, width: int) -> int:
        return sum(p.n for p in self._q if p.X.shape[1] == width)

    def _take_batch(self) -> List[_Pending]:
        """Pop one batch: FIFO within the oldest request's feature width,
        up to max_batch_rows (a single over-wide request still forms its
        own batch). Requests of other widths keep their queue position."""
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
        return batch

    def _loop(self) -> None:
        while True:
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

    def _release(self, rows: int) -> None:
        with self._cond:
            self._open_rows -= rows

    def _run_batch(self, batch: List[_Pending]) -> None:
        t = now()
        live: List[_Pending] = []
        for p in batch:
            if p.deadline is not None and t > p.deadline:
                PROFILER.count("serve.expired")
                PROFILER.count("serve.shed")
                PROFILER.count("serve.shed.deadline")
                self._release(p.n)
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
        try:
            with PROFILER.span("serve.batch", rows=total, requests=len(live)):
                out = np.asarray(self._score_block(X), dtype=np.float64)
            PROFILER.count("serve.batches")
            PROFILER.count("serve.batch_rows", float(total))
            lo = 0
            for p in live:
                p.future._set(out[lo:lo + p.n])
                lo += p.n
        except Exception as e:  # noqa: BLE001 — the futures carry it
            for p in live:
                p.future._set_error(e)
        finally:
            self._release(total)
