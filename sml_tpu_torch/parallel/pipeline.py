"""A double-buffered staging pipeline: prep on worker threads, serial
dispatch, ordered drain; and its pure-host half, a bounded-lookahead
thread map.

The port's copy of `prefetch_pipeline` and `prefetch_map` from
`sml_tpu/parallel/pipeline.py`. The chunked ingest (`ml/_chunked.py`)
and `DeviceScorer.score_batches`' device route run the pipeline; the
factorized linear scorer runs the map. In the ingest, chunk i+1's prep
(host quantization, C++ that releases the GIL) runs on a worker thread
while chunk i's dispatch (an asynchronous copy to the card) is still in
flight, and drain waits for each in order.

Every dispatch and drain counts `<family>.dispatch` / `<family>.drain`
in the port's `PROFILER` and lands a `<family>.dispatch` /
`<family>.drain` flight-recorder event with the recorder on (both
through `obs.note_pipeline`), and appends `(kind, i)` to `order` when the caller passes
a list: the order in which chunk i+1 dispatches before chunk i drains
is the overlap's proof. Every item in flight holds a stall-watchdog
ticket (`obs._watchdog`) from its dispatch to its drain, so a wedged
copy is flagged with stacks instead of hanging silently.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional


def prefetch_pipeline(items: Iterable, prep: Callable, dispatch: Callable,
                      drain: Callable, *, depth: int, workers: int = 4,
                      family: str = "infer", index_key: str = "batch",
                      order: Optional[list] = None) -> Iterator:
    """Run `items` through prep -> dispatch -> drain with `depth` items
    dispatched ahead of the drain point; yields the drains' results.

    - `prep(item)` runs on one of `workers` threads, at most `workers`
      items ahead of the dispatch point (the source is never drained
      eagerly).
    - `dispatch(i, prepped)` runs serially in submission order and
      returns an in-flight handle.
    - `drain(i, handle)` finishes item i, in order.
    - `depth` <= 1 is synchronous: each item drains before the next
      dispatches.

    Events and tickets use `family` (`<family>.dispatch` /
    `<family>.drain` with args {index_key: i}).

    A caller that stops early, or a dispatch or drain that raises, still
    drains every item in flight (errors of those drains are dropped:
    they only release resources)."""
    from ..obs import note_pipeline
    from ..obs._watchdog import WATCHDOG

    depth = max(int(depth), 1)
    pending: deque = deque()

    def note(kind: str, i: int) -> None:
        note_pipeline(family, kind, index_key, i)
        if order is not None:
            order.append((kind, i))

    def drain_one():
        i, handle, ticket = pending.popleft()
        try:
            out = drain(i, handle)
        finally:
            WATCHDOG.close(ticket)
        note("drain", i)
        return out

    with ThreadPoolExecutor(max_workers=max(int(workers), 1)) as ex:
        it = iter(items)
        preps: deque = deque()

        def submit_next() -> bool:
            try:
                item = next(it)
            except StopIteration:
                return False
            preps.append(ex.submit(prep, item))
            return True

        try:
            for _ in range(max(int(workers), 1)):
                submit_next()
            i = 0
            while preps:
                prepped = preps.popleft().result()
                submit_next()
                ticket = WATCHDOG.open(family, f"{family}[{i}]")
                try:
                    handle = dispatch(i, prepped)
                except BaseException:
                    WATCHDOG.close(ticket)
                    raise
                note("dispatch", i)
                pending.append((i, handle, ticket))
                i += 1
                if len(pending) >= depth:
                    yield drain_one()
            while pending:
                yield drain_one()
        finally:
            while pending:
                j, handle, ticket = pending.popleft()
                WATCHDOG.close(ticket)
                try:
                    drain(j, handle)
                except Exception:
                    pass


def prefetch_map(items: Iterable, fn: Callable, *, depth: int,
                 workers: Optional[int] = None) -> Iterator:
    """`fn` over `items` on worker threads, results in order, with at
    most `depth` calls submitted ahead of the result being yielded, so
    the source is never drained eagerly. `depth` <= 1 is synchronous."""
    depth = max(int(depth), 1)
    with ThreadPoolExecutor(max_workers=workers or min(depth, 4)) as ex:
        it = iter(items)
        window: deque = deque()

        def pull() -> bool:
            try:
                item = next(it)
            except StopIteration:
                return False
            window.append(ex.submit(fn, item))
            return True

        for _ in range(depth):
            pull()
        while window:
            out = window.popleft().result()
            pull()
            yield out
