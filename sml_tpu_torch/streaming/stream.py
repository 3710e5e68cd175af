"""Micro-batch structured streaming (the MLE 00 deployment path).

The port's copy of `sml_tpu/streaming/stream.py`:
`spark.readStream.schema(s).option("maxFilesPerTrigger", 1).parquet(dir)`
→ `pipeline_model.transform(stream)` → `writeStream.format("memory" |
"delta").option("checkpointLocation", ...).queryName(n).start()`
(`SML/ML Electives/MLE 00 - MLlib Deployment Options.py:52-85`).

A `StreamingDataFrame` is a source (a directory of parquet or CSV part
files) and a recorded chain of DataFrame → DataFrame ops: any method
called on it, and the `_derive` / `_derive_rowlocal` hooks the ML stages
drive, is replayed on each micro-batch, so a fitted `VectorAssembler` and
a model's `transform` score every batch as they score a static frame. A
`StreamingQuery` runs the trigger loop on its own thread: it lists the
files not yet processed (the processed set lives in `checkpointLocation`,
so a restarted query skips them), reads up to `maxFilesPerTrigger` of
them as one frame (one partition a file) through the port's parquet
codec (`frame/parquet/`) or CSV reader (`frame/io.py`), applies the op
chain and appends the result to the sink.

The memory sink keeps each micro-batch's block (`_mem_parts`, the rows
`ct.StreamChunkSource` reads) and registers their concatenation as the
query's name in the session's catalog, so `spark.sql("SELECT ... FROM
<queryName>")` reads every committed row; the JAX package concatenates
pandas frames there. A failed trigger ends the query: the error is kept
(`exception()`), and `processAllAvailable()` and `awaitTermination()`
raise it; `stop()` joins the trigger thread.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Union

from ..frame.dataframe import DataFrame, coerce_to_schema
from ..frame.types import StructType, parse_schema
from ..utils.profiler import wallclock

_active_queries: List["StreamingQuery"] = []
_lock = threading.RLock()

#: the least pause of an idle trigger loop (no new files), so that a
#: processingTime of 0 polls the source instead of spinning on it
IDLE_POLL_S = 0.01


class StreamManager:
    """`spark.streams`: the session's queries (`SML/Includes/
    Classroom-Setup.py:96-110` stops them all)."""

    @property
    def active(self) -> List["StreamingQuery"]:
        with _lock:
            return [q for q in _active_queries if q.isActive]

    def get(self, query_id: str) -> Optional["StreamingQuery"]:
        for q in self.active:
            if q.id == query_id or q.name == query_id:
                return q
        return None

    def awaitAnyTermination(self, timeout: Optional[float] = None) -> bool:
        """Block until any query started so far has terminated (True at
        once if one already has); False only on timeout."""
        with _lock:
            started = list(_active_queries)
        t0 = wallclock()
        while True:
            if not started or any(not q.isActive for q in started):
                return True
            if timeout is not None and wallclock() - t0 > timeout:
                return False
            started[0]._stop.wait(0.05)


class DataStreamReader:
    def __init__(self, session):
        self._session = session
        self._schema: Optional[StructType] = None
        self._options: Dict[str, Any] = {}
        self._format = "parquet"

    def schema(self, s: Union[str, StructType]) -> "DataStreamReader":
        self._schema = parse_schema(s)
        return self

    def option(self, key: str, value) -> "DataStreamReader":
        self._options[key] = value
        return self

    def format(self, f: str) -> "DataStreamReader":  # noqa: A003
        self._format = f.lower()
        return self

    def parquet(self, path: str) -> "StreamingDataFrame":
        return StreamingDataFrame(self._session, path, "parquet",
                                  self._schema, self._options)

    def csv(self, path: str) -> "StreamingDataFrame":
        return StreamingDataFrame(self._session, path, "csv", self._schema,
                                  self._options)

    def load(self, path: str) -> "StreamingDataFrame":
        return StreamingDataFrame(self._session, path, self._format,
                                  self._schema, self._options)


class StreamingDataFrame:
    """An unbounded DataFrame: a source and recorded batch ops. Any
    DataFrame method called on it is recorded and replayed per
    micro-batch."""

    isStreaming = True

    def __init__(self, session, path: str, fmt: str,
                 schema: Optional[StructType], options: Dict[str, Any],
                 ops: Optional[List[Callable[[DataFrame], DataFrame]]] = None):
        if fmt not in ("parquet", "csv"):
            raise ValueError(f"unknown streaming source format {fmt!r} "
                             f"(parquet | csv)")
        self._session = session
        self._path = path
        self._fmt = fmt
        self._schema = schema
        self._options = options
        self._ops = ops or []
        self._ml_attrs: Dict[str, Any] = {}

    def _append(self, op: Callable[[DataFrame], DataFrame]
                ) -> "StreamingDataFrame":
        out = StreamingDataFrame(self._session, self._path, self._fmt,
                                 self._schema, self._options,
                                 self._ops + [op])
        out._ml_attrs = dict(self._ml_attrs)
        return out

    # the ML stages drive frames through these two hooks: recording them
    # lets `model.transform(stream)` and the feature stages run on every
    # micro-batch, as in MLE 00's streaming inference
    def _derive(self, fn, *args, **kwargs) -> "StreamingDataFrame":
        return self._append(lambda df: df._derive(fn, *args, **kwargs))

    def _derive_rowlocal(self, fn, *args, **kwargs) -> "StreamingDataFrame":
        return self._append(
            lambda df: df._derive_rowlocal(fn, *args, **kwargs))

    def __getattr__(self, item):
        if item.startswith("_") or item == "writeStream":
            raise AttributeError(item)

        def recorder(*args, **kwargs):
            def op(df: DataFrame) -> DataFrame:
                out = getattr(df, item)(*args, **kwargs)
                if not isinstance(out, DataFrame):
                    raise TypeError(f"streaming op {item} must return a "
                                    f"DataFrame")
                return out
            return self._append(op)

        return recorder

    @property
    def writeStream(self) -> "DataStreamWriter":
        return DataStreamWriter(self)

    # ----------------------------------------------------------- source
    def _list_files(self) -> List[str]:
        ext = {"parquet": ".parquet", "csv": ".csv"}[self._fmt]
        if os.path.isdir(self._path):
            out = []
            for root, _dirs, files in os.walk(self._path):
                for f in sorted(files):
                    if f.endswith(ext) and not f.startswith(("_", ".")):
                        out.append(os.path.join(root, f))
            return sorted(out)
        return sorted(glob.glob(self._path))

    def _read_files(self, files: List[str]) -> DataFrame:
        """One frame of the files' rows, a partition a file, each cast to
        the declared schema when there is one."""
        from ..frame import parquet as _pq
        from ..frame.io import read_csv_block
        parts = []
        for f in files:
            if self._fmt == "parquet":
                block = _pq.read_table(f)
            else:
                block = read_csv_block(f, ",", True, self._schema is None)
            if self._schema is not None:
                block = coerce_to_schema(block, self._schema)
            parts.append(block)
        return DataFrame.from_partitions(parts or [{}],
                                         session=self._session,
                                         schema=self._schema if parts
                                         else None)


class DataStreamWriter:
    def __init__(self, sdf: StreamingDataFrame):
        if not isinstance(sdf, StreamingDataFrame):
            raise TypeError("writeStream needs a streaming DataFrame "
                            "(spark.readStream...); a static frame "
                            "writes with .write")
        self._sdf = sdf
        self._format = "memory"
        self._output_mode = "append"
        self._options: Dict[str, Any] = {}
        self._query_name: Optional[str] = None
        self._trigger_once = False
        self._interval_s = 0.1

    def format(self, f: str) -> "DataStreamWriter":  # noqa: A003
        self._format = f.lower()
        return self

    def outputMode(self, m: str) -> "DataStreamWriter":
        self._output_mode = m
        return self

    def option(self, key: str, value) -> "DataStreamWriter":
        self._options[key] = value
        return self

    def queryName(self, name: str) -> "DataStreamWriter":
        self._query_name = name
        return self

    def trigger(self, once: bool = False,
                processingTime: Optional[str] = None,
                availableNow: bool = False) -> "DataStreamWriter":
        self._trigger_once = once or availableNow
        if processingTime:
            words = processingTime.split()
            unit = words[1] if len(words) > 1 else "seconds"
            self._interval_s = float(words[0]) * (
                60 if unit.startswith("min") else 1)
        return self

    def start(self, path: Optional[str] = None) -> "StreamingQuery":
        if path is not None:
            self._options.setdefault("path", path)
        q = StreamingQuery(self._sdf, self._format, self._output_mode,
                           self._options, self._query_name,
                           self._trigger_once, self._interval_s)
        with _lock:
            _active_queries.append(q)
        q._start()
        return q

    def toTable(self, name: str) -> "StreamingQuery":
        self._options["table"] = name
        return self.start()


class StreamingQuery:
    _next_id = 0

    def __init__(self, sdf: StreamingDataFrame, fmt: str, output_mode: str,
                 options: Dict[str, Any], name: Optional[str], once: bool,
                 interval_s: float):
        if fmt not in ("memory", "parquet", "csv", "json", "delta", "noop"):
            raise ValueError(f"unknown sink format {fmt}")
        with _lock:
            StreamingQuery._next_id += 1
            self.id = f"query-{StreamingQuery._next_id}"
        self.name = name or self.id
        self._sdf = sdf
        self._fmt = fmt
        self._options = options
        self._once = once
        self._interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.recentProgress: List[Dict[str, Any]] = []
        #: the memory sink's committed micro-batches, one block each
        self._mem_parts: List[dict] = []
        self._ckpt = options.get("checkpointLocation")
        self._processed = self._load_checkpoint()
        self._ckpt_dirty = False
        self._exception: Optional[BaseException] = None

    # --------------------- checkpoint (the recovery contract, MLE 00:75-85)
    def _load_checkpoint(self) -> set:
        path = os.path.join(self._ckpt or "", "processed.json")
        if self._ckpt and os.path.exists(path):
            with open(path) as fh:
                return set(json.load(fh))
        return set()

    def _save_checkpoint(self) -> None:
        if not self._ckpt:
            return
        os.makedirs(self._ckpt, exist_ok=True)
        tmp = os.path.join(self._ckpt, "processed.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(sorted(self._processed), fh)
        os.replace(tmp, os.path.join(self._ckpt, "processed.json"))

    def _start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sml-stream-{self.name}")
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                did = self._process_one_trigger()
                if self._once and not did:
                    break
                if not did:
                    self._stop.wait(max(self._interval_s, IDLE_POLL_S))
        except BaseException as e:  # noqa: BLE001 — kept: exception()
            self._exception = e
        finally:
            # a trigger interrupted between its sink write and its
            # checkpoint save still records the batch exactly once (the
            # dirty flag is raised after the write, lowered by the save),
            # so a resume never appends a committed batch again
            try:
                if self._ckpt_dirty:
                    self._save_checkpoint()
                    self._ckpt_dirty = False
            except Exception as e:  # noqa: BLE001 — kept: exception()
                if self._exception is None:
                    self._exception = e
            finally:
                # a failed flush must not leave the query active forever
                self._stop.set()

    def _process_one_trigger(self) -> bool:
        files = [f for f in self._sdf._list_files()
                 if f not in self._processed]
        if not files:
            return False
        per_trigger = int(self._sdf._options.get("maxFilesPerTrigger",
                                                 len(files)))
        batch_files = files[:max(1, per_trigger)]
        t0 = wallclock()
        df = self._sdf._read_files(batch_files)
        for op in self._sdf._ops:
            df = op(df)
        rows = self._write_batch(df)
        # the progress entry goes in before the files count as processed,
        # so `processAllAvailable` never returns with it missing
        self.recentProgress.append({
            "id": self.id, "name": self.name, "numInputRows": rows,
            "files": batch_files, "timestamp": wallclock(),
            "durationMs": (wallclock() - t0) * 1e3})
        # the write landed: from here the checkpoint must record the
        # batch even if a stop or an error comes before the save
        self._processed.update(batch_files)
        self._ckpt_dirty = True
        self._save_checkpoint()
        self._ckpt_dirty = False
        return True

    def _write_batch(self, df: DataFrame) -> int:
        """Append a micro-batch to the sink; returns its row count."""
        if self._fmt == "memory":
            block = df._whole()
            self._mem_parts.append(block)
            session = self._sdf._session
            session.catalog._register_view(
                self.name, DataFrame.from_partitions(
                    list(self._mem_parts), session=session))
            return df.count()
        if self._fmt == "noop":
            return df.count()
        df.write.format(self._fmt).mode("append").save(
            self._options["path"])
        return df.count()

    # ------------------------------------------------------------ control
    @property
    def isActive(self) -> bool:
        return not self._stop.is_set()

    def stop(self) -> None:
        """End the query and join its trigger thread (a trigger in flight
        finishes first)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def _raise_if_failed(self) -> None:
        # one load: the thread publishes `_exception` before `_stop`
        exc = self._exception
        if exc is not None:
            raise RuntimeError(f"streaming query {self.name!r} terminated "
                               f"with error") from exc

    def awaitTermination(self, timeout: Optional[float] = None) -> bool:
        """Wait for the query to end (True) or the timeout (False); a
        query that ended on a failed trigger raises its error."""
        self._stop.wait(timeout)
        if self._stop.is_set():
            self._raise_if_failed()
            return True
        return False

    def processAllAvailable(self) -> None:
        """Block until every file now in the source is processed; raise
        if the query ended on an error first."""
        while any(f not in self._processed
                  for f in self._sdf._list_files()):
            if not self.isActive:
                self._raise_if_failed()
                return
            self._stop.wait(0.01)
        self._raise_if_failed()

    def exception(self) -> Optional[BaseException]:
        return self._exception

    @property
    def lastProgress(self) -> Optional[Dict[str, Any]]:
        progress = self.recentProgress
        return progress[-1] if progress else None
