"""Delta-lite: a versioned table of parquet files and a JSON commit log.

The port's copy of `sml_tpu/delta/table.py`, on the port's own parquet
codec (`frame/parquet/`) where the JAX package uses pyarrow and pandas.
The layout and the log are the JAX package's, field for field, so that
each package reads the other's tables: `_delta_log/%020d.json` commits
of one JSON action a line (`commitInfo`, `metaData` with a
`schemaString` and `partitionColumns`, `add` and `remove`), and data in
`part-%05d-<uuid>.snappy.parquet` files, under `k=v` directories for a
partitioned table.

Covered: create / overwrite / append / ignore / error, `partitionBy`,
`overwriteSchema`, additive `mergeSchema` under append and overwrite
(`ML 05L`), time travel by `versionAsOf` and `timestampAsOf`,
`DeltaTable.forPath` / `isDeltaTable` / `toDF` / `history` / `delete`,
and `vacuum` with its retention guard
(`sml.delta.retentionDurationCheck.enabled`, or its `spark.databricks.*`
alias; `ML 00c:233-237`). Partition values read back as numbers where
they parse as numbers, as pandas' `to_numeric` reads them.
"""

from __future__ import annotations

import datetime as _dt
import glob
import json
import os
import re
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from ..conf import GLOBAL_CONF
from ..frame import parquet as _pq
from ..frame.column import Block, block_len, object_array
from ..frame.dataframe import DataFrame, concat_blocks
from ..utils.profiler import wallclock

LOG_DIR = "_delta_log"


def _log_path(table_path: str, version: int) -> str:
    return os.path.join(table_path, LOG_DIR, f"{version:020d}.json")


def _list_versions(table_path: str) -> List[int]:
    files = glob.glob(os.path.join(table_path, LOG_DIR, "*.json"))
    return sorted(int(os.path.basename(f)[:-5]) for f in files)


def _read_commit(table_path: str, version: int) -> List[Dict[str, Any]]:
    with open(_log_path(table_path, version)) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _commit_info(table_path: str, version: int) -> Dict[str, Any]:
    return next((a["commitInfo"] for a in _read_commit(table_path, version)
                 if "commitInfo" in a), {})


def _snapshot(table_path: str, version: int) -> Dict[str, Any]:
    """Replay the log up to `version`: the live files and the last
    metadata."""
    active: Dict[str, Dict[str, Any]] = {}
    meta: Dict[str, Any] = {}
    for v in [x for x in _list_versions(table_path) if x <= version]:
        for action in _read_commit(table_path, v):
            if "metaData" in action:
                meta = action["metaData"]
            elif "add" in action:
                active[action["add"]["path"]] = action["add"]
            elif "remove" in action:
                active.pop(action["remove"]["path"], None)
    return {"files": list(active.values()), "meta": meta}


def _write_commit(table_path: str, version: int,
                  actions: List[Dict[str, Any]]) -> None:
    os.makedirs(os.path.join(table_path, LOG_DIR), exist_ok=True)
    with open(_log_path(table_path, version), "w") as fh:
        for a in actions:
            fh.write(json.dumps(a) + "\n")


def _option_true(options: Dict[str, Any], key: str) -> bool:
    return str(options.get(key, "false")).lower() == "true"


def _now_ms() -> int:
    return int(wallclock() * 1000)


def write_delta(df: DataFrame, path: str, mode: str = "errorifexists",
                options: Optional[Dict[str, Any]] = None,
                partition_by: Optional[List[str]] = None) -> None:
    options = options or {}
    partition_by = partition_by or []
    versions = _list_versions(path)
    exists = bool(versions)
    if exists and mode in ("error", "errorifexists"):
        raise FileExistsError(f"Delta table already exists at {path}")
    if exists and mode == "ignore":
        return
    new_version = versions[-1] + 1 if exists else 0
    overwrite_schema = _option_true(options, "overwriteSchema")
    merge_schema = _option_true(options, "mergeSchema")
    new_cols = df.columns
    actions: List[Dict[str, Any]] = [{"commitInfo": {
        "timestamp": _now_ms(), "operation": "WRITE",
        "operationParameters": {"mode": mode.upper(),
                                "partitionBy": json.dumps(partition_by)},
        "version": new_version}}]
    if exists:
        prev = _snapshot(path, versions[-1])
        schema = prev["meta"].get("schemaString")
        prev_cols = [f["name"] for f in json.loads(schema)] if schema else []
        if prev_cols and set(new_cols) != set(prev_cols):
            additive = set(prev_cols) <= set(new_cols)
            # additive evolution under mergeSchema is allowed for append
            # and overwrite (ML 05L overwrites with a new column);
            # anything else under overwrite needs overwriteSchema
            if mode == "overwrite" and not overwrite_schema and \
                    not (merge_schema and additive):
                raise ValueError(
                    "A schema mismatch detected when writing to the Delta "
                    "table. To overwrite your schema, set "
                    "option('overwriteSchema', 'true').")
            if mode == "append" and not merge_schema:
                raise ValueError(
                    "A schema mismatch detected when writing to the Delta "
                    "table. To merge the new schema, set "
                    "option('mergeSchema', 'true').")
        if mode == "overwrite":
            for f in prev["files"]:
                actions.append({"remove": {"path": f["path"],
                                           "deletionTimestamp": _now_ms()}})
    actions.append({"metaData": {
        "id": str(uuid.uuid4()),
        "schemaString": json.dumps([{"name": c, "type": t}
                                    for c, t in df.dtypes]),
        "partitionColumns": partition_by, "createdTime": _now_ms()}})

    os.makedirs(path, exist_ok=True)
    parts = df._materialize()

    def add(rel: str, body: Block, values: Dict[str, str]) -> None:
        _pq.write_table(body, os.path.join(path, rel))
        actions.append({"add": {
            "path": rel, "size": os.path.getsize(os.path.join(path, rel)),
            "partitionValues": values, "modificationTime": _now_ms(),
            "numRecords": block_len(body), "dataChange": True}})

    if partition_by:
        from ..frame.io import partition_groups
        for texts, body in partition_groups(concat_blocks(parts),
                                            partition_by):
            reldir = "/".join(f"{k}={t}" for k, t in zip(partition_by,
                                                         texts))
            os.makedirs(os.path.join(path, reldir), exist_ok=True)
            add(f"{reldir}/part-{uuid.uuid4().hex[:12]}.snappy.parquet",
                body, dict(zip(partition_by, texts)))
    else:
        for i, p in enumerate(parts):
            add(f"part-{i:05d}-{uuid.uuid4().hex[:12]}.snappy.parquet", p,
                {})
    _write_commit(path, new_version, actions)


_TS = re.compile(r"(\d{4})-(\d{2})-(\d{2})(?:[ T](\d{2}):(\d{2})"
                 r"(?::(\d{2})(?:\.(\d{1,9}))?)?)?"
                 r"\s*(Z|[+-]\d{2}:?\d{2})?")


def timestamp_ms(value) -> float:
    """Epoch milliseconds of a `timestampAsOf` value, as the JAX
    package's `pd.Timestamp(value).timestamp() * 1000` reads it (a time
    without an offset is UTC): ISO text ("2024-05-01", "2024-05-01
    12:30", "2024-05-01T12:30:05.123456", with an optional "Z" or
    "+hh:mm"), a `datetime` or `date`, or a numpy datetime64 (what
    `history()` gives). ValueError for anything else."""
    if isinstance(value, np.datetime64):
        if np.isnat(value):
            raise ValueError("timestampAsOf: NaT")
        return value.astype("datetime64[us]").astype(np.int64) / 1000.0
    if isinstance(value, _dt.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=_dt.timezone.utc)
        return value.timestamp() * 1000
    if isinstance(value, _dt.date):
        return timestamp_ms(_dt.datetime(value.year, value.month,
                                         value.day))
    m = _TS.fullmatch(str(value).strip()) if isinstance(value, str) \
        else None
    if m is None:
        raise ValueError(f"timestampAsOf: cannot parse {value!r} (give "
                         f"'YYYY-MM-DD[ HH:MM[:SS[.ffffff]]]')")
    y, mo, d, h, mi, s, frac, tz = m.groups()
    frac = (frac or "").ljust(9, "0")
    t = _dt.datetime(int(y), int(mo), int(d), int(h or 0), int(mi or 0),
                     int(s or 0), tzinfo=_dt.timezone.utc)
    ms = (t - _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)) \
        // _dt.timedelta(microseconds=1) / 1000.0 + int(frac) / 1e6
    if tz and tz != "Z":
        sign = 1 if tz[0] == "+" else -1
        hh, mm = int(tz[1:3]), int(tz[-2:])
        ms -= sign * (hh * 60 + mm) * 60_000
    return ms


_INT_TEXT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT_TEXT = re.compile(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*"
                         r"|\s*[+-]?(inf|infinity)\s*|", re.I)


def _partition_column(text: str, n: int) -> np.ndarray:
    """A partition value as a column of n rows, as pandas' `to_numeric`
    reads the text: int64 for an integer, float64 for a decimal number,
    an infinity or the empty text (NaN), else the text itself ("nan" is
    text to pandas)."""
    if _INT_TEXT.fullmatch(text):
        return np.full(n, int(text), np.int64)
    if _FLOAT_TEXT.fullmatch(text):
        return np.full(n, float(text) if text.strip() else np.nan)
    return object_array([text] * n)


def read_delta(path: str, session, options: Dict[str, Any]) -> DataFrame:
    versions = _list_versions(path)
    if not versions:
        raise FileNotFoundError(f"{path} is not a Delta table")
    version = versions[-1]
    if "versionAsOf" in options:
        version = int(options["versionAsOf"])
        if version not in versions:
            raise ValueError(f"Cannot time travel to version {version}; "
                             f"available: {versions}")
    elif "timestampAsOf" in options:
        ts = timestamp_ms(options["timestampAsOf"])
        eligible = [v for v in versions
                    if _commit_info(path, v).get("timestamp", 0) <= ts]
        if not eligible:
            raise ValueError(f"No version of the table at or before "
                             f"{options['timestampAsOf']}")
        version = eligible[-1]
    parts = []
    for f in _snapshot(path, version)["files"]:
        block = _pq.read_table(os.path.join(path, f["path"]))
        n = block_len(block)
        for k, v in f.get("partitionValues", {}).items():
            block[k] = _partition_column(v, n)
        parts.append(block)
    return DataFrame.from_partitions(parts or [{}], session=session)


class DeltaTable:
    """`delta.tables.DeltaTable`: forPath, history, vacuum, delete
    (`ML 00c:184,233-237`)."""

    def __init__(self, session, path: str):
        self._session = session
        self._path = path

    @classmethod
    def forPath(cls, session, path: str) -> "DeltaTable":
        if not _list_versions(path):
            raise FileNotFoundError(f"{path} is not a Delta table")
        return cls(session, path)

    @classmethod
    def isDeltaTable(cls, _session, path: str) -> bool:
        return bool(_list_versions(path))

    def toDF(self) -> DataFrame:
        return read_delta(self._path, self._session, {})

    def history(self, limit: Optional[int] = None) -> DataFrame:
        """The commits, newest first: version, timestamp (datetime64
        [ms]), operation and the JSON of its parameters."""
        infos = [(v, _commit_info(self._path, v))
                 for v in reversed(_list_versions(self._path))]
        if limit:
            infos = infos[:limit]
        block = {
            "version": np.asarray([v for v, _ in infos], np.int64),
            "timestamp": np.asarray([i.get("timestamp", 0) for _, i in infos],
                                    np.int64).astype("datetime64[ms]"),
            "operation": object_array([i.get("operation", "WRITE")
                                       for _, i in infos]),
            "operationParameters": object_array(
                [json.dumps(i.get("operationParameters", {}))
                 for _, i in infos])}
        return DataFrame.from_block(block, session=self._session,
                                    num_partitions=1)

    def vacuum(self, retentionHours: float = 168.0) -> None:
        """Delete the data files the latest version no longer uses.
        Below the 168-hour default the retention check must be off, as
        the course shows (`ML 00c:233-237`)."""
        if retentionHours < 168.0 and GLOBAL_CONF.getBool(
                "sml.delta.retentionDurationCheck.enabled"):
            raise ValueError(
                "requirement failed: Are you sure you would like to vacuum "
                "files with such a low retention period? ... Set "
                "sml.delta.retentionDurationCheck.enabled to false to "
                "disable this check.")
        latest = _snapshot(self._path, _list_versions(self._path)[-1])
        live = {f["path"] for f in latest["files"]}
        cutoff = wallclock() - retentionHours * 3600
        for root, _dirs, files in os.walk(self._path):
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, self._path).replace(os.sep, "/")
                if rel.startswith(LOG_DIR) or rel in live or \
                        not f.endswith(".parquet"):
                    continue
                if os.path.getmtime(full) <= cutoff or retentionHours == 0:
                    os.remove(full)

    def delete(self, condition: Optional[str] = None) -> None:
        """Remove the rows matching `condition` (every row without
        one) in a new version."""
        from ..frame.column import LitColumn
        from ..frame.sql import parse_simple_expr
        df = self.toDF()
        # no condition keeps the columns (Spark's); the JAX package's
        # limit(0) drops them, and its write then refuses the schema
        keep = ~parse_simple_expr(condition) if condition is not None \
            else LitColumn(False)
        write_delta(df.filter(keep), self._path, mode="overwrite")
