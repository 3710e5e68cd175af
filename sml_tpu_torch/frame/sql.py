"""`spark.sql`, temp views and the catalog statements, on sqlite3.

The port's copy of `sml_tpu/frame/sql.py`. `createOrReplaceTempView` +
`spark.sql` (`ML 00b:59-64`, `MLE 01:240-251`) run against an in-memory
sqlite database of the session into which the referenced views and
catalog tables are loaded (again only when the relation changed). The
JAX package moves rows through pandas (`to_sql`, `read_sql_query`);
the port moves them from its numpy columns with `executemany` and back
from the cursor, with pandas' rules: a column's declared type follows
its dtype (an integer column holding a NULL is REAL), a result column of
integers is int64, of integers and NULLs float64, of text object.
``delta.`path` `` references (with the `@vN` version shorthand), `VERSION
AS OF` / `TIMESTAMP AS OF` on a path or a registered table, and
`DESCRIBE HISTORY` read through `delta/table.py`. A Delta snapshot is
loaded under the JAX package's token, (path, version) or (path, kind,
value) for time travel, with the mtime of the table's newest commit
file added, so that a table dropped and written again at the same path
is loaded again; dropping a table also drops every relation loaded from
its path (`invalidate_cached_path`).
"""

from __future__ import annotations

import os
import re
import sqlite3
import threading
from typing import TYPE_CHECKING, List

import numpy as np

from ..native.hashing import null_mask
from .column import Block, Column, LitColumn, NamedColumn, block_len, \
    infer_objects, object_array

if TYPE_CHECKING:
    from .session import TpuSession


class _ExprNamespace(dict):
    """Identifier -> NamedColumn / function resolution for expression
    strings."""

    def __missing__(self, key):
        from . import functions as F
        fn = getattr(F, key, None)
        if fn is not None and not key.startswith("_"):
            return fn
        return NamedColumn(key)


def parse_simple_expr(expr: str) -> Column:
    """Translate a SQL-ish expression ('price > 0 AND bedrooms = 2',
    'log(price) as log_price') into a Column via restricted eval."""
    s = expr.strip()
    alias = None
    m = re.search(r"\s+[aA][sS]\s+([A-Za-z_][A-Za-z0-9_]*)\s*$", s)
    if m:
        alias = m.group(1)
        s = s[:m.start()]
    # SQL -> Python operator translation
    s = re.sub(r"(?<![<>!=])=(?!=)", "==", s)
    s = re.sub(r"<>", "!=", s)
    s = re.sub(r"\bAND\b", "&", s, flags=re.I)
    s = re.sub(r"\bOR\b", "|", s, flags=re.I)
    s = re.sub(r"\bNOT\b", "~", s, flags=re.I)
    s = re.sub(r"\bIS\s+~\s*NULL\b", ".isNotNull()", s, flags=re.I)
    s = re.sub(r"\bIS\s+NULL\b", ".isNull()", s, flags=re.I)
    s = re.sub(r"`([^`]*)`", r"col('\1')", s)
    # parenthesize comparison clauses joined by top-level & / |, so that
    # Python's precedence (& binds tighter than >=) does not bite
    s = _parenthesize_clauses(s)
    out = eval(s, {"__builtins__": {}}, _ExprNamespace())  # noqa: S307
    if not isinstance(out, Column):
        out = LitColumn(out)
    if alias:
        out = out.alias(alias)
    return out


def _parenthesize_clauses(s: str) -> str:
    """Split on top-level & / | and wrap each clause in parens."""
    parts, ops = [], []
    depth, start = 0, 0
    for i, ch in enumerate(s):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch in "&|" and depth == 0:
            parts.append(s[start:i])
            ops.append(ch)
            start = i + 1
    parts.append(s[start:])
    if not ops:
        return s
    out = f"({parts[0].strip()})"
    for op, p in zip(ops, parts[1:]):
        out += f" {op} ({p.strip()})"
    return out


_DELTA_REF = re.compile(r"delta\.`([^`]+)`", re.I)


def _session_sql_state(session) -> dict:
    """The session's sqlite store: one connection, the token each loaded
    relation was loaded from, and a lock (the connection is shared by
    the session's threads)."""
    st = getattr(session, "_sql_state", None)
    if st is None:
        st = {"con": sqlite3.connect(":memory:", check_same_thread=False),
              "tokens": {}, "lock": threading.RLock()}
        session._sql_state = st
    return st


def invalidate_cached_relation(session, name: str) -> None:
    """Drop a loaded relation from the session's store, so that a query
    on a dropped view errors instead of reading the stale copy."""
    st = getattr(session, "_sql_state", None)
    if st is None:
        return
    with st["lock"]:
        st["tokens"].pop(name, None)
        st["con"].execute(f'DROP TABLE IF EXISTS "{name}"')


def invalidate_cached_path(session, path: str) -> None:
    """Drop every relation loaded from the table at `path` (its `_tt_*`
    time travel and `_delta_*` snapshots): their tokens start with the
    path."""
    st = getattr(session, "_sql_state", None)
    if st is None:
        return
    with st["lock"]:
        stale = [n for n, tok in st["tokens"].items()
                 if isinstance(tok, tuple) and tok and tok[0] == path]
        for n in stale:
            st["tokens"].pop(n, None)
            st["con"].execute(f'DROP TABLE IF EXISTS "{n}"')


def _materialize_cached(st, name: str, token, loader) -> None:
    """Load `name` into the session's store unless the same `token`
    already did: frames compare by identity, (path, mtime) tuples by
    equality. The caller holds st["lock"]."""
    prev = st["tokens"].get(name)
    same = prev is token if not isinstance(token, tuple) else prev == token
    if same:
        return
    _to_sqlite(loader(), name, st["con"])
    st["tokens"][name] = token


def run_sql(session: "TpuSession", query: str):
    from .dataframe import DataFrame

    q = query.strip().rstrip(";")
    ql = q.lower()

    # --- DDL / catalog statements -----------------------------------------
    if re.match(r"create\s+database\s", ql):
        name = re.match(r"create\s+database\s+(?:if\s+not\s+exists\s+)?"
                        r"([\w`]+)", q, re.I).group(1).strip("`")
        session.catalog._create_database(name)
        return _empty(session)
    if re.match(r"drop\s+database\s", ql):
        name = re.match(r"drop\s+database\s+(?:if\s+exists\s+)?([\w`]+)", q,
                        re.I).group(1).strip("`")
        session.catalog._drop_database(name)
        return _empty(session)
    if ql.startswith("use "):
        session.catalog._use_database(q.split()[-1].strip("`"))
        return _empty(session)
    if ql.startswith("drop table"):
        session.catalog._drop_table(q.split()[-1].strip("`"))
        return _empty(session)
    if ql.startswith("show tables"):
        rows = session.catalog._list_tables()
        block = {} if not rows else {
            "database": object_array([d for d, _, _ in rows]),
            "tableName": object_array([t for _, t, _ in rows]),
            "isTemporary": np.asarray([tmp for _, _, tmp in rows])}
        return DataFrame.from_block(block, session=session,
                                    num_partitions=1)
    m = re.match(r"describe\s+history\s+(.*)", q, re.I)
    if m:
        from ..delta.table import DeltaTable
        target = m.group(1).strip()
        dm = _DELTA_REF.match(target)
        path = dm.group(1) if dm else \
            session.catalog._table_path(target.strip("`"))
        return DeltaTable.forPath(session, path).history()
    m = re.match(r"describe\s+(detail\s+)?(.*)", q, re.I)
    if m and not ql.startswith("describe select"):
        df = session.table(m.group(2).strip().strip("`"))
        types = df.dtypes
        block = {"col_name": object_array([n for n, _ in types]),
                 "data_type": object_array([t for _, t in types]),
                 "comment": object_array([None] * len(types))}
        return DataFrame.from_block(block, session=session,
                                    num_partitions=1)

    # --- SELECT via the session's sqlite store ----------------------------
    st = _session_sql_state(session)
    with st["lock"]:
        return _run_select(session, st, q)


def _log_stamp(path: str) -> tuple:
    """(the latest version, its commit file's mtime in ns) of the Delta
    table at `path`; (-1, 0) where there is none."""
    from ..delta.table import _list_versions, _log_path
    vs = _list_versions(path)
    if not vs:
        return -1, 0
    return vs[-1], os.stat(_log_path(path, vs[-1])).st_mtime_ns


def _run_select(session: "TpuSession", st: dict, q: str):
    from ..delta.table import read_delta
    from .dataframe import DataFrame

    # time travel in SELECT (`ML 00c:184-209`): `delta.`p` VERSION AS OF
    # n` / `TIMESTAMP AS OF 'ts'`, also on registered table names
    def repl_travel(m_):
        target, kind, value = m_.group(1), m_.group(2), m_.group(3)
        dm = _DELTA_REF.match(target)
        path = dm.group(1) if dm else \
            session.catalog._table_path(target.strip("`"))
        key = "versionAsOf" if kind.lower().startswith("version") \
            else "timestampAsOf"
        tbl = "_tt_" + re.sub(r"\W", "_", f"{path}_{kind[0]}_{value}")
        _materialize_cached(
            st, tbl, (path, kind.lower(), str(value), _log_stamp(path)),
            lambda: read_delta(path, session,
                               {key: value.strip("'\"")})._whole())
        return tbl

    q2 = re.sub(
        r"(delta\.`[^`]+`|[\w.`]+)\s+(version|timestamp)\s+as\s+of\s+"
        r"('[^']*'|\"[^\"]*\"|\d+)", repl_travel, q, flags=re.I)

    # delta.`path` references, with the delta.`path@vN` shorthand
    def repl(m_):
        path = m_.group(1)
        opts = {}
        at = re.search(r"@v(\d+)$", path)
        if at:
            path = path[:at.start()]
            opts["versionAsOf"] = int(at.group(1))
        tbl = "_delta_" + re.sub(r"\W", "_", m_.group(1))
        latest, stamp = _log_stamp(path)
        _materialize_cached(
            st, tbl, (path, opts.get("versionAsOf", latest), stamp),
            lambda: read_delta(path, session, opts)._whole())
        return tbl

    q2 = _DELTA_REF.sub(repl, q2)
    for name, df in session.catalog._views().items():
        if re.search(rf"\b{re.escape(name)}\b", q2, re.I):
            _materialize_cached(st, name, df, df._whole)
    for fqname, (path, fmt) in session.catalog._tables().items():
        short = fqname.split(".")[-1]
        for candidate in (fqname, short):
            if re.search(rf"\b{re.escape(candidate)}\b", q2, re.I):
                tbl = candidate.replace(".", "_")
                token = (path,) + _log_stamp(path) if fmt == "delta" \
                    else (path, _path_mtime(path))
                _materialize_cached(
                    st, tbl, token,
                    lambda fq=fqname: session.table(fq)._whole())
                q2 = re.sub(rf"\b{re.escape(candidate)}\b", tbl, q2)
                break
    cur = st["con"].execute(q2)
    names = [d[0] for d in cur.description or ()]
    rows = cur.fetchall()
    block = {n: infer_objects(object_array([r[i] for r in rows]))
             for i, n in enumerate(names)}
    return DataFrame.from_block(block, session=session)


def _path_mtime(path: str) -> float:
    """The newest file mtime under `path` (0.0 for a missing path)."""
    if not os.path.isdir(path):
        return os.path.getmtime(path) if os.path.exists(path) else 0.0
    newest = 0.0
    for root, _dirs, files in os.walk(path):
        for f in files:
            newest = max(newest, os.path.getmtime(os.path.join(root, f)))
    return newest


_PRIMITIVES = (type(None), str, bytes, bool, int, float)


def _sql_type(v: np.ndarray) -> str:
    """The column type pandas' `to_sql` declares for a column."""
    if v.ndim == 2:
        return "TEXT"
    kind = v.dtype.kind
    if kind in "iub":
        return "INTEGER"
    if kind == "f":
        return "REAL"
    if kind == "M":
        return "TIMESTAMP"
    vals = v[~null_mask(v)].tolist()
    for types, name in (((bool,), "INTEGER"), ((int,), "INTEGER"),
                        ((float,), "REAL")):
        if vals and all(isinstance(x, types) and (types == (bool,) or
                                                  not isinstance(x, bool))
                        for x in vals):
            return name
    return "TEXT"


def _sql_values(v: np.ndarray) -> List:
    """A column's cells as sqlite3 binds them, as pandas' `to_sql` hands
    them over: NULL as None, numpy scalars as Python ones, datetimes as
    ISO text, vectors and other objects as their text."""
    if v.ndim == 2:
        from ..ml.linalg import DenseVector
        return [str(DenseVector(r)) for r in v]
    nulls = null_mask(v)
    if v.dtype.kind == "M":
        return [None if nulls[i] else x.isoformat(" ")
                for i, x in enumerate(v.astype("datetime64[us]").tolist())]
    return [None if nulls[i] else x if isinstance(x, _PRIMITIVES)
            else x.item() if isinstance(x, np.generic) else str(x)
            for i, x in enumerate(v.tolist())]


def _to_sqlite(block: Block, name: str, con) -> None:
    cols = list(block)
    con.execute(f'DROP TABLE IF EXISTS "{name}"')
    decl = ", ".join(f'"{c}" {_sql_type(block[c])}' for c in cols)
    con.execute(f'CREATE TABLE "{name}" ({decl})')
    if cols and block_len(block):
        marks = ", ".join("?" * len(cols))
        con.executemany(f'INSERT INTO "{name}" VALUES ({marks})',
                        zip(*[_sql_values(block[c]) for c in cols]))


def _empty(session):
    from .dataframe import DataFrame
    return DataFrame.from_block({}, session=session, num_partitions=1)
