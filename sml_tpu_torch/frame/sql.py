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
`delta.`path`` references, time travel and DESCRIBE HISTORY wait for
ROADMAP item 9.
"""

from __future__ import annotations

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
_NEEDS_DELTA = ("delta tables (delta.`path`, time travel, DESCRIBE "
                "HISTORY) wait for ROADMAP item 9 (parquet)")


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
    if re.match(r"describe\s+history\s", ql):
        raise NotImplementedError(_NEEDS_DELTA)
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


def _run_select(session: "TpuSession", st: dict, q: str):
    from .dataframe import DataFrame
    if _DELTA_REF.search(q) or re.search(
            r"\s(version|timestamp)\s+as\s+of\s", q, re.I):
        raise NotImplementedError(_NEEDS_DELTA)
    q2 = q
    for name, df in session.catalog._views().items():
        if re.search(rf"\b{re.escape(name)}\b", q2, re.I):
            _materialize_cached(st, name, df, df._whole)
    for fqname, (path, fmt) in session.catalog._tables().items():
        short = fqname.split(".")[-1]
        for candidate in (fqname, short):
            if re.search(rf"\b{re.escape(candidate)}\b", q2, re.I):
                tbl = candidate.replace(".", "_")
                _materialize_cached(
                    st, tbl, (path, _path_mtime(path)),
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
    import os
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
