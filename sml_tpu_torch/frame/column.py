"""Column expressions evaluated per partition against numpy blocks.

The port's copy of `sml_tpu/frame/column.py`. A block is a dict of
equal-length numpy arrays (a vector column is one 2-D float64 array).
Each Column carries an eval function ``(block, ctx) -> array | scalar``,
so a whole expression tree runs vectorized on a partition; a scalar
result broadcasts to the block's rows. Partition-aware expressions
(rand, monotonically_increasing_id) read the EvalContext.

SQL NULL is NaN in a float column and None in an object column, as in
the JAX package's pandas blocks; comparisons with NULL are false, and
`&`, `|` and `~` read NULL as false.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..native.hashing import null_mask
from .types import DataType, parse_type

Block = Dict[str, np.ndarray]


@dataclass
class EvalContext:
    partition_index: int = 0
    n_partitions: int = 1
    row_offset: int = 0  # global row index of the partition's first row


def block_len(block: Block) -> int:
    """Rows of a block (0 for a block with no columns)."""
    for v in block.values():
        return len(v)
    return 0


def object_array(values) -> np.ndarray:
    """A 1-D object array holding `values` as they are (a list of
    vectors stays a list of vectors)."""
    values = list(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def as_array(v, n: int) -> np.ndarray:
    """`v` as a column of n rows: arrays pass, scalars broadcast."""
    if isinstance(v, np.ndarray):
        return v
    if v is None or isinstance(v, str):
        return object_array([v] * n)
    return np.full(n, v)


def infer_objects(values: np.ndarray) -> np.ndarray:
    """pandas' `infer_objects` on an object column: booleans alone ->
    bool; numbers (no booleans) -> int64, or float64 with NaN for NULL;
    anything else stays an object column with None for NULL."""
    nulls = null_mask(values)
    vals = values[~nulls]
    if len(vals) and all(isinstance(v, (bool, np.bool_)) for v in vals):
        return values.astype(bool) if not nulls.any() else values
    if len(vals) and all(isinstance(v, (int, float, np.integer, np.floating))
                         and not isinstance(v, (bool, np.bool_))
                         for v in vals):
        if not nulls.any() and all(isinstance(v, (int, np.integer))
                                   for v in vals):
            return values.astype(np.int64)
        out = np.full(len(values), np.nan)
        out[~nulls] = vals.astype(np.float64)
        return out
    out = values.copy()
    out[nulls] = None
    return out


def _parse_float(v) -> float:
    if v is None:
        return np.nan
    try:
        return float(v)
    except (TypeError, ValueError):
        return np.nan


def to_numeric(values: np.ndarray) -> np.ndarray:
    """`pd.to_numeric(values, errors="coerce")`: numeric columns pass;
    an object column parses each value as a float, NaN where it cannot."""
    if values.dtype.kind in "fiub":
        return values
    out = np.fromiter((_parse_float(v) for v in values), dtype=np.float64,
                      count=len(values))
    if not np.isnan(out).any() and all(
            isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            for v in values):
        return out.astype(np.int64)
    return out


def truthy(values: np.ndarray) -> np.ndarray:
    """`fillna(False).astype(bool)`: NULL reads as false."""
    if values.dtype.kind == "b":
        return values
    if values.dtype.kind == "f":
        return (values != 0) & ~np.isnan(values)
    if values.dtype.kind in "iu":
        return values != 0
    return np.fromiter((False if v is None or (isinstance(v, float) and v != v)
                        else bool(v) for v in values), dtype=bool,
                       count=len(values))


def _compare(op):
    """An elementwise comparison: numpy's for numeric columns; for an
    object column, value by value with NULL comparing false (pandas)."""
    def fn(a, b):
        if a.dtype.kind != "O" and b.dtype.kind != "O":
            return op(a, b)
        na, nb = null_mask(a), null_mask(b)
        out = np.zeros(len(a), dtype=bool)
        for i in np.flatnonzero(~(na | nb)):
            out[i] = op(a[i], b[i])
        if op is operator.ne:
            out |= na | nb
        return out
    return fn


class Column:
    def __init__(self, eval_fn: Callable[[Block, EvalContext], Any],
                 name: str, *,
                 agg: Optional[Callable[[np.ndarray], Any]] = None,
                 sort_desc: Optional[bool] = None,
                 children: Optional[List["Column"]] = None):
        self._eval_fn = eval_fn
        self._name = name
        self._agg = agg            # set => aggregate column
        self._sort_desc = sort_desc
        self._children = children or []

    # -- evaluation --
    def _eval(self, block: Block, ctx: Optional[EvalContext] = None
              ) -> np.ndarray:
        out = self._eval_fn(block, ctx or EvalContext())
        return as_array(out, block_len(block))

    # -- naming --
    def alias(self, name: str) -> "Column":
        return Column(self._eval_fn, name, agg=self._agg,
                      sort_desc=self._sort_desc, children=self._children)

    name = alias

    # -- operator helpers --
    def _bin(self, other, fn, sym, reverse=False) -> "Column":
        other_c = other if isinstance(other, Column) else LitColumn(other)

        def ev(block, ctx):
            a = self._eval(block, ctx)
            b = other_c._eval(block, ctx)
            with np.errstate(all="ignore"):
                return fn(b, a) if reverse else fn(a, b)

        l, r = (other_c._name, self._name) if reverse \
            else (self._name, other_c._name)
        return Column(ev, f"({l} {sym} {r})")

    def __add__(self, o):
        return self._bin(o, operator.add, "+")

    def __radd__(self, o):
        return self._bin(o, operator.add, "+", reverse=True)

    def __sub__(self, o):
        return self._bin(o, operator.sub, "-")

    def __rsub__(self, o):
        return self._bin(o, operator.sub, "-", reverse=True)

    def __mul__(self, o):
        return self._bin(o, operator.mul, "*")

    def __rmul__(self, o):
        return self._bin(o, operator.mul, "*", reverse=True)

    def __truediv__(self, o):
        return self._bin(o, operator.truediv, "/")

    def __rtruediv__(self, o):
        return self._bin(o, operator.truediv, "/", reverse=True)

    def __neg__(self):
        return Column(lambda b, ctx: -self._eval(b, ctx), f"(- {self._name})")

    def __pow__(self, o):
        return self._bin(o, operator.pow, "**")

    def __mod__(self, o):
        return self._bin(o, operator.mod, "%")

    def __eq__(self, o):  # type: ignore[override]
        return self._bin(o, _compare(operator.eq), "=")

    def __ne__(self, o):  # type: ignore[override]
        return self._bin(o, _compare(operator.ne), "!=")

    def __lt__(self, o):
        return self._bin(o, _compare(operator.lt), "<")

    def __le__(self, o):
        return self._bin(o, _compare(operator.le), "<=")

    def __gt__(self, o):
        return self._bin(o, _compare(operator.gt), ">")

    def __ge__(self, o):
        return self._bin(o, _compare(operator.ge), ">=")

    def __and__(self, o):
        return self._bin(o, lambda a, b: truthy(a) & truthy(b), "AND")

    def __or__(self, o):
        return self._bin(o, lambda a, b: truthy(a) | truthy(b), "OR")

    def __invert__(self):
        return Column(lambda b, ctx: ~truthy(self._eval(b, ctx)),
                      f"(NOT {self._name})")

    def __hash__(self):
        return id(self)

    # -- null / membership --
    def isNull(self) -> "Column":
        return Column(lambda b, ctx: null_mask(self._eval(b, ctx)),
                      f"({self._name} IS NULL)")

    def isNotNull(self) -> "Column":
        return Column(lambda b, ctx: ~null_mask(self._eval(b, ctx)),
                      f"({self._name} IS NOT NULL)")

    def isin(self, *values) -> "Column":
        vals = list(values[0]) if len(values) == 1 and \
            isinstance(values[0], (list, tuple, set)) else list(values)

        def ev(b, ctx):
            a = self._eval(b, ctx)
            return np.fromiter((v in vals for v in a.tolist()), dtype=bool,
                               count=len(a))
        return Column(ev, f"({self._name} IN ...)")

    def between(self, low, high) -> "Column":
        return (self >= low) & (self <= high)

    # -- strings --
    def _str_pred(self, pred, label: str) -> "Column":
        def ev(b, ctx):
            a = self._eval(b, ctx)
            nulls = null_mask(a)
            return np.fromiter((not nulls[i] and pred(str(v))
                                for i, v in enumerate(a)),
                               dtype=bool, count=len(a))
        return Column(ev, label)

    def contains(self, sub: str) -> "Column":
        return self._str_pred(lambda s: sub in s,
                              f"contains({self._name}, {sub})")

    def startswith(self, p: str) -> "Column":
        return self._str_pred(lambda s: s.startswith(p),
                              f"startswith({self._name}, {p})")

    def endswith(self, p: str) -> "Column":
        return self._str_pred(lambda s: s.endswith(p),
                              f"endswith({self._name}, {p})")

    def like(self, pattern: str) -> "Column":
        import re
        rx = re.compile("^" + pattern.replace("%", ".*").replace("_", ".")
                        + "$")
        return self._str_pred(lambda s: rx.match(s) is not None,
                              f"({self._name} LIKE {pattern})")

    def substr(self, start: int, length: int) -> "Column":
        def ev(b, ctx):
            a = self._eval(b, ctx)
            nulls = null_mask(a)
            return object_array(None if nulls[i]
                                else str(v)[start - 1:start - 1 + length]
                                for i, v in enumerate(a))
        return Column(ev, f"substr({self._name}, {start}, {length})")

    # -- cast --
    def cast(self, to) -> "Column":
        t: DataType = parse_type(to) if isinstance(to, str) else to

        def ev(b, ctx):
            return cast_values(self._eval(b, ctx), t.simpleString())

        return Column(ev, f"CAST({self._name} AS {t.simpleString()})")

    astype = cast

    # -- when/otherwise chaining: only valid on CaseWhenColumn --
    def otherwise(self, value) -> "Column":
        raise TypeError("otherwise() can only follow when(); use "
                        "functions.when(...)")

    def when(self, condition: "Column", value) -> "Column":
        raise TypeError("when() chaining can only follow functions.when(...)")

    # -- sort order --
    def desc(self) -> "Column":
        return Column(self._eval_fn, self._name, agg=self._agg,
                      sort_desc=True)

    def asc(self) -> "Column":
        return Column(self._eval_fn, self._name, agg=self._agg,
                      sort_desc=False)

    def __repr__(self):
        return f"Column<'{self._name}'>"


def cast_values(s: np.ndarray, tn: str) -> np.ndarray:
    """SQL CAST of a column to the type named `tn` (simpleString)."""
    if tn in ("double", "float"):
        out = to_numeric(s).astype(np.float64)
        return out if tn == "double" else out.astype(np.float32)
    if tn in ("int", "bigint"):
        out = to_numeric(s)
        # Spark's cast truncates toward zero; nulls stay null
        if out.dtype.kind == "f" and np.isnan(out).any():
            return np.trunc(out)
        return out.astype(np.int64 if tn == "bigint" else np.int32)
    if tn == "boolean":
        return cast_to_boolean(s)
    if tn == "string":
        nulls = null_mask(s)
        return object_array(None if nulls[i] else str(v)
                            for i, v in enumerate(s.tolist()))
    if tn == "timestamp":
        return s.astype("datetime64[us]")
    return s


class CaseWhenColumn(Column):
    """First-match CASE WHEN semantics: a matched branch keeps its value
    even when that value is null (null is not an 'unmatched' marker)."""

    def __init__(self, branches, otherwise_col: Optional[Column] = None,
                 name=None):
        self._branches = list(branches)  # [(cond Column, value Column)]
        self._otherwise = otherwise_col
        label = name or ("CASE " + " ".join(
            f"WHEN {c._name} THEN {v._name}" for c, v in self._branches) +
            (f" ELSE {self._otherwise._name}" if self._otherwise else "")
            + " END")
        super().__init__(self._eval_case, label)

    def _eval_case(self, block: Block, ctx: EvalContext):
        n = block_len(block)
        result = object_array([None] * n)
        matched = np.zeros(n, dtype=bool)
        for cond, val in self._branches:
            sel = truthy(cond._eval(block, ctx)) & ~matched
            if sel.any():
                result[sel] = val._eval(block, ctx)[sel]
            matched |= sel
        if self._otherwise is not None:
            rest = ~matched
            if rest.any():
                result[rest] = self._otherwise._eval(block, ctx)[rest]
        return infer_objects(result)

    def when(self, condition: Column, value) -> "CaseWhenColumn":
        val_c = value if isinstance(value, Column) else LitColumn(value)
        return CaseWhenColumn(self._branches + [(condition, val_c)],
                              self._otherwise)

    def otherwise(self, value) -> "CaseWhenColumn":
        other = value if isinstance(value, Column) else LitColumn(value)
        return CaseWhenColumn(self._branches, other)


class NamedColumn(Column):
    """Reference to an existing column by name. `col("*")` is the star
    reference; select() expands it to all input columns, and evaluating
    it anywhere else is an error."""

    def __init__(self, name: str):
        if name == "*":
            def star_eval(block, ctx):
                raise ValueError(
                    "col('*') can only be expanded inside select()")
            super().__init__(star_eval, name)
        else:
            super().__init__(lambda block, ctx: block[name], name)
        self.ref = name


class LitColumn(Column):
    def __init__(self, value: Any):
        super().__init__(lambda block, ctx: value, str(value))
        self.value = value


_TRUE_STRINGS = {"true", "t", "yes", "y", "1"}
_FALSE_STRINGS = {"false", "f", "no", "n", "0"}


def cast_to_boolean(s: np.ndarray) -> np.ndarray:
    """SQL cast-to-boolean: recognized string literals map to bool,
    anything else becomes null; numerics are nonzero-is-true."""
    if s.dtype.kind in "ifu":
        return s != 0
    if s.dtype.kind == "b":
        return s

    def conv(v):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return None
        if isinstance(v, (bool, np.bool_)):
            return bool(v)
        if isinstance(v, (int, float, np.integer, np.floating)):
            return v != 0
        t = str(v).strip().lower()
        if t in _TRUE_STRINGS:
            return True
        if t in _FALSE_STRINGS:
            return False
        return None

    return infer_objects(object_array(conv(v) for v in s))


def ensure_column(x) -> Column:
    if isinstance(x, Column):
        return x
    if isinstance(x, str):
        return NamedColumn(x)
    return LitColumn(x)
