"""Column functions: the `pyspark.sql.functions` surface the course
drives, over numpy blocks.

The port's copy of `sml_tpu/frame/functions.py`. `pandas_udf` hands
pandas Series to user code and imports pandas when its column is
evaluated (`frame/_pandas.py`); the row-at-a-time `udf` needs none.
Partition-aware functions (`rand`,
`monotonically_increasing_id`) follow the per-partition contract of
`frame/dataframe.py`. The date functions parse text as pandas'
`to_datetime(errors="coerce")` does for the formats in `DATE_FORMATS`:
the first non-NULL value of a partition picks the format, and text
that does not match it is NULL (NaT). `corr` is the Pearson correlation
of the rows where neither column is NULL (the JAX package's aggregate
gives NaN, `ROADMAP.md` §3).
"""

from __future__ import annotations

import builtins
from typing import Any, Optional, Union

import numpy as np

from ..native.hashing import hash_columns, null_mask
from .column import (CaseWhenColumn, Column, EvalContext, LitColumn,
                     NamedColumn, block_len, ensure_column, infer_objects,
                     object_array, to_numeric)

ColumnOrName = Union[Column, str]


def col(name: str) -> Column:
    return NamedColumn(name)


column = col


def lit(value: Any) -> Column:
    return LitColumn(value)


# ----------------------------- scalar math ---------------------------------

def _unary(name: str, fn):
    def wrapper(c: ColumnOrName) -> Column:
        cc = ensure_column(c)

        def ev(block, ctx):
            with np.errstate(all="ignore"):
                return fn(to_numeric(cc._eval(block, ctx)))
        out = Column(ev, f"{name}({cc._name})")
        if isinstance(cc, NamedColumn):
            # pattern tag for withColumn's evaluator-pushdown propagation:
            # "this expression is <name> applied to the raw column <col>"
            out._unary_of = (name, cc._name)
        return out
    wrapper.__name__ = name
    return wrapper


log = _unary("log", np.log)
log1p = _unary("log1p", np.log1p)
log2 = _unary("log2", np.log2)
log10 = _unary("log10", np.log10)
exp = _unary("exp", np.exp)
sqrt = _unary("sqrt", np.sqrt)
abs = _unary("abs", np.abs)  # noqa: A001 - matches pyspark.sql.functions.abs
floor = _unary("floor", np.floor)
ceil = _unary("ceil", np.ceil)


def pow(base: ColumnOrName, exponent) -> Column:  # noqa: A001
    return ensure_column(base) ** exponent


def round(c: ColumnOrName, scale: int = 0) -> Column:  # noqa: A001
    cc = ensure_column(c)
    return Column(lambda b, ctx: np.round(cc._eval(b, ctx), scale),
                  f"round({cc._name}, {scale})")


def negate(c: ColumnOrName) -> Column:
    return -ensure_column(c)


# ----------------------------- conditionals --------------------------------

def when(condition: Column, value) -> Column:
    val_c = value if isinstance(value, Column) else LitColumn(value)
    return CaseWhenColumn([(condition, val_c)])


def coalesce(*cols: ColumnOrName) -> Column:
    ccs = [ensure_column(c) for c in cols]

    def ev(block, ctx):
        out = ccs[0]._eval(block, ctx)
        for c in ccs[1:]:
            nulls = null_mask(out)
            if nulls.any():
                out = out.copy() if out.dtype.kind == "O" \
                    else out.astype(np.result_type(out, np.float64))
                out[nulls] = c._eval(block, ctx)[nulls]
        return out

    return Column(ev, "coalesce(...)")


def isnan(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return Column(lambda b, ctx: np.isnan(to_numeric(cc._eval(b, ctx))
                                          .astype(np.float64)),
                  f"isnan({cc._name})")


def isnull(c: ColumnOrName) -> Column:
    return ensure_column(c).isNull()


# ------------------------------- strings -----------------------------------

def _string_map(cc: Column, fn, label: str) -> Column:
    def ev(block, ctx):
        a = cc._eval(block, ctx)
        nulls = null_mask(a)
        return object_array(None if nulls[i] else fn(str(v))
                            for i, v in enumerate(a))
    return Column(ev, label)


def translate(src: ColumnOrName, matching: str, replace: str) -> Column:
    """Character-by-character translation (the course's price cleanup)."""
    cc = ensure_column(src)
    table = {ord(ch): (replace[i] if i < len(replace) else None)
             for i, ch in enumerate(matching)}
    return _string_map(cc, lambda s: s.translate(table),
                       f"translate({cc._name}, {matching}, {replace})")


def lower(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return _string_map(cc, str.lower, f"lower({cc._name})")


def upper(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return _string_map(cc, str.upper, f"upper({cc._name})")


def trim(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return _string_map(cc, str.strip, f"trim({cc._name})")


def initcap(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return _string_map(cc, str.title, f"initcap({cc._name})")


def regexp_replace(c: ColumnOrName, pattern: str, replacement: str
                   ) -> Column:
    import re
    cc = ensure_column(c)
    rx = re.compile(pattern)
    return _string_map(cc, lambda s: rx.sub(replacement, s),
                       f"regexp_replace({cc._name})")


def split(c: ColumnOrName, pattern: str) -> Column:
    import re
    cc = ensure_column(c)
    rx = re.compile(pattern)
    return _string_map(cc, rx.split, f"split({cc._name}, {pattern})")


def length(c: ColumnOrName) -> Column:
    cc = ensure_column(c)

    def ev(block, ctx):
        a = cc._eval(block, ctx)
        nulls = null_mask(a)
        return np.array([np.nan if nulls[i] else len(str(v))
                         for i, v in enumerate(a)], dtype=np.float64)
    return Column(ev, f"length({cc._name})")


def concat(*cols: ColumnOrName) -> Column:
    """The inputs' text joined; NULL where any input is NULL (Spark's
    and the JAX package's)."""
    ccs = [ensure_column(c) for c in cols]

    def ev(block, ctx):
        parts = [c._eval(block, ctx) for c in ccs]
        nulls = np.zeros(block_len(block), dtype=bool)
        for p in parts:
            nulls |= null_mask(p)
        return object_array(None if nulls[i] else
                            "".join(str(p[i]) for p in parts)
                            for i in range(block_len(block)))

    return Column(ev, "concat(...)")


def concat_ws(sep: str, *cols: ColumnOrName) -> Column:
    """The inputs' text joined by `sep`, skipping NULL inputs (Spark's
    rule; the JAX package gives NULL there, through pandas' NaN)."""
    ccs = [ensure_column(c) for c in cols]

    def ev(block, ctx):
        parts = [c._eval(block, ctx) for c in ccs]
        parts = [(p, null_mask(p)) for p in parts]
        return object_array(sep.join(str(p[i]) for p, nulls in parts
                                     if not nulls[i])
                            for i in range(block_len(block)))

    return Column(ev, f"concat_ws({sep}, ...)")


# --------------------------- partition-aware -------------------------------

def _seed_or_entropy(seed: Optional[int]) -> int:
    return int(seed) if seed is not None \
        else np.random.SeedSequence().entropy % (2 ** 31)


def rand(seed: Optional[int] = None) -> Column:
    """Uniform [0,1). Deterministic per (seed, partition_index), the
    same partition-dependence contract as randomSplit's."""
    def ev(block, ctx: EvalContext):
        rng = np.random.default_rng((_seed_or_entropy(seed) << 16)
                                    + ctx.partition_index)
        return rng.random(block_len(block))

    return Column(ev, f"rand({seed})")


def randn(seed: Optional[int] = None) -> Column:
    def ev(block, ctx: EvalContext):
        rng = np.random.default_rng((_seed_or_entropy(seed) << 16)
                                    + ctx.partition_index)
        return rng.standard_normal(block_len(block))

    return Column(ev, f"randn({seed})")


def monotonically_increasing_id() -> Column:
    """(partition_id << 33) + row-position-in-partition."""
    def ev(block, ctx: EvalContext):
        return (ctx.partition_index << 33) + np.arange(block_len(block),
                                                       dtype=np.int64)

    return Column(ev, "monotonically_increasing_id()")


def spark_partition_id() -> Column:
    return Column(lambda b, ctx: np.full(block_len(b), ctx.partition_index,
                                         dtype=np.int32),
                  "SPARK_PARTITION_ID()")


def hash(*cols: ColumnOrName) -> Column:  # noqa: A001
    """Murmur3 row hash with seed chaining (`native/hashing.py`)."""
    ccs = [ensure_column(c) for c in cols]

    def ev(block, ctx):
        return hash_columns([c._eval(block, ctx) for c in ccs],
                            n=block_len(block))

    return Column(ev, "hash(...)")


# ------------------------------ aggregates ---------------------------------
# Each aggregate reduces one whole column, pandas' way: numeric reductions
# skip NULL (`_numeric_ok`), `min`/`max` also work on strings.

def _numeric_ok(a: np.ndarray) -> np.ndarray:
    v = to_numeric(a).astype(np.float64)
    return v[~np.isnan(v)]


def nanmean(values: np.ndarray) -> float:
    """pandas' skipna mean (`nanops.nanmean`): NULL summed as 0 (an
    integer column summed in float64 as it is), over the count of
    values."""
    v = to_numeric(values)
    count = len(v)
    if v.dtype.kind == "f":
        ok = ~np.isnan(v)
        count = int(ok.sum())
        v = np.where(ok, v, 0.0)
    if count == 0:
        return float("nan")
    return float(v.sum(dtype=np.float64) / count)


def nanvar(values: np.ndarray, ddof: int = 1) -> float:
    """pandas' skipna variance (`nanops.nanvar`, the same sums in the same
    order)."""
    v = to_numeric(values).astype(np.float64)
    mask = np.isnan(v)
    count = int((~mask).sum())
    d = count - ddof
    if d <= 0:
        return float("nan")
    v = np.where(mask, 0.0, v)
    avg = v.sum(dtype=np.float64) / count
    sqr = (avg - v) ** 2
    sqr[mask] = 0.0
    return float(sqr.sum(dtype=np.float64) / d)


def _min_max(pick):
    def fn(a: np.ndarray):
        vals = a[~null_mask(a)]
        return pick(vals.tolist()) if len(vals) else None
    return fn


def _aggregate(name: str, agg_fn):
    def wrapper(c: ColumnOrName) -> Column:
        cc = ensure_column(c)
        out = Column(cc._eval_fn, f"{name}({cc._name})", agg=agg_fn)
        out._children = [cc]
        return out
    wrapper.__name__ = name
    return wrapper


def _nansum(a: np.ndarray):
    """pandas' skipna sum: an integer or boolean column sums to an
    integer; a float column sums with NULL as 0."""
    v = to_numeric(a)
    if v.dtype.kind in "iub":
        return int(v.sum())
    v = v.astype(np.float64)
    return float(np.where(np.isnan(v), 0.0, v).sum())


avg = _aggregate("avg", nanmean)
mean = _aggregate("avg", nanmean)
sum = _aggregate("sum", _nansum)  # noqa: A001
min = _aggregate("min", _min_max(builtins.min))  # noqa: A001
max = _aggregate("max", _min_max(builtins.max))  # noqa: A001
stddev = _aggregate("stddev", lambda a: float(np.sqrt(nanvar(a, 1))))
stddev_samp = stddev
stddev_pop = _aggregate("stddev_pop", lambda a: float(np.sqrt(nanvar(a, 0))))
variance = _aggregate("variance", lambda a: nanvar(a, 1))
first = _aggregate("first", lambda a: a[0] if len(a) else None)
last = _aggregate("last", lambda a: a[-1] if len(a) else None)
collect_list = _aggregate("collect_list",
                          lambda a: a[~null_mask(a)].tolist())
collect_set = _aggregate("collect_set", lambda a: sorted(
    set(a[~null_mask(a)].tolist()), key=str))
countDistinct = _aggregate("count_distinct",
                           lambda a: len(set(a[~null_mask(a)].tolist())))
median = _aggregate("median", lambda a: float(np.median(_numeric_ok(a)))
                    if len(_numeric_ok(a)) else float("nan"))


def count(c: ColumnOrName) -> Column:
    if isinstance(c, str) and c == "*":
        return Column(lambda b, ctx: np.ones(block_len(b), dtype=np.int64),
                      "count(1)", agg=lambda a: int(a.sum()))
    cc = ensure_column(c)
    out = Column(cc._eval_fn, f"count({cc._name})",
                 agg=lambda a: int((~null_mask(a)).sum()))
    out._children = [cc]
    return out


def percentile_approx(c: ColumnOrName, percentage: float,
                      accuracy: int = 10000) -> Column:
    cc = ensure_column(c)
    return Column(cc._eval_fn, f"percentile_approx({cc._name}, {percentage})",
                  agg=lambda a: float(np.percentile(_numeric_ok(a),
                                                    percentage * 100)))


def corr(c1: ColumnOrName, c2: ColumnOrName) -> Column:
    """Pearson correlation of two columns (pandas' `Series.corr`: rows
    where either is NULL are dropped, `np.corrcoef` on the rest)."""
    a, b = ensure_column(c1), ensure_column(c2)

    def ev(block, ctx):
        return np.stack([to_numeric(a._eval(block, ctx)).astype(np.float64),
                         to_numeric(b._eval(block, ctx)).astype(np.float64)],
                        axis=1)

    return Column(ev, f"corr({a._name}, {b._name})", agg=pair_corr)


def pair_corr(ab: np.ndarray) -> float:
    """Pearson correlation of the two columns of an (n, 2) array."""
    ok = ~np.isnan(ab).any(axis=1)
    if not ok.any():
        return float("nan")
    with np.errstate(all="ignore"):
        return float(np.corrcoef(ab[ok, 0], ab[ok, 1])[0, 1])


# ---------------------------- datetime helpers ------------------------------
#: the text formats `to_datetime` recognizes without an explicit one, in
#: the order they are tried on a partition's first non-NULL value
DATE_FORMATS = ("%Y-%m-%d", "%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S",
                "%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S.%f",
                "%Y-%m-%d %H:%M", "%Y-%m-%dT%H:%M", "%Y/%m/%d",
                "%m/%d/%Y")


def _strptime(text: str, fmt: str):
    import datetime
    try:
        return datetime.datetime.strptime(text, fmt)
    except ValueError:
        return None


def to_datetime(values: np.ndarray, fmt: Optional[str] = None
                ) -> np.ndarray:
    """`pd.to_datetime(values, format=fmt, errors="coerce")` as
    datetime64[us]: datetimes pass; text parses with `fmt`, or with the
    first of `DATE_FORMATS` that the first non-NULL value matches, and
    is NaT where it does not match. When no format fits the first value,
    each value parses alone with the first of `DATE_FORMATS` it fits
    (pandas then parses each with dateutil, which reads more
    spellings)."""
    if values.dtype.kind == "M":
        return values.astype("datetime64[us]")
    out = np.full(len(values), np.datetime64("NaT"), dtype="datetime64[us]")
    nulls = null_mask(values)
    texts = [None if nulls[i] else str(v) for i, v in enumerate(values)]
    if fmt is None:
        first = next((t for t in texts if t is not None), None)
        fmt = next((f for f in DATE_FORMATS
                    if first is not None and _strptime(first, f)), None)
    formats = DATE_FORMATS if fmt is None else (fmt,)
    for i, t in enumerate(texts):
        if t is not None:
            parsed = next((p for p in (_strptime(t, f) for f in formats)
                           if p is not None), None)
            if parsed is not None:
                out[i] = np.datetime64(parsed, "us")
    return out


def _date_part(values: np.ndarray, part: str) -> np.ndarray:
    """A calendar field as pandas' `.dt.<part>`: int32, or float64 with
    NaN when a value is NaT."""
    ts = to_datetime(values)
    nat = np.isnat(ts)
    if part == "year":
        out = ts.astype("datetime64[Y]").astype(np.int64) + 1970
    elif part == "month":
        out = ts.astype("datetime64[M]").astype(np.int64) % 12 + 1
    else:
        out = (ts.astype("datetime64[D]") - ts.astype("datetime64[M]")
               .astype("datetime64[D]")).astype(np.int64) + 1
    if nat.any():
        return np.where(nat, np.nan, out.astype(np.float64))
    return out.astype(np.int32)


def to_date(c: ColumnOrName, fmt: Optional[str] = None) -> Column:
    cc = ensure_column(c)
    return Column(lambda b, ctx: to_datetime(cc._eval(b, ctx), fmt)
                  .astype("datetime64[D]").astype("datetime64[us]"),
                  f"to_date({cc._name})")


def to_timestamp(c: ColumnOrName, fmt: Optional[str] = None) -> Column:
    cc = ensure_column(c)
    return Column(lambda b, ctx: to_datetime(cc._eval(b, ctx), fmt),
                  f"to_timestamp({cc._name})")


def year(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return Column(lambda b, ctx: _date_part(cc._eval(b, ctx), "year"),
                  f"year({cc._name})")


def month(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return Column(lambda b, ctx: _date_part(cc._eval(b, ctx), "month"),
                  f"month({cc._name})")


def dayofmonth(c: ColumnOrName) -> Column:
    cc = ensure_column(c)
    return Column(lambda b, ctx: _date_part(cc._eval(b, ctx), "day"),
                  f"dayofmonth({cc._name})")


# --------------------------- pandas UDFs (L2) -------------------------------
def pandas_udf(returnType, functionType: Optional[str] = None):
    """`@pandas_udf("double")`: a vectorized UDF over pandas Series
    (`SML/ML 12 - Inference with Pandas UDFs.py:71-112`), in the two
    shapes the course uses, told apart from the signature as in the JAX
    package:
    - scalar: `fn(*series) -> series`, once a partition;
    - scalar iterator: `fn(Iterator[pd.Series | tuple]) ->
      Iterator[pd.Series]`, once a partition over its rows in batches of
      `sml.arrow.maxRecordsPerBatch` (a Series for one argument, a tuple
      for several), so that state such as a loaded model is built once.
    A "double" or "float" result is coerced to numbers. pandas is
    imported when the column is evaluated, never by the decorator."""
    import inspect

    def deco(fn):
        params = list(inspect.signature(fn).parameters.values())
        is_iter = len(params) == 1 and "Iterator" in str(params[0].annotation)
        dtype = returnType if isinstance(returnType, str) else \
            getattr(returnType, "simpleString", lambda: str(returnType))()

        def udf_call(*cols):
            cols_c = [ensure_column(c) for c in cols]

            def ev(block, ctx):
                from ..conf import GLOBAL_CONF
                from ._pandas import pandas, series_of
                from .session import column_array
                pd = pandas("pandas_udf")
                series = [series_of(c._eval(block, ctx),
                                    c._name if isinstance(c, NamedColumn)
                                    else None) for c in cols_c]
                n = block_len(block)
                if not is_iter:
                    out = fn(*series)
                else:
                    bs = GLOBAL_CONF.getInt("sml.arrow.maxRecordsPerBatch")

                    def batches():
                        for lo in range(0, n if n > 0 else 1, bs):
                            chunk = [s.iloc[lo:lo + bs].reset_index(drop=True)
                                     for s in series]
                            yield chunk[0] if len(chunk) == 1 \
                                else tuple(chunk)

                    outs = list(fn(batches()))
                    out = pd.concat(outs, ignore_index=True) if outs \
                        else pd.Series(dtype=float)
                if dtype in ("double", "float"):
                    out = pd.to_numeric(out, errors="coerce")
                values = column_array(np.asarray(out))
                if len(values) != n:
                    raise ValueError(
                        f"pandas_udf {fn.__name__!r} returned {len(values)} "
                        f"values for {n} rows")
                return values

            return Column(ev, getattr(fn, "__name__", "udf") or "udf")

        udf_call.__wrapped__ = fn
        return udf_call

    return deco


def udf(fn=None, returnType="string"):
    """Row-at-a-time UDF (the slow path the course contrasts pandas UDFs
    against, `ML 12:56-61`): `fn` gets each row's values as Python
    values, so it needs no pandas; the results are typed as pandas
    infers a list's type."""
    def deco(f):
        def udf_call(*cols):
            cols_c = [ensure_column(c) for c in cols]

            def ev(block, ctx):
                args = [c._eval(block, ctx).tolist() for c in cols_c]
                vals = [f(*row) for row in zip(*args)] if args \
                    else [f() for _ in builtins.range(block_len(block))]
                return infer_objects(object_array(vals))

            return Column(ev, getattr(f, "__name__", "udf"))
        return udf_call
    return deco(fn) if callable(fn) else deco
