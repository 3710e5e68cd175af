"""pandas API over the port's frame engine: the Koalas layer.

The port's copy of `sml_tpu/pandas_api/__init__.py`. `SML/ML 14 -
Koalas.py` exercises `read_parquet` / `read_delta` (`:107-110`),
`ks.DataFrame(spark_df)` / `df.to_koalas()` / `kdf.to_spark()`
(`:134-152`), `value_counts` (`:172`), plotting (`:180-186`),
`ks.sql("... {kdf}")` (`:194`), the InternalFrame design (`:41-65`),
default index types (`:114-122`) and `compute.shortcut_limit` (`:201`).

A `_InternalFrame` pairs the immutable port frame with index metadata;
pandas-style updates make a new InternalFrame over derived columns, and
nothing runs until a value is needed.

Importing this module loads no pandas. The methods that return a
port-backed frame (`to_spark`, `head`, `filter`, `sort_values`, `drop`,
`rename`, `dropna`, `fillna`, `__getitem__`, `sql`, the readers), the
scalars (`len`, `shape`, `mean`, `count`, ...) and `columns` (a list
with `tolist()`, where Koalas has a pandas Index) need none. The
methods that return a pandas object (`to_pandas`, `value_counts`,
`describe`, `dtypes`, the `GroupBy` aggregates, `repr`) import it inside
the call and raise ImportError naming themselves where it is absent
(`frame/_pandas.py`); plotting also imports matplotlib inside the call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..frame import functions as F
from ..frame._pandas import pandas
from ..frame.dataframe import DataFrame as SDataFrame
from ..frame.session import get_session

_DEFAULTS: Dict[str, Any] = {
    "compute.shortcut_limit": 1000,
    "compute.default_index_type": "distributed-sequence",
    "plotting.backend": "matplotlib",
    "display.max_rows": 1000,
}
_options: Dict[str, Any] = dict(_DEFAULTS)


def set_option(key: str, value) -> None:
    _options[key] = value


def get_option(key: str):
    return _options[key]


def reset_option(key: str) -> None:
    _options[key] = _DEFAULTS[key]


class _OptionsNamespace:
    """`ks.options.plotting.backend = 'matplotlib'` attribute surface over
    the dotted option keys (`ML 14:180`)."""

    def __init__(self, prefix: str = ""):
        object.__setattr__(self, "_prefix", prefix)

    def _key(self, item: str) -> str:
        return f"{self._prefix}.{item}" if self._prefix else item

    def __getattr__(self, item):
        key = self._key(item)
        if key in _options:
            return _options[key]
        if any(k.startswith(key + ".") for k in _options):
            return _OptionsNamespace(key)
        raise AttributeError(key)

    def __setattr__(self, item, value):
        set_option(self._key(item), value)


options = _OptionsNamespace()


class _Columns(list):
    """A frame's column names: a list with pandas Index's `tolist()`."""

    def tolist(self) -> List[str]:
        return list(self)


class _PlotAccessor:
    """`kdf.plot.hist(...)`, or `kdf.plot(...)` called directly: pandas
    plotting on the collected data (`ML 14:181-186`)."""

    def __init__(self, obj):
        self._obj = obj

    def _pandas(self):
        import matplotlib
        matplotlib.use("Agg", force=False)
        return self._obj.to_pandas()

    def __call__(self, *a, **kw):
        return self._pandas().plot(*a, **kw)

    def hist(self, x=None, y=None, bins: int = 10, **kw):
        pdf = self._pandas()
        if isinstance(self._obj, DataFrame):
            cols = [c for c in (x, y) if c is not None and c in pdf.columns]
            if cols:
                pdf = pdf[cols]
        return pdf.plot.hist(bins=bins, **kw)

    def __getattr__(self, kind):
        if kind.startswith("_"):
            raise AttributeError(kind)

        def run(*a, **kw):
            return getattr(self._pandas().plot, kind)(*a, **kw)

        return run


class _InternalFrame:
    """(port frame, index column): updates swap metadata, not data."""

    INDEX_COL = "__index_level_0__"

    def __init__(self, sdf: SDataFrame, index_col: Optional[str] = None):
        self.sdf = sdf
        self.index_col = index_col

    def with_index(self) -> "_InternalFrame":
        if self.index_col is not None:
            return self
        # the distributed-sequence default index: per-partition offsets
        # make a global 0..n-1 sequence without a shuffle (ML 14:114-122)
        sdf = self.sdf.withColumn(self.INDEX_COL,
                                  F.monotonically_increasing_id())
        return _InternalFrame(sdf, self.INDEX_COL)

    @property
    def data_columns(self) -> List[str]:
        return [c for c in self.sdf.columns if c != self.index_col]

    def derive(self, sdf: SDataFrame) -> "_InternalFrame":
        return _InternalFrame(sdf, self.index_col)


class Series:
    def __init__(self, internal: _InternalFrame, column: str):
        self._internal = internal
        self._col = column

    # -- execution --------------------------------------------------------
    def to_pandas(self):
        pandas("Series.to_pandas")
        pdf = self._internal.sdf.toPandas()
        s = pdf[self._col]
        if self._internal.index_col and self._internal.index_col in pdf.columns:
            s = s.set_axis(pdf[self._internal.index_col])
        return s

    toPandas = to_pandas

    def head(self, n: int = 5) -> "Series":
        return Series(self._internal.derive(self._internal.sdf.limit(n)),
                      self._col)

    def _binop(self, other, fn) -> "Series":
        o = other._to_column() if isinstance(other, Series) else other
        name = f"__tmp_{self._col}"
        sdf = self._internal.sdf.withColumn(name, fn(F.col(self._col), o))
        return Series(self._internal.derive(sdf), name)

    def _to_column(self):
        return F.col(self._col)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b)

    def __gt__(self, other):
        return self._binop(other, lambda a, b: a > b)

    def __ge__(self, other):
        return self._binop(other, lambda a, b: a >= b)

    def __lt__(self, other):
        return self._binop(other, lambda a, b: a < b)

    def __le__(self, other):
        return self._binop(other, lambda a, b: a <= b)

    def __eq__(self, other):  # noqa: A003
        return self._binop(other, lambda a, b: a == b)

    # -- reductions -------------------------------------------------------
    def _agg(self, fn):
        return self._internal.sdf.agg(
            fn(F.col(self._col)).alias("v")).collect()[0]["v"]

    def mean(self):
        return float(self._agg(F.avg))

    def sum(self):  # noqa: A003
        return float(self._agg(F.sum))

    def max(self):  # noqa: A003
        return self._agg(F.max)

    def min(self):  # noqa: A003
        return self._agg(F.min)

    def count(self):
        return int(self._agg(F.count))

    def value_counts(self, normalize: bool = False, ascending: bool = False):
        """The count of each value, most frequent first, as a pandas
        Series indexed by the values."""
        pandas("Series.value_counts")
        out = (self._internal.sdf.groupBy(self._col).count()
               .orderBy("count", ascending=ascending).toPandas())
        s = out.set_index(self._col)["count"]
        if normalize:
            s = s / s.sum()
        return s

    def isna(self) -> "Series":
        return self._binop(None, lambda a, b: F.isnull(a))

    isnull = isna

    def fillna(self, value) -> "Series":
        return self._binop(None, lambda a, b: F.coalesce(a, F.lit(value)))

    def astype(self, dtype) -> "Series":
        name = {float: "double", int: "bigint", str: "string"}.get(
            dtype, str(dtype))
        return self._binop(None, lambda a, b: a.cast(name))

    @property
    def plot(self) -> _PlotAccessor:
        return _PlotAccessor(self)

    @property
    def hist(self):
        return _PlotAccessor(self)._pandas().hist

    def __repr__(self):
        return repr(self.to_pandas().head(int(_options["display.max_rows"])))


class DataFrame:
    """Koalas-style DataFrame over the port's frame engine."""

    def __init__(self, data=None, index_col: Optional[str] = None):
        if isinstance(data, _InternalFrame):
            self._internal = data
        elif isinstance(data, SDataFrame):
            self._internal = _InternalFrame(data, index_col)
        elif isinstance(data, dict) or hasattr(data, "columns"):
            # a mapping of columns, or a pandas frame (read without pandas)
            self._internal = _InternalFrame(
                get_session().createDataFrame(data))
        else:
            raise TypeError(f"cannot build ks.DataFrame from {type(data)}")

    def _derive(self, sdf: SDataFrame) -> "DataFrame":
        return DataFrame(self._internal.derive(sdf))

    # -- interop (ML 14:134-152) -----------------------------------------
    def to_spark(self) -> SDataFrame:
        return self._internal.sdf

    def to_pandas(self):
        pandas("DataFrame.to_pandas")
        pdf = self._internal.sdf.toPandas()
        if self._internal.index_col and self._internal.index_col in pdf.columns:
            pdf = pdf.set_index(self._internal.index_col)
            pdf.index.name = None
        return pdf

    toPandas = to_pandas

    # -- metadata ---------------------------------------------------------
    @property
    def columns(self) -> _Columns:
        return _Columns(self._internal.data_columns)

    @property
    def dtypes(self):
        pd = pandas("DataFrame.dtypes")
        mapping = {"double": np.dtype("float64"), "float": np.dtype("float32"),
                   "bigint": np.dtype("int64"), "int": np.dtype("int32"),
                   "string": np.dtype("O"), "boolean": np.dtype("bool")}
        return pd.Series({n: mapping.get(t, np.dtype("O"))
                          for n, t in self._internal.sdf.dtypes
                          if n != self._internal.index_col})

    @property
    def shape(self):
        return (self._internal.sdf.count(), len(self.columns))

    def __len__(self):
        return self._internal.sdf.count()

    # -- selection --------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return Series(self._internal, key)
        if isinstance(key, list):
            cols = key + ([self._internal.index_col]
                          if self._internal.index_col else [])
            return self._derive(self._internal.sdf.select(*cols))
        if isinstance(key, Series):  # a boolean mask
            sdf = key._internal.sdf.filter(F.col(key._col))
            keep = [c for c in sdf.columns if not c.startswith("__tmp_")]
            return self._derive(sdf.select(*keep))
        raise KeyError(key)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        if item in self._internal.data_columns:
            return Series(self._internal, item)
        raise AttributeError(item)

    def __setitem__(self, key: str, value):
        if isinstance(value, Series):
            sdf = value._internal.sdf.withColumnRenamed(value._col, key) \
                if value._col.startswith("__tmp_") else \
                value._internal.sdf.withColumn(key, F.col(value._col))
            keep = [c for c in sdf.columns if not c.startswith("__tmp_")]
            self._internal = self._internal.derive(sdf.select(*keep))
        else:
            self._internal = self._internal.derive(
                self._internal.sdf.withColumn(key, F.lit(value)))

    # -- pandas verbs -----------------------------------------------------
    def head(self, n: int = 5) -> "DataFrame":
        return self._derive(self._internal.sdf.limit(n))

    def sort_values(self, by, ascending: bool = True) -> "DataFrame":
        by = [by] if isinstance(by, str) else list(by)
        return self._derive(self._internal.sdf.orderBy(*by,
                                                       ascending=ascending))

    def drop(self, columns=None, labels=None) -> "DataFrame":
        cols = columns or labels or []
        cols = [cols] if isinstance(cols, str) else list(cols)
        return self._derive(self._internal.sdf.drop(*cols))

    def rename(self, columns: Dict[str, str]) -> "DataFrame":
        sdf = self._internal.sdf
        for old, new in columns.items():
            sdf = sdf.withColumnRenamed(old, new)
        return self._derive(sdf)

    def dropna(self, subset=None) -> "DataFrame":
        return self._derive(self._internal.sdf.dropna(subset=subset))

    def fillna(self, value) -> "DataFrame":
        return self._derive(self._internal.sdf.fillna(value))

    def describe(self):
        pandas("DataFrame.describe")
        return self._internal.sdf.describe().toPandas().set_index("summary")

    def groupby(self, by) -> "GroupBy":
        return GroupBy(self, [by] if isinstance(by, str) else list(by))

    def filter(self, items=None, like=None, regex=None  # noqa: A003
               ) -> "DataFrame":
        """Column subsetting as pandas has it (`ML 14:185` uses
        filter(items=...)); the index column is carried through."""
        cols = self._internal.data_columns
        if items is not None:
            keep = [c for c in cols if c in set(items)]
        elif like is not None:
            keep = [c for c in cols if like in c]
        elif regex is not None:
            import re
            keep = [c for c in cols if re.search(regex, c)]
        else:
            raise TypeError("filter requires items, like, or regex")
        if self._internal.index_col and \
                self._internal.index_col in self._internal.sdf.columns:
            keep.append(self._internal.index_col)
        return self._derive(self._internal.sdf.select(keep))

    @property
    def plot(self) -> _PlotAccessor:
        return _PlotAccessor(self)

    def to_delta(self, path: str, mode: str = "overwrite") -> None:
        self._internal.sdf.write.format("delta").mode(mode).save(path)

    def to_parquet(self, path: str, mode: str = "overwrite") -> None:
        self._internal.sdf.write.mode(mode).parquet(path)

    def __repr__(self):
        limit = int(_options["compute.shortcut_limit"])
        return repr(self.head(limit).to_pandas())


class GroupBy:
    def __init__(self, kdf: DataFrame, keys: List[str]):
        self._kdf = kdf
        self._keys = keys

    def _run(self, api: str, how: str, *args):
        """The grouped aggregate `how` as a pandas frame indexed by the
        keys."""
        pandas(f"GroupBy.{api}")
        grouped = self._kdf._internal.sdf.groupBy(*self._keys)
        return getattr(grouped, how)(*args).toPandas().set_index(self._keys)

    def count(self):
        return self._run("count", "count")

    def mean(self):
        return self._run("mean", "avg")

    def sum(self):  # noqa: A003
        return self._run("sum", "sum")

    def max(self):  # noqa: A003
        return self._run("max", "max")

    def min(self):  # noqa: A003
        return self._run("min", "min")

    def agg(self, spec: Dict[str, str]):
        return self._run("agg", "agg", spec)


# ------------------------------------------------------------ module fns
def from_pandas(pdf) -> DataFrame:
    return DataFrame(pdf)


def read_csv(path: str, header: bool = True, **kw) -> DataFrame:
    return DataFrame(get_session().read.csv(path, header=header,
                                            inferSchema=True))


def read_parquet(path: str) -> DataFrame:
    return DataFrame(get_session().read.parquet(path))


def read_delta(path: str, version: Optional[int] = None) -> DataFrame:
    reader = get_session().read.format("delta")
    if version is not None:
        reader = reader.option("versionAsOf", version)
    return DataFrame(reader.load(path))


def sql(query: str, **frames) -> DataFrame:
    """`ks.sql("SELECT * FROM {kdf} WHERE ...")`: each `{name}` is a
    frame passed by keyword or found among the caller's locals,
    registered as a temp view of that name (ML 14:194)."""
    import inspect
    import re
    caller = inspect.currentframe().f_back.f_locals
    session = get_session()
    for name in re.findall(r"\{(\w+)\}", query):
        obj = frames.get(name, caller.get(name))
        if obj is None:
            raise ValueError(f"ks.sql: no frame named {name!r} in scope")
        sdf = obj.to_spark() if isinstance(obj, DataFrame) else obj
        sdf.createOrReplaceTempView(name)
        query = query.replace("{" + name + "}", name)
    return DataFrame(session.sql(query))


def range(n: int) -> DataFrame:  # noqa: A001
    return DataFrame(get_session().range(n))
