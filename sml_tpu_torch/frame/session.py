"""TpuSession: the SparkSession equivalent (one Python driver, no JVM).

The port's copy of `sml_tpu/frame/session.py`: the session, its
catalog (temp views, warehouse tables, databases), `read`, `sql` and
`table` (`frame/io.py`, `frame/sql.py`). `createDataFrame` takes a dict
of columns, a list of `Row`s, dicts or tuples (with a schema or column
names), or any object with `.columns` whose columns have `.to_numpy()`
(a pandas frame, say), without importing pandas. The warehouse
directory is made when a database or table is first written, not when
the session starts.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..conf import GLOBAL_CONF, TorchConf
from .column import Block, infer_objects, object_array
from .dataframe import DataFrame, coerce_to_schema
from .types import Row, StructType, parse_schema


def column_array(values) -> np.ndarray:
    """One column as the frame stores it: numeric and bool arrays as
    they are, a 2-D array as a vector block, text as an object array
    with None for NULL (a NaN in an object column is NULL too), and a
    Python list inferred as pandas infers it."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "fiubMm":
        return values
    if isinstance(values, np.ndarray) and values.dtype.kind in "US":
        return object_array(values.tolist())
    if isinstance(values, np.ndarray) and values.ndim == 1:
        out = values.copy()
        for i, v in enumerate(out):
            if isinstance(v, float) and v != v:
                out[i] = None
        return out
    return infer_objects(object_array(values))


def _block_from_rows(rows: List, names: List[str]) -> Block:
    cols = list(zip(*rows)) if rows else [[] for _ in names]
    return {n: column_array(list(c)) for n, c in zip(names, cols)}


class Catalog:
    def __init__(self, session: "TpuSession", warehouse: str):
        self._session = session
        self._warehouse = warehouse
        self._views_reg: Dict[str, DataFrame] = {}
        # name -> (path, format)
        self._tables_reg: Dict[str, Tuple[str, str]] = {}
        self._databases = {"default"}
        self._current_db = "default"

    # views
    def _register_view(self, name: str, df: DataFrame) -> None:
        self._views_reg[name] = df

    def _views(self) -> Dict[str, DataFrame]:
        return dict(self._views_reg)

    def dropTempView(self, name: str) -> bool:
        from .sql import invalidate_cached_relation
        invalidate_cached_relation(self._session, name)
        return self._views_reg.pop(name, None) is not None

    def tableExists(self, name: str) -> bool:
        return name in self._views_reg \
            or self._qualify(name) in self._tables_reg

    def listTables(self) -> List[Row]:
        return [Row(database=d, tableName=t, isTemporary=tmp)
                for d, t, tmp in self._list_tables()]

    def _list_tables(self):
        out = [("", v, True) for v in self._views_reg]
        for fq in self._tables_reg:
            db, _, t = fq.rpartition(".")
            out.append((db or "default", t, False))
        return out

    # databases
    def _create_database(self, name: str) -> None:
        self._databases.add(name)
        os.makedirs(os.path.join(self._warehouse, name + ".db"),
                    exist_ok=True)

    def _invalidate_table(self, fq: str, path: Optional[str]) -> None:
        """Drop every name a table was loaded into the SQL store under,
        and every snapshot loaded from its path."""
        from .sql import invalidate_cached_path, invalidate_cached_relation
        for n in {fq, fq.replace(".", "_"), fq.split(".")[-1]}:
            invalidate_cached_relation(self._session, n)
        if path:
            invalidate_cached_path(self._session, path)

    def _drop_database(self, name: str) -> None:
        self._databases.discard(name)
        for fq in [k for k in self._tables_reg if k.startswith(name + ".")]:
            path, _fmt = self._tables_reg.pop(fq)
            self._invalidate_table(fq, path)
        shutil.rmtree(os.path.join(self._warehouse, name + ".db"),
                      ignore_errors=True)

    def _use_database(self, name: str) -> None:
        self._databases.add(name)
        self._current_db = name

    def currentDatabase(self) -> str:
        return self._current_db

    # tables
    def _qualify(self, name: str) -> str:
        return name if "." in name else f"{self._current_db}.{name}"

    def _table_path(self, name: str) -> str:
        db, _, t = self._qualify(name).rpartition(".")
        return os.path.join(self._warehouse, db + ".db", t)

    def _register_table(self, name: str, path: str, fmt: str) -> None:
        self._tables_reg[self._qualify(name)] = (path, fmt)

    def _drop_table(self, name: str) -> None:
        from .sql import invalidate_cached_relation
        fq = self._qualify(name)
        invalidate_cached_relation(self._session, name)  # as-typed alias
        info = self._tables_reg.pop(fq, None)
        self._invalidate_table(fq, info[0] if info else None)
        if info:
            shutil.rmtree(info[0], ignore_errors=True)

    def _tables(self) -> Dict[str, Tuple[str, str]]:
        return dict(self._tables_reg)


class _Builder:
    def __init__(self):
        self._app = "sml_tpu"
        self._conf: Dict[str, Any] = {}

    def appName(self, name: str) -> "_Builder":
        self._app = name
        return self

    def master(self, _m: str) -> "_Builder":
        return self

    def config(self, key: str, value) -> "_Builder":
        self._conf[key] = value
        return self

    def enableHiveSupport(self) -> "_Builder":
        return self

    def getOrCreate(self) -> "TpuSession":
        s = TpuSession._instance or TpuSession(app_name=self._app)
        for k, v in self._conf.items():
            s.conf.set(k, v)
        return s


class TpuSession:
    _instance: Optional["TpuSession"] = None
    builder: _Builder

    def __init__(self, app_name: str = "sml_tpu",
                 warehouse: Optional[str] = None):
        self.app_name = app_name
        self.conf: TorchConf = GLOBAL_CONF
        self._warehouse = warehouse or os.path.join(
            tempfile.gettempdir(), "sml_tpu_torch_warehouse")
        self.catalog = Catalog(self, self._warehouse)
        TpuSession._instance = self

    @classmethod
    def getActiveSession(cls) -> Optional["TpuSession"]:
        return cls._instance

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              numPartitions: Optional[int] = None) -> DataFrame:
        if end is None:
            start, end = 0, start
        ids = np.arange(start, end, step, dtype=np.int64)
        return DataFrame.from_block({"id": ids}, session=self,
                                    num_partitions=numPartitions)

    def createDataFrame(self, data,
                        schema: Optional[Union[str, StructType, List[str]]]
                        = None,
                        numPartitions: Optional[int] = None) -> DataFrame:
        st = parse_schema(schema) if isinstance(schema, (str, StructType)) \
            else None
        if isinstance(data, dict):
            block = {str(c): column_array(v) for c, v in data.items()}
        elif hasattr(data, "columns") and not isinstance(data, DataFrame):
            from ._pandas import block_from_pandas
            block = block_from_pandas(data)
        else:
            rows = list(data)
            if rows and isinstance(rows[0], Row):
                names = list(rows[0]._fields)
                rows = [[r[c] for c in names] for r in rows]
            elif rows and isinstance(rows[0], dict):
                names = list(rows[0])
                rows = [[r.get(c) for c in names] for r in rows]
            elif isinstance(schema, list):
                names = schema
            elif st is not None:
                names = st.names
            else:
                names = [f"_{i + 1}" for i in range(len(rows[0]))]
            block = _block_from_rows(rows, names)
        if isinstance(schema, list):
            block = dict(zip(schema, block.values()))
        if st is not None:
            block = coerce_to_schema(block, st)
        return DataFrame.from_block(block, session=self,
                                    num_partitions=numPartitions, schema=st)

    # --------------------------------------------------------------- access
    @property
    def read(self):
        from .io import DataFrameReader
        return DataFrameReader(self)

    @property
    def readStream(self):
        from ..streaming.stream import DataStreamReader
        return DataStreamReader(self)

    @property
    def streams(self):
        from ..streaming.stream import StreamManager
        return StreamManager()

    def table(self, name: str) -> DataFrame:
        views = self.catalog._views()
        if name in views:
            return views[name]
        info = self.catalog._tables().get(self.catalog._qualify(name))
        if info is None:
            # a directory in the warehouse (a table an earlier session
            # saved): the JAX package reads it as delta or parquet
            path = self.catalog._table_path(name)
            if not os.path.isdir(path):
                raise ValueError(f"Table or view not found: {name}")
            info = (path, "delta" if os.path.isdir(
                os.path.join(path, "_delta_log")) else "parquet")
        path, fmt = info
        return self.read.format(fmt).load(path)

    def sql(self, query: str) -> DataFrame:
        from .sql import run_sql
        return run_sql(self, query)

    @property
    def sparkContext(self) -> "_ContextShim":
        return _ContextShim(self)

    def stop(self) -> None:
        TpuSession._instance = None

    @property
    def version(self) -> str:
        from ..version import __version__
        return __version__


class _ContextShim:
    """`spark.sparkContext` knobs the course touches."""

    def __init__(self, session: TpuSession):
        self._session = session

    @property
    def defaultParallelism(self) -> int:
        return GLOBAL_CONF.getInt("sml.default.parallelism")

    def setLogLevel(self, _level: str) -> None:
        pass

    def parallelize(self, data, numSlices: Optional[int] = None
                    ) -> DataFrame:
        return self._session.createDataFrame({"value": list(data)},
                                             numPartitions=numSlices)


TpuSession.builder = _Builder()


def get_session() -> TpuSession:
    return TpuSession._instance or TpuSession()
