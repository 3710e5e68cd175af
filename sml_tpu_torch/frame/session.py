"""TpuSession: the SparkSession equivalent (one Python driver, no JVM).

The port's copy of `sml_tpu/frame/session.py`, without the catalog, SQL
and readers (`read`, `sql`, `table`), which wait for `frame/sql.py` and
`frame/io.py`. `createDataFrame` takes a dict of columns, a list of
`Row`s, dicts or tuples (with a schema or column names), or any object
with `.columns` whose columns have `.to_numpy()` (a pandas frame, say),
without importing pandas.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

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

    def getOrCreate(self) -> "TpuSession":
        s = TpuSession._instance or TpuSession(app_name=self._app)
        for k, v in self._conf.items():
            s.conf.set(k, v)
        return s


class TpuSession:
    _instance: Optional["TpuSession"] = None
    builder: _Builder

    def __init__(self, app_name: str = "sml_tpu"):
        self.app_name = app_name
        self.conf: TorchConf = GLOBAL_CONF
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
            block = {str(c): column_array(data[c].to_numpy())
                     for c in data.columns}
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

    def stop(self) -> None:
        TpuSession._instance = None


TpuSession.builder = _Builder()


def get_session() -> TpuSession:
    return TpuSession._instance or TpuSession()
