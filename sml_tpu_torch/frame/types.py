"""Schema types: the StructType/StructField surface the course uses.

The port's copy of `sml_tpu/frame/types.py`, over numpy dtypes instead
of pyarrow and pandas ones: a float64 column is `double`, int64 `bigint`,
an object or str column `string`, a 2-D float block a `vector`. Each
type also names its Arrow type (`to_arrow`, importing pyarrow inside
the call) and its pandas dtype (`to_pandas_dtype`, a numpy type or
dtype name); `arrow_to_sml` reads an Arrow type back, and
`infer_schema_from_pandas` types a pandas frame's columns from their
dtypes, without importing pandas.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np


class DataType:
    _name = "data"

    def simpleString(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    def to_arrow(self):
        raise NotImplementedError

    def to_pandas_dtype(self):
        raise NotImplementedError


class StringType(DataType):
    _name = "string"

    def to_arrow(self):
        import pyarrow as pa
        return pa.string()

    def to_pandas_dtype(self):
        return object


class DoubleType(DataType):
    _name = "double"

    def to_arrow(self):
        import pyarrow as pa
        return pa.float64()

    def to_pandas_dtype(self):
        return np.float64


class FloatType(DataType):
    _name = "float"

    def to_arrow(self):
        import pyarrow as pa
        return pa.float32()

    def to_pandas_dtype(self):
        return np.float32


class IntegerType(DataType):
    _name = "int"

    def to_arrow(self):
        import pyarrow as pa
        return pa.int32()

    def to_pandas_dtype(self):
        return np.int32


class LongType(DataType):
    _name = "bigint"

    def to_arrow(self):
        import pyarrow as pa
        return pa.int64()

    def to_pandas_dtype(self):
        return np.int64


class BooleanType(DataType):
    _name = "boolean"

    def to_arrow(self):
        import pyarrow as pa
        return pa.bool_()

    def to_pandas_dtype(self):
        return np.bool_


class TimestampType(DataType):
    _name = "timestamp"

    def to_arrow(self):
        import pyarrow as pa
        return pa.timestamp("us")

    def to_pandas_dtype(self):
        return "datetime64[us]"


class DateType(DataType):
    _name = "date"

    def to_arrow(self):
        import pyarrow as pa
        return pa.date32()

    def to_pandas_dtype(self):
        return "datetime64[s]"


class VectorType(DataType):
    """Dense feature vector column (MLlib Vector equivalent): the column
    is one (n, d) float64 block."""
    _name = "vector"

    def __init__(self, size: int = -1):
        self.size = size

    def __eq__(self, other):
        return isinstance(other, VectorType)

    def __hash__(self):
        return hash("VectorType")

    def to_arrow(self):
        """A list of float32 (the JAX package's storage type; the port
        holds a vector column as float64)."""
        import pyarrow as pa
        return pa.list_(pa.float32()) if self.size < 0 \
            else pa.list_(pa.float32(), self.size)

    def to_pandas_dtype(self):
        return object


@dataclass
class StructField:
    name: str
    dataType: DataType
    nullable: bool = True
    metadata: Dict[str, Any] = field(default_factory=dict)

    def simpleString(self) -> str:
        return f"{self.name}:{self.dataType.simpleString()}"


class StructType(DataType):
    _name = "struct"

    def __init__(self, fields: Optional[List[StructField]] = None):
        self.fields: List[StructField] = fields or []

    def add(self, name: Union[str, StructField],
            dataType: Optional[DataType] = None,
            nullable: bool = True) -> "StructType":
        if isinstance(name, StructField):
            self.fields.append(name)
        else:
            self.fields.append(StructField(name, dataType, nullable))
        return self

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.fields[key]
        for f in self.fields:
            if f.name == key:
                return f
        raise KeyError(key)

    def __eq__(self, other):
        return isinstance(other, StructType) and \
            [(f.name, f.dataType) for f in self.fields] == \
            [(f.name, f.dataType) for f in other.fields]

    def __hash__(self):
        return hash(tuple(self.names))

    def __repr__(self):
        inner = ", ".join(f.simpleString() for f in self.fields)
        return f"StructType({inner})"

    def simpleString(self) -> str:
        return "struct<" + ",".join(f.simpleString()
                                    for f in self.fields) + ">"

    def treeString(self) -> str:
        lines = ["root"]
        for f in self.fields:
            lines.append(f" |-- {f.name}: {f.dataType.simpleString()} "
                         f"(nullable = {str(f.nullable).lower()})")
        return "\n".join(lines) + "\n"

    def to_arrow(self):
        import pyarrow as pa
        return pa.schema([(f.name, f.dataType.to_arrow())
                          for f in self.fields])


_SIMPLE_NAMES = {
    "string": StringType, "str": StringType,
    "double": DoubleType, "float64": DoubleType,
    "float": FloatType, "float32": FloatType,
    "int": IntegerType, "integer": IntegerType, "int32": IntegerType,
    "long": LongType, "bigint": LongType, "int64": LongType,
    "boolean": BooleanType, "bool": BooleanType,
    "timestamp": TimestampType, "date": DateType,
    "vector": VectorType,
}


def parse_type(name: str) -> DataType:
    key = name.strip().lower()
    if key in _SIMPLE_NAMES:
        return _SIMPLE_NAMES[key]()
    raise ValueError(f"Unknown type name: {name}")


def parse_schema(s: Union[str, StructType]) -> StructType:
    """Parse a DDL-ish schema string: ``"a DOUBLE, b STRING"``."""
    if isinstance(s, StructType):
        return s
    st = StructType()
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        toks = part.replace(":", " ").split()
        st.add(toks[0].strip("`"), parse_type(toks[1]))
    return st


def type_of(values: np.ndarray) -> DataType:
    """The schema type of one column's numpy array."""
    if values.ndim == 2:
        return VectorType()
    kind = values.dtype.kind
    if kind == "f":
        return DoubleType() if values.dtype.itemsize > 4 else FloatType()
    if kind in "iu":
        return LongType() if values.dtype.itemsize > 4 else IntegerType()
    if kind == "b":
        return BooleanType()
    if kind == "M":
        return TimestampType()
    return StringType()


def infer_schema(block: Dict[str, np.ndarray]) -> StructType:
    """The schema of a block of numpy columns (`type_of` per column)."""
    return StructType([StructField(str(name), type_of(v))
                       for name, v in block.items()])


def arrow_to_sml(t) -> DataType:
    """The schema type of an Arrow type (text and anything unknown as
    `string`, a list as `vector`)."""
    import pyarrow as pa
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return StringType()
    if pa.types.is_float64(t):
        return DoubleType()
    if pa.types.is_float32(t):
        return FloatType()
    if pa.types.is_int64(t):
        return LongType()
    if pa.types.is_integer(t):
        return IntegerType()
    if pa.types.is_boolean(t):
        return BooleanType()
    if pa.types.is_timestamp(t):
        return TimestampType()
    if pa.types.is_date(t):
        return DateType()
    if pa.types.is_list(t) or pa.types.is_fixed_size_list(t):
        return VectorType()
    return StringType()


def infer_schema_from_pandas(pdf) -> StructType:
    """The schema of a pandas frame from its columns' dtypes (read
    through `pdf[c].dtype` and `.to_numpy()`, with no pandas import): a
    column whose every value is a list or an array is a `vector`, other
    object columns `string`."""
    st = StructType()
    for name in pdf.columns:
        s = pdf[name]
        if getattr(s.dtype, "name", "") == "vector":  # columnar VectorArray
            st.add(str(name), VectorType())
            continue
        kind = s.dtype.kind
        if kind == "f":
            t: DataType = DoubleType() if s.dtype.itemsize > 4 \
                else FloatType()
        elif kind in "iu":
            t = LongType() if s.dtype.itemsize > 4 else IntegerType()
        elif kind == "b":
            t = BooleanType()
        elif kind == "M":
            t = TimestampType()
        else:
            vals = s.to_numpy()
            t = VectorType() if len(vals) and all(
                isinstance(v, (list, np.ndarray)) for v in vals) \
                else StringType()
        st.add(str(name), t)
    return st


class Row:
    """Result row with attribute and index access (collect() output)."""

    def __init__(self, **kwargs):
        self.__dict__["_fields"] = list(kwargs.keys())
        self.__dict__["_values"] = dict(kwargs)

    def __getattr__(self, item):
        try:
            return self.__dict__["_values"][item]
        except KeyError:
            raise AttributeError(item)

    def __getitem__(self, item):
        if isinstance(item, int):
            return self._values[self._fields[item]]
        return self._values[item]

    def asDict(self) -> Dict[str, Any]:
        return dict(self._values)

    def __eq__(self, other):
        if isinstance(other, Row):
            return self._values == other._values
        return NotImplemented

    def __iter__(self):
        return iter(self._values.values())

    def __len__(self):
        return len(self._fields)

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"Row({inner})"
