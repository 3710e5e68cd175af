"""Schema types: the StructType/StructField surface the course uses.

The port's copy of `sml_tpu/frame/types.py`, over numpy dtypes instead
of pyarrow and pandas ones: a float64 column is `double`, int64 `bigint`,
an object or str column `string`, a 2-D float block a `vector`.
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


class StringType(DataType):
    _name = "string"


class DoubleType(DataType):
    _name = "double"


class FloatType(DataType):
    _name = "float"


class IntegerType(DataType):
    _name = "int"


class LongType(DataType):
    _name = "bigint"


class BooleanType(DataType):
    _name = "boolean"


class TimestampType(DataType):
    _name = "timestamp"


class DateType(DataType):
    _name = "date"


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
