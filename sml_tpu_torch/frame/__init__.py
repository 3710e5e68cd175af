"""The DataFrame layer over numpy blocks (`sml_tpu.frame`)."""

from . import functions
from .column import Column
from .dataframe import DataFrame
from .grouped import GroupedData
from .session import TpuSession, get_session
from .types import (BooleanType, DataType, DateType, DoubleType, FloatType,
                    IntegerType, LongType, Row, StringType, StructField,
                    StructType, TimestampType, VectorType, parse_schema)

__all__ = [
    "functions", "Column", "DataFrame", "GroupedData", "TpuSession", "get_session", "Row",
    "StructType", "StructField", "StringType", "DoubleType", "FloatType",
    "IntegerType", "LongType", "BooleanType", "TimestampType", "DateType",
    "VectorType", "DataType", "parse_schema",
]
