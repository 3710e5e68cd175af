"""The port's one bridge to pandas.

The port keeps its data in numpy blocks and imports no pandas of its
own, and runs where pandas is missing. Only the calls that hand a pandas
object to user code, or return one, need it (`toPandas`,
`mapInPandas`, `applyInPandas`, `pandas_udf`, the Koalas methods that
return pandas objects), and each imports it through `pandas(api)`
inside the call, so that a Python without pandas fails there with an
error that names the call.

What comes back from user code (a UDF's output frame, a batch handed
to `DeviceScorer`, a frame given to `createDataFrame`) is read through
its interface alone, `.columns` and `frame[c].to_numpy()`, with no
pandas import (`block_from_pandas`).
"""

from __future__ import annotations

from .column import Block, object_array

#: the schema types whose pandas dtype `coerce_pandas_to_schema` takes
#: as it is (the JAX package's fast path)
_EXACT_DTYPES = {"double": "float64", "float": "float32", "bigint": "int64",
                 "int": "int32", "boolean": "bool"}


def pandas(api: str):
    """The pandas module, imported for `api`; ImportError naming `api`
    where this Python has no pandas."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            f"{api} hands pandas objects to user code and needs pandas, "
            f"which this Python does not have; the rest of sml_tpu_torch "
            f"runs without it") from e
    return pd


def _handed_out(values):
    """A column as pandas receives it: a copy (what user code writes to
    reaches no block), a vector column as an object column of
    DenseVector."""
    from ..ml.linalg import DenseVector
    return object_array(DenseVector(r) for r in values) \
        if values.ndim == 2 else values.copy()


def block_to_pandas(block: Block, api: str = "toPandas"):
    """A block as a pandas DataFrame (`toPandas`' rule)."""
    pd = pandas(api)
    return pd.DataFrame({c: _handed_out(v) for c, v in block.items()})


def series_of(values, name=None, api: str = "pandas_udf"):
    """One column as a pandas Series (`toPandas`' rule)."""
    return pandas(api).Series(_handed_out(values), name=name)


def block_from_pandas(pdf, names=None) -> Block:
    """The columns `names` (all by default) of a pandas-like frame
    (anything with `.columns` whose columns have `.to_numpy()`) as a
    block, without importing pandas (`session.column_array` per
    column)."""
    from .session import column_array
    return {str(c): column_array(pdf[c].to_numpy())
            for c in (pdf.columns if names is None else names)}


def coerce_pandas_to_schema(pdf, schema) -> Block:
    """A UDF's output frame projected and cast to `schema`, as a block
    (the JAX package's `coerce_to_schema`, then the block). A frame that
    already has the schema's columns in order, each of its exact dtype,
    is taken as it is."""
    from .dataframe import coerce_to_schema
    names = [f.name for f in schema.fields]
    if list(pdf.columns) == names and all(
            _EXACT_DTYPES.get(f.dataType.simpleString())
            == str(pdf[f.name].dtype) for f in schema.fields):
        return block_from_pandas(pdf)
    return coerce_to_schema(
        block_from_pandas(pdf, [n for n in names if n in pdf.columns]),
        schema, n_rows=len(pdf))
