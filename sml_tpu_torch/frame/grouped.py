"""GroupedData: keyed aggregation over numpy blocks.

The port's copy of `sml_tpu/frame/grouped.py` for `groupBy().count()`
and `agg(...)` (SURVEY L1). Groups come in order of first appearance,
NULL keys forming a group of their own (pandas' `groupby(sort=False,
dropna=False)`, which the JAX package runs); each aggregate reduces a
group's rows in their order, and the result is hash-partitioned by the
keys into `sml.shuffle.partitions` blocks, as in the JAX package. The
per-group pandas functions (`applyInPandas`) wait for ROADMAP item 9b.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..conf import GLOBAL_CONF
from ..native.hashing import null_mask
from .column import (Block, Column, EvalContext, block_len, infer_objects,
                     object_array)

#: one NULL group, whatever NULL looks like in the column (None, NaN)
_NULL = object()


def factorize(values: np.ndarray) -> np.ndarray:
    """int64 codes of a column's values in order of first appearance,
    with every NULL one code."""
    n = len(values)
    if values.dtype.kind in "iubfMm":
        uniq, first, inv = np.unique(values, return_index=True,
                                     return_inverse=True, equal_nan=True)
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
        return rank[inv.reshape(-1)]
    nulls = null_mask(values)
    seen: dict = {}
    codes = np.empty(n, dtype=np.int64)
    for i, v in enumerate(values.tolist()):
        codes[i] = seen.setdefault(_NULL if nulls[i] else v, len(seen))
    return codes


def group_rows(block: Block, keys: List[str]) -> Tuple[np.ndarray, list]:
    """(each group's first row, each group's row indices in order), the
    groups in order of first appearance."""
    n = block_len(block)
    code = np.zeros(n, dtype=np.int64)
    for k in keys:
        c = factorize(block[k])
        code = code * (int(c.max()) + 1 if n else 1) + c
    code = factorize(code)
    order = np.argsort(code, kind="stable")
    bounds = np.flatnonzero(np.diff(code[order])) + 1
    rows = np.split(order, bounds) if n else []
    return np.asarray([r[0] for r in rows], dtype=np.intp), rows


def aggregate(block: Block, keys: List[str], exprs: List[Column]) -> Block:
    """One row a group: the keys' values, then each aggregate."""
    first, rows = group_rows(block, keys)
    out: Block = {k: block[k][first] for k in keys}
    n = block_len(block)
    for e in exprs:
        if e._agg is None:
            raise ValueError(f"non-aggregate expression in agg: {e._name}")
        vals = e._eval(block, EvalContext()) if n else np.zeros(0)
        if not keys:
            out[e._name] = infer_objects(object_array([e._agg(vals)]))
        else:
            out[e._name] = infer_objects(object_array(
                [e._agg(vals[r]) for r in rows]))
    return out


class GroupedData:
    def __init__(self, df, keys: List[Column]):
        self._df = df
        self._keys = keys

    def _grouped(self) -> Tuple[Block, List[str]]:
        block = dict(self._df._whole())
        for k in self._keys:
            if k._name not in block:
                block[k._name] = k._eval(block, EvalContext())
        return block, [k._name for k in self._keys]

    def agg(self, *exprs):
        from .dataframe import DataFrame, _hash_repartition
        if len(exprs) == 1 and isinstance(exprs[0], dict):
            from . import functions as F
            mapping = {"avg": F.avg, "mean": F.avg, "max": F.max,
                       "min": F.min, "sum": F.sum, "count": F.count,
                       "stddev": F.stddev, "first": F.first, "last": F.last}
            exprs = tuple(mapping[op](c) for c, op in exprs[0].items())
        parent = self

        def compute():
            block, key_names = parent._grouped()
            out = aggregate(block, key_names, list(exprs))
            if key_names:
                return _hash_repartition(
                    out, key_names,
                    GLOBAL_CONF.getInt("sml.shuffle.partitions"))
            return [out]

        return DataFrame(compute, session=self._df._session, op="agg")

    def count(self):
        from . import functions as F
        return self.agg(F.count("*").alias("count"))

    def _simple(self, op: str, cols):
        from . import functions as F
        fns = {"avg": F.avg, "mean": F.avg, "sum": F.sum, "min": F.min,
               "max": F.max}
        if not cols:
            keys = [k._name for k in self._keys]
            cols = [c for c, v in self._df._whole().items()
                    if v.ndim == 1 and v.dtype.kind in "ifu"
                    and c not in keys]
        return self.agg(*[fns[op](c) for c in cols])

    def avg(self, *cols):
        return self._simple("avg", cols)

    mean = avg

    def sum(self, *cols):  # noqa: A003
        return self._simple("sum", cols)

    def min(self, *cols):  # noqa: A003
        return self._simple("min", cols)

    def max(self, *cols):  # noqa: A003
        return self._simple("max", cols)

    def applyInPandas(self, fn, schema):
        raise NotImplementedError(
            "applyInPandas hands pandas frames to user code: it waits for "
            "ROADMAP item 9b (what needs pandas or pyarrow)")

    def applyInPandasWithState(self, *a, **k):
        raise NotImplementedError(
            "stateful streaming aggregation is not supported")

    def pivot(self, pivot_col: str, values=None):
        raise NotImplementedError(
            "pivot is not in the covered course surface")
