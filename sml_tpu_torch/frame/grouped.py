"""GroupedData: keyed aggregation over numpy blocks.

The port's copy of `sml_tpu/frame/grouped.py` for `groupBy().count()`
and `agg(...)` (SURVEY L1). Groups come in order of first appearance,
NULL keys forming a group of their own (pandas' `groupby(sort=False,
dropna=False)`, which the JAX package runs); each aggregate reduces a
group's rows in their order, and the result is hash-partitioned by the
keys into `sml.shuffle.partitions` blocks, as in the JAX package.

`applyInPandas` (`ML 13:119-161`) hands each group, key columns
included, to a user function as a pandas frame (pandas imported inside
the call, `frame/_pandas.py`), on `sml.applyInPandas.parallelism`
worker threads; the outputs, cast to the schema, are concatenated and
hash-partitioned by the keys. The split of a frame into groups is the
shuffle's output: for a frame's memoized block (`DataFrame._whole`) it
is kept in a byte-bounded LRU (`sml.shuffle.reuseBytes`), keyed by that
block's identity and the keys, and `DataFrame.unpersist` drops its
entries. A function gets a fresh pandas copy of its group, so writing
to it reaches neither the cached split nor the source.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..conf import GLOBAL_CONF
from ..native.hashing import null_mask
from .column import (Block, Column, EvalContext, block_len, infer_objects,
                     object_array)

#: one NULL group, whatever NULL looks like in the column (None, NaN)
_NULL = object()

#: (id of a frame's memoized block, keys) -> (that block, its groups,
#: their bytes); the block is held so that its id cannot be reused
_split_cache: Dict[tuple, tuple] = {}
_split_lock = threading.Lock()


def block_bytes(block: Block) -> int:
    """A block's bytes: its arrays', and each Python object an object
    column holds (a split's cost is mostly its text)."""
    total = 0
    for v in block.values():
        total += v.nbytes
        if v.dtype.kind == "O":
            total += sum(sys.getsizeof(x) for x in v.tolist())
    return total


def _split_cache_get(ckey, token) -> Optional[list]:
    with _split_lock:
        hit = _split_cache.get(ckey)
    # `is`: an entry holds its block, so its id is not reused, but a
    # block memoized again for the same frame must miss
    return hit[1] if hit is not None and hit[0] is token else None


def _split_cache_put(ckey, token, groups: List[Block]) -> None:
    nbytes = sum(block_bytes(g) for g in groups) + block_bytes(token)
    max_bytes = GLOBAL_CONF.getInt("sml.shuffle.reuseBytes")
    if nbytes > max_bytes:
        return
    with _split_lock:
        _split_cache[ckey] = (token, groups, nbytes)
        total = sum(e[2] for e in _split_cache.values())
        while len(_split_cache) > 1 and total > max_bytes:
            total -= _split_cache.pop(next(iter(_split_cache)))[2]


def drop_split_cache_for(token) -> None:
    """Drop the cached splits of a frame's memoized block
    (`DataFrame.unpersist`)."""
    with _split_lock:
        for k in [k for k, v in _split_cache.items() if v[0] is token]:
            _split_cache.pop(k)


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

    def _grouped(self) -> Tuple[Block, List[str], Optional[Block]]:
        """(the frame's rows with every key column, the key names, the
        frame's memoized block where the keys are its columns, else
        None)."""
        token = self._df._whole()
        block = dict(token)
        for k in self._keys:
            if k._name not in block:
                block[k._name] = k._eval(block, EvalContext())
                token = None  # a computed key: beyond the memoized block
        return block, [k._name for k in self._keys], token

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
            block, key_names, _ = parent._grouped()
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

    def applyInPandas(self, fn: Callable, schema):
        """`fn` once a group, groups in order of first appearance (NULL
        keys a group of their own), each a pandas frame of the group's
        rows with the key columns; the outputs cast to `schema`,
        concatenated and hash-partitioned by the keys into
        min(groups, `sml.shuffle.partitions`) blocks (`ML 13:119-127`).
        The functions run on `sml.applyInPandas.parallelism` threads of
        this interpreter: a function that writes shared state needs 1."""
        from .dataframe import (DataFrame, _hash_repartition, concat_blocks,
                                take_rows)
        from .types import parse_schema
        sch = parse_schema(schema)
        parent = self

        def compute():
            from ._pandas import (block_to_pandas, coerce_pandas_to_schema,
                                  pandas)
            pd = pandas("applyInPandas")
            block, key_names, token = parent._grouped()
            if block_len(block) == 0:
                return [coerce_pandas_to_schema(pd.DataFrame(), sch)]
            ckey = (id(token), tuple(key_names)) if token is not None \
                else None
            groups = _split_cache_get(ckey, token) if ckey else None
            if groups is None:
                groups = [take_rows(block, r)
                          for r in group_rows(block, key_names)[1]]
                if ckey is not None:
                    _split_cache_put(ckey, token, groups)

            def run(g: Block) -> Block:
                return coerce_pandas_to_schema(
                    fn(block_to_pandas(g, "applyInPandas")), sch)

            par = GLOBAL_CONF.getInt("sml.applyInPandas.parallelism")
            if len(groups) > 1 and par > 1:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(
                        max_workers=min(par, len(groups))) as pool:
                    outs = list(pool.map(run, groups))
            else:
                outs = [run(g) for g in groups]
            full = concat_blocks(outs)
            nparts = max(1, min(len(outs),
                                GLOBAL_CONF.getInt("sml.shuffle.partitions")))
            avail = [k for k in key_names if k in full]
            if avail:
                return _hash_repartition(full, avail, nparts)
            return [full]

        return DataFrame(compute, session=self._df._session, schema=sch,
                         op="applyInPandas")

    def applyInPandasWithState(self, *a, **k):
        raise NotImplementedError(
            "stateful streaming aggregation is not supported")

    def pivot(self, pivot_col: str, values=None):
        raise NotImplementedError(
            "pivot is not in the covered course surface")
