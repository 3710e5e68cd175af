"""Partitioned, lazily evaluated DataFrame over numpy blocks.

The port's copy of `sml_tpu/frame/dataframe.py`. A DataFrame is a
recipe (`_compute`) producing a list of blocks ("partitions"), each a
dict of equal-length numpy arrays; transformations compose recipes and
nothing runs until an action (count, collect, show). The first
materialization is kept (`cache()` semantics).

- Narrow ops run per partition with an EvalContext (partition index,
  global row offset), so partition-sensitive semantics (seeded
  `randomSplit`, `rand`, `monotonically_increasing_id`) are the same
  functions of (seed, partition layout) as in the JAX package, row for
  row.
- Wide ops (`dropDuplicates`, `repartition` by columns) place rows by
  Murmur3 hash (`native/hashing.py`) into `sml.shuffle.partitions`
  blocks; `orderBy` and `unionByName` concatenate and split.
- Columns: float64 (NULL is NaN), int64, bool, object (strings, None
  for NULL), and 2-D float64 blocks for vector columns.

- Joins reproduce pandas' `merge` (which the JAX package runs): inner
  and left joins in the left side's order, right joins in the right
  side's, full joins by the sorted keys; NULL keys match each other.

Not ported yet (they wait for their slices): `writeStream`,
`mapInPandas`, `to_koalas` and `rdd`.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..conf import GLOBAL_CONF
from ..native.hashing import hash_columns, hash_partition_ids, null_mask
from ..utils.profiler import PROFILER
from .column import (Block, Column, EvalContext, NamedColumn,
                     block_len, ensure_column, infer_objects, object_array,
                     to_numeric)
from .functions import nanmean, nanvar
from .types import Row, StructType, infer_schema

Partitions = List[Block]


def take_rows(block: Block, idx) -> Block:
    """The rows `idx` (indices or a boolean mask) of every column."""
    return {c: v[idx] for c, v in block.items()}


def split_rows(block: Block, n: int) -> Partitions:
    """`np.array_split` of a block's rows into n partitions."""
    n = max(1, int(n))
    return [take_rows(block, ix)
            for ix in np.array_split(np.arange(block_len(block)), n)]


def _concat_column(parts: List[np.ndarray]) -> np.ndarray:
    kinds = {p.dtype.kind for p in parts}
    if "O" in kinds and len(kinds) > 1:
        parts = [p if p.dtype.kind == "O" else object_array(p.tolist())
                 for p in parts]
    return np.concatenate(parts, axis=0)


def concat_blocks(parts: Partitions) -> Block:
    """The rows of every partition, in order, as one block. Columns
    follow the first partition that has any."""
    parts = [p for p in parts if p]
    if not parts:
        return {}
    if len(parts) == 1:
        return dict(parts[0])
    return {c: _concat_column([p[c] for p in parts]) for c in parts[0]}


def _py(v):
    """A cell as a Python value: NaN and None are None, numpy scalars
    their Python twins, a vector row a DenseVector."""
    from ..ml.linalg import DenseVector
    if isinstance(v, np.ndarray):
        return DenseVector(v)
    if v is None or (isinstance(v, (float, np.floating)) and v != v):
        return None
    return v.item() if isinstance(v, np.generic) else v


def rows_of(block: Block) -> List[Row]:
    cols = list(block)
    return [Row(**{c: _py(block[c][i]) for c in cols})
            for i in range(block_len(block))]


def coerce_to_schema(block: Block, schema: StructType) -> Block:
    """Project and cast a block to a StructType."""
    from .column import cast_values
    n = block_len(block)
    out = {}
    for f in schema.fields:
        s = block[f.name] if f.name in block else object_array([None] * n)
        t = f.dataType.simpleString()
        if t in ("int", "bigint"):
            s = to_numeric(s)
            if not (s.dtype.kind == "f" and np.isnan(s).any()):
                s = s.astype(np.int64 if t == "bigint" else np.int32)
        elif t != "vector":
            s = cast_values(s, t)
        out[f.name] = s
    return out


class DataFrame:
    isStreaming = False

    def __init__(self, compute: Callable[[], Partitions],
                 session=None, schema: Optional[StructType] = None,
                 op: str = "frame"):
        self._op = op
        self._compute = compute
        self._lock = threading.RLock()
        self._session = session
        self._schema_hint = schema
        self._parts: Optional[Partitions] = None
        self._offsets: Optional[List[int]] = None
        self._whole_cache: Optional[Block] = None
        # ML column attributes (the categorical cardinality StringIndexer
        # sets, the per-slot metadata VectorAssembler sets): the
        # equivalent of Spark ML's column metadata that tree learners
        # read for maxBins semantics
        self._ml_attrs: Dict[str, Any] = {}
        # (weights, seed, sampler) -> child frames: repeated identical
        # randomSplits return the same children (see randomSplit)
        self._split_memo: Dict[tuple, list] = {}

    # ------------------------------------------------------------------ core
    @classmethod
    def from_block(cls, block: Block, session=None,
                   num_partitions: Optional[int] = None,
                   schema: Optional[StructType] = None) -> "DataFrame":
        """A frame of one block's rows in `num_partitions` partitions
        (`sml.default.parallelism` by default, at most one per row)."""
        if num_partitions is None:
            num_partitions = GLOBAL_CONF.getInt("sml.default.parallelism")
        n = min(num_partitions, max(1, block_len(block)))
        return cls(lambda: split_rows(block, n), session=session,
                   schema=schema, op="createDataFrame")

    @classmethod
    def from_partitions(cls, parts: Partitions, session=None,
                        schema: Optional[StructType] = None) -> "DataFrame":
        return cls(lambda: parts, session=session, schema=schema,
                   op="from_partitions")

    def _materialize(self) -> Partitions:
        # tuning's trials share frames across threads: one computes, the
        # others wait for its partitions
        with self._lock:
            if self._parts is None:
                with PROFILER.span(f"materialize.{self._op}"):
                    parts = self._compute() or [{}]
                offs, acc = [], 0
                for p in parts:
                    offs.append(acc)
                    acc += block_len(p)
                self._offsets = offs
                self._parts = parts
                # release the recipe: its closure holds the parent chain
                self._compute = None  # type: ignore[assignment]
                # an evaluator-pushdown hook is dead once the frame is
                # materialized: drop it so it stops pinning the parent
                if self.__dict__.get("_fused_eval") is not None:
                    self.__dict__["_fused_eval"] = None
        return self._parts

    def _contexts(self) -> List[EvalContext]:
        parts = self._materialize()
        return [EvalContext(i, len(parts), self._offsets[i])
                for i in range(len(parts))]

    def _derive(self, fn: Callable[[Block, EvalContext], Block],
                schema: Optional[StructType] = None,
                op: str = "derive") -> "DataFrame":
        parent = self

        def compute() -> Partitions:
            parts = parent._materialize()
            return [fn(p, c) for p, c in zip(parts, parent._contexts())]

        out = DataFrame(compute, session=self._session, schema=schema, op=op)
        out._ml_attrs = dict(self._ml_attrs)
        return out

    def _derive_rowlocal(self, fn: Callable[[Block, EvalContext], Block],
                         op: str = "derive") -> "DataFrame":
        """_derive for row-local, row-count-preserving fns (model
        predicts): fn runs once over the concatenated partitions and the
        result splits back on the same boundaries, so a model makes one
        device round trip, not one per partition."""
        parent = self

        def compute() -> Partitions:
            parts = parent._materialize()
            if len(parts) <= 1:
                return [fn(p, c) for p, c in zip(parts, parent._contexts())]
            out = fn(parent._whole(), EvalContext(0, 1, 0))
            if block_len(out) != sum(block_len(p) for p in parts):
                raise ValueError("_derive_rowlocal fn must preserve the "
                                 "row count")
            bounds = np.cumsum([0] + [block_len(p) for p in parts])
            return [take_rows(out, slice(lo, hi))
                    for lo, hi in zip(bounds[:-1], bounds[1:])]

        out = DataFrame(compute, session=self._session, op=op)
        out._ml_attrs = dict(self._ml_attrs)
        return out

    def _whole(self) -> Block:
        """Every partition's rows as one block, memoized per frame (the
        port's counterpart of the JAX frame's memoized `toPandas`). The
        arrays are shared: callers must not write to them."""
        if self._whole_cache is None:
            self._whole_cache = concat_blocks(self._materialize())
        return self._whole_cache

    # ------------------------------------------------------------ metadata
    @property
    def schema(self) -> StructType:
        if self._schema_hint is None:
            parts = self._materialize()
            self._schema_hint = infer_schema(max(parts, key=block_len))
        return self._schema_hint

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    @property
    def dtypes(self) -> List[Tuple[str, str]]:
        return [(f.name, f.dataType.simpleString())
                for f in self.schema.fields]

    def printSchema(self) -> None:
        print(self.schema.treeString())

    def __getitem__(self, item) -> Column:
        return NamedColumn(item)

    def __getattr__(self, item) -> Column:
        if item.startswith("_"):
            raise AttributeError(item)
        sch = self.__dict__.get("_schema_hint")
        if sch is not None and item not in sch.names:
            raise AttributeError(item)
        return NamedColumn(item)

    # ------------------------------------------------------------- actions
    def count(self) -> int:
        return sum(block_len(p) for p in self._materialize())

    def isEmpty(self) -> bool:
        return self.count() == 0

    def toPandas(self):
        """A pandas DataFrame of every row (vector columns as lists of
        DenseVector). Imports pandas inside the call: the port itself
        needs none, and raises ImportError where it is absent."""
        import pandas as pd
        whole = self._whole()
        return pd.DataFrame({
            c: (object_array(_py(r) for r in v) if v.ndim == 2 else v.copy())
            for c, v in whole.items()})

    def collect(self) -> List[Row]:
        return rows_of(self._whole())

    def first(self) -> Optional[Row]:
        rows = self.limit(1).collect()
        return rows[0] if rows else None

    def head(self, n: int = 1):
        rows = self.limit(n).collect()
        if n == 1:
            return rows[0] if rows else None
        return rows

    def take(self, n: int) -> List[Row]:
        return self.limit(n).collect()

    def tail(self, n: int) -> List[Row]:
        if n < 0:
            raise ValueError(f"tail expects a non-negative n, got {n}")
        whole = self._whole()
        k = block_len(whole)
        return rows_of(take_rows(whole, slice(max(0, k - n), k)))

    def show(self, n: int = 20, truncate: bool = True) -> None:
        rows = self.limit(n).collect()
        cols = self.columns

        def cell(v):
            s = "null" if v is None else str(v)
            return s[:17] + "..." if truncate and len(s) > 20 else s
        table = [cols] + [[cell(r[c]) for c in cols] for r in rows]
        widths = [max(len(line[i]) for line in table)
                  for i in range(len(cols))]
        for line in table:
            print(" ".join(s.rjust(w) for s, w in zip(line, widths)))

    # ------------------------------------------------------ narrow transforms
    def select(self, *cols) -> "DataFrame":
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        agg_cols = [c for c in cols
                    if isinstance(c, Column) and c._agg is not None]
        if agg_cols and len(agg_cols) == len(cols):
            return self.groupBy().agg(*agg_cols)

        def fn(block: Block, ctx: EvalContext) -> Block:
            out: Block = {}
            for c in cols:
                if (isinstance(c, str) and c == "*") or \
                        (isinstance(c, NamedColumn) and c.ref == "*"):
                    out.update(block)
                    continue
                cc = ensure_column(c)
                out[cc._name] = cc._eval(block, ctx)
            return out

        return self._derive(fn, op="select")

    def selectExpr(self, *exprs: str) -> "DataFrame":
        from .sql import parse_simple_expr
        return self.select(*[parse_simple_expr(e) for e in exprs])

    def withColumn(self, name: str, col: Column) -> "DataFrame":
        cc = ensure_column(col)

        def fn(block, ctx):
            out = dict(block)
            out[name] = cc._eval(block, ctx)
            return out

        out = self._derive(fn, op="withColumn")
        # evaluator-pushdown propagation: replacing the prediction column
        # with a known elementwise link of itself (the ML 11 shape: train
        # on log(price), exponentiate predictions, evaluate on the
        # original scale) keeps the hook alive with the link composed in
        hook = getattr(self, "_fused_eval", None)
        unary = getattr(cc, "_unary_of", None)
        if hook is not None and unary is not None and unary[1] == name:
            linked = hook.with_link(unary[0], name)
            if linked is not None:
                out._fused_eval = linked
        return out

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        return self._derive(lambda b, ctx: {new if c == old else c: v
                                            for c, v in b.items()},
                            op="withColumnRenamed")

    def drop(self, *cols) -> "DataFrame":
        names = {c._name if isinstance(c, Column) else c for c in cols}
        return self._derive(lambda b, ctx: {c: v for c, v in b.items()
                                            if c not in names}, op="drop")

    def filter(self, condition: Union[Column, str]) -> "DataFrame":
        if isinstance(condition, str):
            from .sql import parse_simple_expr
            condition = parse_simple_expr(condition)

        def fn(block, ctx):
            from .column import truthy
            return take_rows(block, truthy(condition._eval(block, ctx)))

        return self._derive(fn, op="filter")

    where = filter

    def limit(self, n: int) -> "DataFrame":
        parent = self

        def compute() -> Partitions:
            taken, out = 0, []
            for p in parent._materialize():
                if taken >= n:
                    break
                k = min(n - taken, block_len(p))
                out.append(take_rows(p, slice(0, k)))
                taken += k
            return out

        return DataFrame(compute, session=self._session, op="limit")

    def toDF(self, *names: str) -> "DataFrame":
        return self._derive(lambda b, ctx: dict(zip(names, b.values())),
                            op="toDF")

    def alias(self, name: str) -> "DataFrame":
        return self

    def dropna(self, how: str = "any", thresh: Optional[int] = None,
               subset: Optional[Sequence[str]] = None) -> "DataFrame":
        def fn(block, ctx):
            cols = list(subset) if subset is not None else list(block)
            if not cols:
                return block
            nulls = np.stack([null_mask(block[c]) if block[c].ndim == 1
                              else np.isnan(block[c]).all(axis=1)
                              for c in cols], axis=1)
            if thresh is not None:
                keep = (~nulls).sum(axis=1) >= thresh
            elif how == "all":
                keep = ~nulls.all(axis=1)
            else:
                keep = ~nulls.any(axis=1)
            return take_rows(block, keep)
        return self._derive(fn, op="dropna")

    def fillna(self, value, subset: Optional[Sequence[str]] = None
               ) -> "DataFrame":
        def fill(v: np.ndarray, val) -> np.ndarray:
            nulls = null_mask(v)
            if not nulls.any():
                return v
            out = v.copy() if v.dtype.kind == "O" else v.astype(
                np.result_type(v, type(val)))
            out[nulls] = val
            return out

        def fn(block, ctx):
            out = dict(block)
            if isinstance(value, dict):
                for c, val in value.items():
                    if c in out:
                        out[c] = fill(out[c], val)
                return out
            for c in (subset or list(out)):
                if c not in out or out[c].ndim != 1:
                    continue
                kind = out[c].dtype.kind
                # Spark: a numeric fill only touches numeric columns, a
                # string fill only string ones
                if isinstance(value, (int, float)) and kind not in "ifu":
                    continue
                if isinstance(value, str) and kind in "ifub":
                    continue
                out[c] = fill(out[c], value)
            return out
        return self._derive(fn, op="fillna")

    @property
    def na(self) -> "DataFrameNaFunctions":
        return DataFrameNaFunctions(self)

    @property
    def stat(self) -> "DataFrameStatFunctions":
        return DataFrameStatFunctions(self)

    # -------------------------------------------------------- wide transforms
    def distinct(self) -> "DataFrame":
        return self.dropDuplicates()

    def dropDuplicates(self, subset: Optional[Sequence[str]] = None
                       ) -> "DataFrame":
        parent = self

        def compute() -> Partitions:
            with PROFILER.span("shuffle.dropDuplicates"):
                whole = parent._whole()
                keys = list(subset) if subset else list(whole)
                cols = [whole[k].tolist() for k in keys]
                seen, keep = set(), []
                for i, row in enumerate(zip(*cols)):
                    # NaN == NaN for duplicates, as pandas has it
                    key = tuple("\0nan" if isinstance(v, float) and v != v
                                else v for v in row)
                    if key not in seen:
                        seen.add(key)
                        keep.append(i)
                kept = take_rows(whole, np.asarray(keep, dtype=np.intp))
                return _hash_repartition(
                    kept, keys, GLOBAL_CONF.getInt("sml.shuffle.partitions"))

        return DataFrame(compute, session=self._session, op="dropDuplicates")

    drop_duplicates = dropDuplicates

    def union(self, other: "DataFrame") -> "DataFrame":
        """Positional union: the right side's columns take the left's
        names by position."""
        parent = self

        def compute() -> Partitions:
            a = [p for p in parent._materialize() if block_len(p)]
            b = [p for p in other._materialize() if block_len(p)]
            names = list((a or b or [{}])[0])
            return a + [dict(zip(names, p.values())) for p in b]

        return DataFrame(compute, session=self._session, op="union")

    unionAll = union

    def unionByName(self, other: "DataFrame",
                    allowMissingColumns: bool = False) -> "DataFrame":
        parent = self

        def compute() -> Partitions:
            a, b = parent._whole(), other._whole()
            names = list(a) + ([c for c in b if c not in a]
                               if allowMissingColumns else [])

            def pad(blk: Block) -> Block:
                return {c: blk[c] if c in blk
                        else object_array([None] * block_len(blk))
                        for c in names}
            out = concat_blocks([pad(a), pad(b)])
            for c in names:
                if c not in a or c not in b:  # NULLs next to values
                    out[c] = infer_objects(out[c])
            return split_rows(out,
                              GLOBAL_CONF.getInt("sml.shuffle.partitions"))

        return DataFrame(compute, session=self._session, op="unionByName")

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """pandas' `merge` of the two frames (the JAX package's join):
        `on` names the key columns (None: the columns both have), a
        right column whose name clashes gets the suffix "_r"; semi and
        anti joins keep the left rows whose key tuple the right side has
        (has not). The result is hash-partitioned by `on`."""
        parent = self
        keys = [on] if isinstance(on, str) \
            else list(on) if on is not None else None

        def compute() -> Partitions:
            with PROFILER.span("shuffle.join"):
                left, right = parent._whole(), other._whole()
                out = _merge(left, right, keys, how)
                nparts = GLOBAL_CONF.getInt("sml.shuffle.partitions")
                if keys:
                    return _hash_repartition(out, keys, nparts)
                return split_rows(out, nparts)

        return DataFrame(compute, session=self._session, op="join")

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return self.join(other, on=None, how="cross")

    def groupBy(self, *cols):
        from .grouped import GroupedData
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        return GroupedData(self, [ensure_column(c) for c in cols])

    groupby = groupBy

    def agg(self, *cols) -> "DataFrame":
        return self.groupBy().agg(*cols)

    def orderBy(self, *cols, ascending=None) -> "DataFrame":
        """A stable sort by the columns, NULLs last (pandas'
        `sort_values(kind="mergesort")`), kept in as many partitions as
        the parent had."""
        from .sampling import sort_keys
        parent = self
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])

        def compute() -> Partitions:
            with PROFILER.span("shuffle.sort"):
                whole = dict(parent._whole())
                by, desc = [], []
                for i, c in enumerate(cols):
                    if isinstance(c, str):
                        by.append(c)
                        desc.append(False)
                    else:
                        whole[f"__sort_{i}"] = c._eval(whole, EvalContext())
                        by.append(f"__sort_{i}")
                        desc.append(bool(c._sort_desc))
                if ascending is not None:
                    flags = list(ascending) if isinstance(
                        ascending, (list, tuple)) else [ascending] * len(by)
                    desc = [not bool(a) for a in flags]
                order = sort_keys(whole, by, desc, nulls_first=False)
                out = {c: v[order] for c, v in whole.items()
                       if not c.startswith("__sort_")}
                return split_rows(out, max(1, len(parent._materialize())))

        return DataFrame(compute, session=self._session, op="orderBy")

    sort = orderBy

    # ----------------------------------------------------- partitioning ops
    def repartition(self, num: Union[int, str, Column], *cols
                    ) -> "DataFrame":
        """Round-robin into `num` partitions, or by Murmur3 hash of the
        given columns (into `sml.shuffle.partitions` when no count is
        given)."""
        parent = self
        if not isinstance(num, int):
            cols = (num,) + cols
            num = GLOBAL_CONF.getInt("sml.shuffle.partitions")
        keys = [c if isinstance(c, str) else c._name for c in cols]

        def compute() -> Partitions:
            with PROFILER.span("shuffle.repartition"):
                whole = parent._whole()
                if keys:
                    return _hash_repartition(whole, keys, num)
                ids = np.arange(block_len(whole)) % num
                return [take_rows(whole, ids == i) for i in range(num)]

        return DataFrame(compute, session=self._session, op="repartition")

    def coalesce(self, num: int) -> "DataFrame":
        parent = self

        def compute() -> Partitions:
            parts = parent._materialize()
            if num >= len(parts):
                return parts
            groups = np.array_split(np.arange(len(parts)), num)
            return [concat_blocks([parts[i] for i in g]) for g in groups]

        return DataFrame(compute, session=self._session, op="coalesce")

    def getNumPartitions(self) -> int:
        return len(self._materialize())

    @property
    def rdd(self) -> "_RDDShim":
        return _RDDShim(self)

    def checkpoint(self, eager: bool = True) -> "DataFrame":
        """Materialize the frame and return it (the lineage is dropped
        when it materializes)."""
        self._materialize()
        return self

    # -------------------------------------------------------------- sampling
    def randomSplit(self, weights: Sequence[float],
                    seed: Optional[int] = None) -> List["DataFrame"]:
        """Spark's split, draw for draw (`frame/sampling.py`): each
        partition is sorted locally (Dataset.randomSplit's determinism
        sort), then every weight cell keeps row i iff its
        `XORShiftRandom(seed + partitionIndex)` uniform lands in the
        cell's [lo, hi), so the result depends on the partition layout
        as in Spark. `sml.split.sampler=legacy` draws the JAX package's
        older numpy uniforms instead (no sort).

        Identical (weights, seed) splits of this frame return the same
        child frames (the last two splits are remembered): frames are
        immutable and the sampler is deterministic."""
        from .sampling import partition_uniforms, presplit_sort
        explicit_seed = seed is not None
        seed = int(seed) if explicit_seed \
            else int(np.random.SeedSequence().entropy % (2 ** 31))
        sampler = str(GLOBAL_CONF.get("sml.split.sampler"))
        memo_key = (tuple(float(w) for w in weights), seed, sampler)
        if explicit_seed and memo_key in self._split_memo:
            return list(self._split_memo[memo_key])
        total = float(np.sum(weights))
        bounds = np.cumsum([w / total for w in weights])
        legacy = sampler == "legacy"
        # the cells share one sorted copy of each partition
        source = self if legacy else self._derive(
            lambda b, ctx: presplit_sort(b), op="presplit_sort")

        def make(i: int) -> DataFrame:
            lo = 0.0 if i == 0 else bounds[i - 1]
            hi = bounds[i]

            def fn(block: Block, ctx: EvalContext) -> Block:
                n = block_len(block)
                if legacy:
                    u = np.random.default_rng(
                        (seed << 16) + ctx.partition_index).random(n)
                else:
                    u = partition_uniforms(seed, ctx.partition_index, n)
                return take_rows(block, (u >= lo) & (u < hi))

            return source._derive(fn, op="randomSplit")

        outs = [make(i) for i in range(len(weights))]
        if explicit_seed:
            if len(self._split_memo) >= 2:
                self._split_memo.pop(next(iter(self._split_memo)))
            self._split_memo[memo_key] = list(outs)
        return outs

    def sample(self, withReplacement: bool = False, fraction: float = 0.1,
               seed: Optional[int] = None) -> "DataFrame":
        seed = int(seed) if seed is not None \
            else int(np.random.SeedSequence().entropy % (2 ** 31))

        def fn(block: Block, ctx: EvalContext) -> Block:
            rng = np.random.default_rng((seed << 16) + ctx.partition_index)
            n = block_len(block)
            if withReplacement:
                k = rng.poisson(fraction * n)
                idx = rng.integers(0, max(n, 1), size=k) if n \
                    else np.zeros(0, dtype=np.intp)
                return take_rows(block, idx)
            return take_rows(block, rng.random(n) < fraction)

        return self._derive(fn, op="sample")

    # ------------------------------------------------------------ caching
    def cache(self) -> "DataFrame":
        self._materialize()
        return self

    def persist(self, *_args) -> "DataFrame":
        return self.cache()

    def unpersist(self) -> "DataFrame":
        # materializing releases the recipe, so data is dropped only
        # where it can still be recomputed
        if self._compute is not None:
            self._parts = None
            self._offsets = None
        self._whole_cache = None
        return self

    # ------------------------------------------------------------- stats
    def describe(self, *cols) -> "DataFrame":
        return self._describe(["count", "mean", "stddev", "min", "max"],
                              cols)

    def summary(self, *stats) -> "DataFrame":
        stats = list(stats) or ["count", "mean", "stddev", "min", "25%",
                                "50%", "75%", "max"]
        return self._describe(stats, ())

    def _describe(self, stats: List[str], cols) -> "DataFrame":
        """Each statistic of each column as a string, computed as the JAX
        package's pandas `describe` computes it (skipna sums in the same
        order; quantiles by linear interpolation)."""
        whole = self._whole()
        names = list(cols) or [c for c, v in whole.items() if v.ndim == 1]
        out: Block = {"summary": object_array(stats)}
        for c in names:
            s = whole[c]
            numeric = s.dtype.kind in "ifu"
            present = s[~null_mask(s)]
            vals = []
            for st in stats:
                if st == "count":
                    v = len(present)
                elif st == "mean":
                    v = nanmean(s) if numeric else None
                elif st == "stddev":
                    v = np.sqrt(nanvar(s, 1)) if numeric else None
                elif st in ("min", "max"):
                    v = None if not len(present) else (
                        (np.min if st == "min" else np.max)(present)
                        if numeric else
                        (min if st == "min" else max)(present.tolist()))
                elif st.endswith("%") and numeric:
                    v = np.percentile(present.astype(np.float64),
                                      float(st[:-1])) if len(present) \
                        else np.nan
                else:
                    v = None
                vals.append(None if v is None else str(
                    np.float64(v) if isinstance(v, float) else v))
            out[c] = object_array(vals)
        return DataFrame.from_block(out, session=self._session,
                                    num_partitions=1)

    def corr(self, col1: str, col2: str) -> float:
        """Pearson correlation of two columns, rows with a NULL in either
        dropped (pandas' `Series.corr`)."""
        from .functions import pair_corr
        whole = self._whole()
        return pair_corr(np.stack([to_numeric(whole[c]).astype(np.float64)
                                   for c in (col1, col2)], axis=1))

    # ------------------------------------------------------------ views / IO
    def createOrReplaceTempView(self, name: str) -> None:
        if self._session is None:
            raise RuntimeError("DataFrame has no session; use "
                               "TpuSession.createDataFrame")
        self._session.catalog._register_view(name, self)

    @property
    def write(self):
        from .io import DataFrameWriter
        return DataFrameWriter(self)

    def approxQuantile(self, col: Union[str, List[str]],
                       probabilities: Sequence[float],
                       relativeError: float = 0.0) -> List:
        """Exact quantiles by linear interpolation (the JAX package's
        pandas `quantile`), whatever the relative error."""
        whole = self._whole()

        def q(c):
            v = to_numeric(whole[c]).astype(np.float64)
            v = v[~np.isnan(v)]
            return [float(np.percentile(v, p * 100)) for p in probabilities]
        return q(col) if isinstance(col, str) else [q(c) for c in col]

    def __repr__(self):
        try:
            cols = ", ".join(f"{n}: {t}" for n, t in self.dtypes[:8])
        except Exception:  # noqa: BLE001 - a repr must not raise
            cols = "..."
        return f"DataFrame[{cols}]"


class _RDDShim:
    """`df.rdd`'s partition introspection (`ML 00b:84` and the
    repartition demos)."""

    def __init__(self, df: DataFrame):
        self._df = df

    def getNumPartitions(self) -> int:
        return self._df.getNumPartitions()

    def glom(self) -> List[List[Dict[str, Any]]]:
        """Each partition's rows, as dicts of Python values."""
        return [[r.asDict() for r in rows_of(p)]
                for p in self._df._materialize()]


class DataFrameNaFunctions:
    def __init__(self, df: DataFrame):
        self._df = df

    def drop(self, how: str = "any", thresh: Optional[int] = None,
             subset: Optional[Sequence[str]] = None) -> DataFrame:
        return self._df.dropna(how=how, thresh=thresh, subset=subset)

    def fill(self, value, subset: Optional[Sequence[str]] = None
             ) -> DataFrame:
        return self._df.fillna(value, subset=subset)


class DataFrameStatFunctions:
    def __init__(self, df: DataFrame):
        self._df = df

    def corr(self, col1: str, col2: str) -> float:
        return self._df.corr(col1, col2)

    def approxQuantile(self, col, probabilities, relativeError=0.0):
        return self._df.approxQuantile(col, probabilities, relativeError)


# ------------------------------------------------------------------ joins
_HOW = {"inner": "inner", "left": "left", "left_outer": "left",
        "leftouter": "left", "right": "right", "right_outer": "right",
        "rightouter": "right", "outer": "outer", "full": "outer",
        "full_outer": "outer", "fullouter": "outer", "cross": "cross",
        "left_semi": "semi", "leftsemi": "semi", "semi": "semi",
        "left_anti": "anti", "leftanti": "anti", "anti": "anti"}


def _key_tuples(block: Block, keys: List[str]) -> List[tuple]:
    """Each row's key values, NULL (None or NaN) as one marker, so NULL
    keys match each other as pandas' merge and `isin` match them."""
    from .grouped import _NULL
    cols = []
    for k in keys:
        v = block[k]
        nulls = null_mask(v)
        cols.append([_NULL if nulls[i] else x
                     for i, x in enumerate(v.tolist())])
    return list(zip(*cols)) if cols else []


def _sort_token(key: tuple) -> tuple:
    """A sort key putting NULL after every value, level by level."""
    from .grouped import _NULL
    return tuple((1, 0) if v is _NULL else (0, v) for v in key)


def _merge_indexers(lk: List[tuple], rk: List[tuple], how: str):
    """(left row, right row) pairs of pandas' merge, -1 where a side has
    no row."""
    right_rows: Dict[tuple, List[int]] = {}
    for j, k in enumerate(rk):
        right_rows.setdefault(k, []).append(j)
    pairs: List[Tuple[int, int]] = []
    if how in ("inner", "left"):
        for i, k in enumerate(lk):
            js = right_rows.get(k)
            if js:
                pairs.extend((i, j) for j in js)
            elif how == "left":
                pairs.append((i, -1))
    elif how == "right":
        left_rows: Dict[tuple, List[int]] = {}
        for i, k in enumerate(lk):
            left_rows.setdefault(k, []).append(i)
        for j, k in enumerate(rk):
            is_ = left_rows.get(k)
            if is_:
                pairs.extend((i, j) for i in is_)
            else:
                pairs.append((-1, j))
    else:  # outer: key groups in sorted order, each left-major
        left_rows = {}
        for i, k in enumerate(lk):
            left_rows.setdefault(k, []).append(i)
        for k in sorted(set(left_rows) | set(right_rows), key=_sort_token):
            is_, js = left_rows.get(k, [-1]), right_rows.get(k, [-1])
            pairs.extend((i, j) for i in is_ for j in js)
    if not pairs:
        return np.zeros(0, np.intp), np.zeros(0, np.intp)
    li, ri = (np.asarray(x, dtype=np.intp) for x in zip(*pairs))
    return li, ri


def _take_filled(v: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """`v[idx]` with NULL where idx is -1 (an integer column becomes
    float64, a boolean one object, as pandas' take with fill)."""
    miss = idx < 0
    if not miss.any():
        return v[idx]
    safe = np.where(miss, 0, idx)
    out = v[safe] if len(v) else np.zeros((len(idx),) + v.shape[1:],
                                          dtype=v.dtype)
    kind = v.dtype.kind
    if kind in "iuf":
        out = out.astype(np.float64)
        out[miss] = np.nan
    elif kind in "Mm":
        out[miss] = np.datetime64("NaT") if kind == "M" \
            else np.timedelta64("NaT")
    else:
        out = out.astype(object)
        out[miss] = None
    return out


def _coalesce_key(lv: np.ndarray, rv: np.ndarray, li: np.ndarray,
                  ri: np.ndarray) -> np.ndarray:
    """A join key's column: the left row's value, or the right row's
    where there is no left row (pandas' merge keeps one key column)."""
    if not (li < 0).any():
        return lv[li]
    both_typed = lv.dtype.kind != "O" and rv.dtype.kind != "O"
    dtype = np.result_type(lv, rv) if both_typed else object
    out = np.empty(len(li), dtype=dtype)
    has_left = li >= 0
    out[has_left] = lv[li[has_left]]
    out[~has_left] = rv[ri[~has_left]]
    return out


def _merge(left: Block, right: Block, keys: Optional[List[str]],
           how: str) -> Block:
    hw = _HOW.get(how)
    if hw is None:
        raise ValueError(f"unknown join type {how!r}")
    if hw in ("semi", "anti"):
        have = set(_key_tuples(right, keys))
        mask = np.fromiter((k in have for k in _key_tuples(left, keys)),
                           dtype=bool, count=block_len(left))
        return take_rows(left, mask if hw == "semi" else ~mask)
    if hw == "cross":
        nl, nr = block_len(left), block_len(right)
        li, ri = np.repeat(np.arange(nl), nr), np.tile(np.arange(nr), nl)
        keys, suffixes = [], ("_x", "_y")
    else:
        if keys is None:
            keys = [c for c in left if c in right]
            if not keys:
                raise ValueError("no common columns to join on")
        li, ri = _merge_indexers(_key_tuples(left, keys),
                                 _key_tuples(right, keys), hw)
        suffixes = ("", "_r")
    clash = {c for c in left if c in right and c not in keys}
    out: Block = {}
    for c, v in left.items():
        if c in keys:
            out[c] = _coalesce_key(v, right[c], li, ri)
        else:
            out[c + suffixes[0] if c in clash else c] = _take_filled(v, li)
    for c, v in right.items():
        if c not in keys:
            out[c + suffixes[1] if c in clash else c] = _take_filled(v, ri)
    return out


def _hash_repartition(block: Block, keys: List[str], num: int) -> Partitions:
    """Murmur3 hash-partition rows by key columns (shuffle placement)."""
    n = block_len(block)
    if n == 0:
        return [block]
    ids = hash_partition_ids(hash_columns([block[k] for k in keys], n=n), num)
    parts = [take_rows(block, ids == i) for i in range(num)]
    sizes = np.array([block_len(p) for p in parts], dtype=float)
    PROFILER.count("shuffle.rows", float(sizes.sum()))
    with PROFILER.span("shuffle.partition", rows=int(sizes.sum()),
                       skew=float(sizes.max() / max(sizes.mean(), 1.0))):
        pass
    return parts
