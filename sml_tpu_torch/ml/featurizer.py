"""The compiled featurizer: a fitted prep chain as one columnar pass.

The port's copy of `sml_tpu/ml/featurizer.py`, over the port's numpy
blocks (`DataFrame._whole()`), never pandas. The chain Imputer ->
StringIndexer -> OneHotEncoder -> VectorAssembler is a static column
program: `CompiledFeaturizer` resolves it once into per-slot sources
that write straight into one preallocated (n, d) block, with no interim
frames. Its callers:

- `Pipeline.fit` (`try_fast_fit`): the prep stages fit from the raw
  block and the estimator reads the one-pass block (`_featurized`), or,
  for a linear or logistic fit whose block would reach
  `sml.linear.compactBytes`, its compact form (`CompactParts`,
  `_featurized_compact`), whose one-hot slots expand on the card
  (`linear_impl.gram_stats_compact`, `fit_logistic_compact`);
- `PipelineModel.transform` and its evaluator pushdown
  (`base.PipelineModel._fast_transform`, `base._ScorerEvalHook`);
- `DeviceScorer` on a raw batch and its factorized linear scorer
  (`inference.py`).

The index and one-hot sources call the stages' own lookup and writer
(`feature.index_codes`, `feature.write_onehot`), so the fused block is
the stage path's block by construction. Supported:
ImputerModel, StringIndexerModel (every handleInvalid; "skip" drops rows
through `keep`, and the labels take the same mask), OneHotEncoderModel
and VectorAssembler with handleInvalid "error" or "keep". Unlike the JAX
package, nothing falls back under an exception: whether a route applies
is decided from the stages and the frame before any work
(`fast_fit_applies`, `CompiledFeaturizer.inputs_ok`,
`CompiledFeaturizer.columns_recoverable`), and the chosen route's errors
propagate. The JAX package's pyarrow and pandas lookups (`_arrow_codes`,
`_index_for`) have no counterpart.

Where the JAX package's fused and stage paths differ, the port follows
the fused one: an Imputer fills every non-finite value (the stage fills
NaN only), every prep stage fits on the raw rows (the stage path fits
an Imputer placed after a skipping StringIndexer on the kept rows), and
a fused fit sizes a OneHotEncoder by its indexer's label count (the
stage by the largest index + 1, one more where "keep" indexed a NULL).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from ..frame.column import block_len, to_numeric

_ROUTES = {"on": True}


@contextlib.contextmanager
def stage_by_stage():
    """Inside the block, pipeline fits and transforms and new scorers
    run stage by stage (every fused route off): what the fused routes
    are held against."""
    prev = _ROUTES["on"]
    _ROUTES["on"] = False
    try:
        yield
    finally:
        _ROUTES["on"] = prev


def routes_on() -> bool:
    """Whether the fused routes may be taken (`stage_by_stage`)."""
    return _ROUTES["on"]


class CompactParts(NamedTuple):
    """Compact pre-expansion form of a numeric + one-hot feature block.

    The expanded (n, d) one-hot matrix never materializes on the host:
    `num` holds the plain numeric slots, `codes` the integer category
    codes, and `layout` the assembler's slot order as ("num", num_col) /
    ("oh", code_col, width) entries. The device programs expand the
    one-hots on the card (`linear_impl._expand`), so staging copies
    n*(p+k) words instead of n*d."""
    num: np.ndarray                 # (n, p) float32 numeric slots
    codes: np.ndarray               # (n, k) int32 category codes
    layout: tuple                   # slot-order expansion recipe
    width: int                      # expanded feature count d
    keep: Optional[np.ndarray]      # row-keep mask (indexer "skip" drops)

    def expand_host(self) -> np.ndarray:
        """(n, d) float32: the block the featurizer would build; the
        memory-heavy form for the paths that need X itself."""
        n = self.num.shape[0]
        out = np.zeros((n, self.width), dtype=np.float32)
        lo = 0
        for item in self.layout:
            if item[0] == "num":
                out[:, lo] = self.num[:, item[1]]
                lo += 1
            else:
                _, j, width = item
                idx = self.codes[:, j]
                ok = (idx >= 0) & (idx < width)
                rows = np.nonzero(ok)[0]
                out[rows, lo + idx[rows].astype(np.intp)] = 1.0
                lo += width
        return out

    def predict_affine(self, coef: np.ndarray, intercept: float) -> np.ndarray:
        """X @ coef + intercept in float64 without expanding: a numeric
        dot plus one table lookup per encoded column
        (w . onehot(i) == w[i])."""
        coef = np.asarray(coef, dtype=np.float64)
        acc = np.full(self.num.shape[0], float(intercept), dtype=np.float64)
        lo = 0
        num_cols, num_w = [], []
        for item in self.layout:
            if item[0] == "num":
                num_cols.append(item[1])
                num_w.append(coef[lo])
                lo += 1
            else:
                _, j, width = item
                idx = self.codes[:, j]
                table = coef[lo:lo + width]
                ok = (idx >= 0) & (idx < width)
                contrib = np.zeros(len(idx), dtype=np.float64)
                contrib[ok] = table[idx[ok].astype(np.intp)]
                acc += contrib
                lo += width
        if num_cols:
            acc += self.num[:, num_cols].astype(np.float64) \
                @ np.asarray(num_w)
        return acc


def _numeric(col: np.ndarray) -> np.ndarray:
    """`pd.to_numeric(col, errors="coerce")` as float64."""
    return np.asarray(to_numeric(col), dtype=np.float64)


def extract_numeric_block(block, cols: List[str],
                          fills: np.ndarray) -> np.ndarray:
    """(n, k) float64 block of `cols`, each column's non-finite values
    replaced by its fill where it has one (NaN: none). Shared by the
    fused pass and the factorized scorer, so their coercions agree."""
    n = len(block[cols[0]])
    out = np.empty((n, len(cols)), dtype=np.float64)
    for j, c in enumerate(cols):
        out[:, j] = _numeric(block[c])
    keep = np.isfinite(out) | np.isnan(fills)[None, :]
    return np.where(keep, out, fills[None, :])


def _plain_column(block, col: str) -> bool:
    """Whether `col` is in `block` as one value a row (not a vector
    column)."""
    from .linalg import Vector
    v = block.get(col)
    if v is None or v.ndim != 1:
        return False
    return not (v.dtype.kind == "O" and len(v) and isinstance(v[0], Vector))


class _Source:
    """One resolved input column: the slot(s) it writes."""

    width = 1


class _NumericSource(_Source):
    def __init__(self, col: str, fill: Optional[float] = None):
        self.col = col
        self.fill = fill  # the imputer's surrogate, applied on the fly

    def values(self, block) -> np.ndarray:
        v = _numeric(block[self.col])
        if self.fill is not None:
            v = np.where(np.isfinite(v), v, self.fill)
        return v


class _IndexSource(_Source):
    """StringIndexerModel output: label -> index (`feature.index_codes`),
    with the stage's handleInvalid: "error" raises, "keep" maps to
    len(labels), "skip" marks the row in `drop`."""

    def __init__(self, col: str, labels, invalid: str):
        from .feature import label_map
        self.col = col
        self.labels = list(labels)
        self.invalid = invalid
        self._map = label_map(self.labels)

    def resolve(self, block, drop: np.ndarray) -> np.ndarray:
        from .feature import index_codes
        col = block[self.col]
        c = index_codes(col, self._map)
        missing = np.isnan(c)
        if missing.any():
            if self.invalid == "error":
                bad = col[missing][0]
                raise ValueError(f"Unseen label {bad!r} in column "
                                 f"{self.col!r} (handleInvalid='error')")
            if self.invalid == "skip":
                drop |= missing
            else:  # keep
                c[missing] = float(len(self.labels))
        return c


class _OneHotSource(_Source):
    """OneHotEncoderModel over an indexed (or raw numeric-code) column."""

    def __init__(self, inner, width: int):
        self.inner = inner  # _IndexSource or _NumericSource
        self.width = int(width)

    def codes(self, block, drop: np.ndarray) -> np.ndarray:
        if isinstance(self.inner, _IndexSource):
            return self.inner.resolve(block, drop)
        return self.inner.values(block)

    def write(self, idx: np.ndarray, out: np.ndarray, lo: int) -> None:
        """The one-hot rows of codes `idx` into out[:, lo:lo + width], as
        the OneHotEncoderModel writes them (`feature.write_onehot`)."""
        from .feature import write_onehot
        write_onehot(idx, out[:, lo:lo + self.width])


class CompiledFeaturizer:
    """The fused form of a feature-stage chain; see the module
    docstring."""

    def __init__(self, sources: List[_Source], handle_invalid: str,
                 in_cols: List[str]):
        self.sources = sources
        self.handle_invalid = handle_invalid
        self.in_cols = list(in_cols)
        self.width = sum(s.width for s in sources)
        # (name, source) of every prep-stage output column in stage
        # order: the fused transform rebuilds these interim columns
        self.named_producers: List[tuple] = []

    @classmethod
    def from_stages(cls, stages, assembler) -> Optional["CompiledFeaturizer"]:
        """The featurizer of fitted prep `stages` feeding `assembler`, or
        None when a stage or option is outside the supported chain."""
        from .feature import (ImputerModel, OneHotEncoder,
                              OneHotEncoderModel, StringIndexer,
                              StringIndexerModel, VectorAssembler)
        if not isinstance(assembler, VectorAssembler):
            return None
        invalid = assembler.getOrDefault("handleInvalid")
        if invalid not in ("error", "keep"):
            return None  # the assembler's "skip" drops by finiteness
        producers: Dict[str, _Source] = {}
        for st in stages:
            if st is assembler:
                continue
            if isinstance(st, ImputerModel):
                ins = list(st.getOrDefault("inputCols") or [])
                outs = list(st.getOrDefault("outputCols") or ins)
                if any(c in producers for c in ins):
                    return None  # imputing a produced column
                for c, oc in zip(ins, outs):
                    producers[oc] = _NumericSource(c, float(st.surrogates[c]))
            elif isinstance(st, StringIndexerModel):
                ins, outs = StringIndexer._in_out(st)
                mode = st.getOrDefault("handleInvalid")
                if any(c in producers for c in ins):
                    return None  # indexing a produced column
                for c, oc, labels in zip(ins, outs, st.labelsArray):
                    producers[oc] = _IndexSource(c, labels, mode)
            elif isinstance(st, OneHotEncoderModel):
                ins, outs = OneHotEncoder._in_out(st)
                drop_last = bool(st.getOrDefault("dropLast"))
                for c, oc, size in zip(ins, outs, st.categorySizes):
                    width = size - 1 if drop_last else size
                    inner = producers.get(c) or _NumericSource(c)
                    if isinstance(inner, _OneHotSource):
                        return None  # encoding a vector column
                    producers[oc] = _OneHotSource(inner, width)
            else:
                return None  # an unknown stage keeps the stage path
        in_cols = list(assembler.getOrDefault("inputCols"))
        sources = [producers.get(c) or _NumericSource(c) for c in in_cols]
        out = cls(sources, invalid, in_cols)
        out.named_producers = list(producers.items())
        return out

    # ------------------------------------------------ route decisions
    def raw_columns(self) -> List[str]:
        """Every raw column the pass reads."""
        cols = []
        for _, src in self.named_producers:
            inner = src.inner if isinstance(src, _OneHotSource) else src
            cols.append(inner.col)
        for c, s in zip(self.in_cols, self.sources):
            if type(s) is _NumericSource and s.fill is None:
                cols.append(c)
        return list(dict.fromkeys(cols))

    def inputs_ok(self, block, input_attrs: Optional[dict] = None) -> bool:
        """Whether the pass applies to a frame whose rows look like
        `block` (its first row is enough) and whose columns carry
        `input_attrs`: every raw column it reads is present as one value
        a row, and no raw assembler input is a vector column."""
        attrs = input_attrs or {}
        if not all(_plain_column(block, c) for c in self.raw_columns()):
            return False
        produced = {name for name, _ in self.named_producers}
        return not any("numFeatures" in (attrs.get(c) or {})
                       for c in self.in_cols if c not in produced)

    def columns_recoverable(self) -> bool:
        """Whether `transform_with_columns` can give every interim column
        from its one pass: all but an encoder output the assembler does
        not read, or an indexer output nothing assembled reads."""
        slot = self._slot_map()
        reached = {id(s.inner) for s in self.sources
                   if isinstance(s, _OneHotSource)}
        for _, src in self.named_producers:
            if isinstance(src, _NumericSource) or id(src) in slot:
                continue
            if isinstance(src, _IndexSource) and id(src) in reached:
                continue
            return False
        return True

    # ------------------------------------------------------ the pass
    def transform_with_mask(self, block, dtype=np.float32, sink=None):
        """(X, keep): the assembled block in `dtype` and the row-keep
        mask (None when no StringIndexer "skip" dropped a row); callers
        that pair X with labels from the raw block apply the same mask.
        `sink` captures each index source's resolved codes by id(source)
        for the fused transform."""
        n = block_len(block)
        out = np.empty((n, self.width), dtype=dtype)
        drop = np.zeros(n, dtype=bool)
        lo = 0
        for s in self.sources:
            if isinstance(s, _OneHotSource):
                c, index = s.codes(block, drop), s.inner
                s.write(c, out, lo)
            elif isinstance(s, _IndexSource):
                c, index = s.resolve(block, drop), s
                out[:, lo] = c
            else:
                c, index = s.values(block), None
                out[:, lo] = c
            if sink is not None and isinstance(index, _IndexSource):
                sink[id(index)] = c
            lo += s.width
        keep = None
        if drop.any():  # StringIndexer handleInvalid="skip" row drops
            keep = ~drop
            out = out[keep]
        if self.handle_invalid == "error" and not np.isfinite(out).all():
            raise ValueError(
                f"VectorAssembler found NaN/null in {self.in_cols}; set "
                f"handleInvalid='skip' or impute first")
        return out, keep

    def __call__(self, block) -> np.ndarray:
        return self.transform_with_mask(block)[0]

    def compact_parts(self, block) -> Optional[CompactParts]:
        """The block in compact form (CompactParts) when every source is
        numeric or a one-hot; None for any other source, or when a value
        the expanded block would carry as NaN appears (the materialized
        path's NaN semantics, raising or poisoning the fit, stay
        there)."""
        n = block_len(block)
        drop = np.zeros(n, dtype=bool)
        layout: List[tuple] = []
        num_srcs: List[_NumericSource] = []
        code_cols: List[np.ndarray] = []
        for s in self.sources:
            if type(s) is _NumericSource:
                layout.append(("num", len(num_srcs)))
                num_srcs.append(s)
            elif isinstance(s, _OneHotSource):
                c = s.codes(block, drop)
                # rows the indexer marked for dropping may carry NaN codes
                # (they never reach the expanded block); any other NaN is
                # a NaN one-hot row
                c = np.where(drop, 0.0, c)
                if not np.isfinite(c).all():
                    return None
                layout.append(("oh", len(code_cols), s.width))
                code_cols.append(c.astype(np.int32))
            else:
                return None
        if num_srcs:
            fills = np.asarray([np.nan if s.fill is None else s.fill
                                for s in num_srcs])
            num = extract_numeric_block(
                block, [s.col for s in num_srcs], fills).astype(np.float32)
            if not np.isfinite(num[~drop]).all():
                return None
        else:
            num = np.zeros((n, 0), dtype=np.float32)
        codes = (np.stack(code_cols, axis=1) if code_cols
                 else np.zeros((n, 0), dtype=np.int32))
        keep = None
        if drop.any():
            keep = ~drop
            num, codes = num[keep], codes[keep]
        return CompactParts(np.ascontiguousarray(num),
                            np.ascontiguousarray(codes),
                            tuple(layout), self.width, keep)

    def _slot_map(self) -> dict:
        """id(source) -> (lo, width) of the assembler's inputs."""
        m, lo = {}, 0
        for s in self.sources:
            m[id(s)] = (lo, s.width)
            lo += s.width
        return m

    def feature_attrs(self, input_attrs: Optional[dict] = None) -> dict:
        """The `_ml_attrs` entry VectorAssembler publishes for its output
        column: the categorical slots (slot -> cardinality, read by the
        tree learners) and the width, from the input frame's attrs and
        the interim columns'."""
        merged = dict(input_attrs or {})
        merged.update(self.interim_attrs())
        slots, lo = {}, 0
        for c, s in zip(self.in_cols, self.sources):
            a = merged.get(c)
            if a is not None and "categorical" in a:
                slots[lo] = int(a["categorical"])
            lo += s.width
        return {"slots": slots, "numFeatures": self.width}

    def interim_attrs(self) -> dict:
        """The `_ml_attrs` of each interim column, as the stage
        transforms publish them (indexer "categorical", encoder
        "numFeatures")."""
        attrs = {}
        for name, src in self.named_producers:
            if isinstance(src, _IndexSource):
                extra = 1 if src.invalid == "keep" else 0
                attrs[name] = {"categorical": len(src.labels) + extra}
            elif isinstance(src, _OneHotSource):
                attrs[name] = {"numFeatures": src.width}
        return attrs

    def transform_with_columns(self, block):
        """The fused transform's one pass: (X, keep, cols), X the float64
        assembled block and `cols` each interim column by name as the
        stage transforms give it (an encoder output a 2-D float64 block).
        Assembled encoder outputs read back their X slice, indexer codes
        come from the pass's sink, imputer outputs are recomputed. Only
        for a featurizer whose `columns_recoverable()`."""
        sink: dict = {}
        X, keep = self.transform_with_mask(block, np.float64, sink)
        slot = self._slot_map()
        cols = {}
        for name, src in self.named_producers:
            if isinstance(src, _NumericSource):
                v = to_numeric(block[src.col])
                if v.dtype.kind == "f":  # an integer column holds no NULL
                    v = np.where(np.isfinite(v), v, src.fill)
            elif isinstance(src, _OneHotSource):
                lo, w = slot[id(src)]
                cols[name] = X[:, lo:lo + w].copy()
                continue
            else:
                v = sink[id(src)]
            cols[name] = v[keep] if keep is not None else v
        return X, keep, cols


def produced_columns(prep_stages) -> set:
    """The columns a prep chain writes. A stage whose output params are
    unset writes in place (Imputer's outputCols default to its
    inputCols), so its inputs count as written."""
    def cols(st, names) -> set:
        out = set()
        for a in names:
            v = st.getOrDefault(a) if st.hasParam(a) else None
            if isinstance(v, str):
                out.add(v)
            elif v:
                out.update(v)
        return out

    produced = set()
    for st in prep_stages:
        produced |= cols(st, ("outputCols", "outputCol")) \
            or cols(st, ("inputCols", "inputCol"))
    return produced


def prep_overwrites_label(prep_stages, est) -> bool:
    """Whether a prep stage writes the estimator's labelCol or weightCol:
    the fused routes read labels from the raw block, so such a chain
    keeps the stage path."""
    label_like = {est.getOrDefault("labelCol")}
    if est.hasParam("weightCol"):
        w = est.getOrDefault("weightCol")
        if w:
            label_like.add(w)
    return bool(produced_columns(prep_stages) & label_like)


def _reads_features_and_label(est) -> bool:
    return est.hasParam("featuresCol") and est.hasParam("labelCol")


def fast_fit_applies(stages, raw, input_attrs: Optional[dict] = None
                     ) -> bool:
    """Whether `try_fast_fit` takes a pipeline of `stages` on the raw
    block `raw`, decided from the stages and the block's columns before
    any fit: [Imputer | StringIndexer | OneHotEncoder over an indexer
    output]*, VectorAssembler ("error" or "keep"), then an estimator
    reading the assembler's output and a raw label no prep stage
    writes."""
    from .base import Estimator
    from .feature import (Imputer, OneHotEncoder, StringIndexer,
                          VectorAssembler)
    if not routes_on() or len(stages) < 2:
        return False
    *prep, est = stages
    if not isinstance(est, Estimator) or not _reads_features_and_label(est):
        return False
    if not prep or not isinstance(prep[-1], VectorAssembler):
        return False
    assembler = prep[-1]
    if assembler.getOrDefault("handleInvalid") not in ("error", "keep"):
        return False
    if est.getOrDefault("featuresCol") != assembler.getOrDefault("outputCol"):
        return False
    if est.getOrDefault("labelCol") not in raw:
        return False
    if prep_overwrites_label(prep[:-1], est):
        return False
    kinds: Dict[str, str] = {}
    for st in prep[:-1]:
        if isinstance(st, Imputer):
            ins = list(st.getOrDefault("inputCols") or [])
            outs = list(st.getOrDefault("outputCols") or ins)
            kind = "num"
        elif isinstance(st, StringIndexer):
            ins, outs = st._in_out()
            kind = "idx"
        elif isinstance(st, OneHotEncoder):
            ins, outs = st._in_out()
            if any(kinds.get(c) != "idx" for c in ins):
                return False  # an encoder over a column no indexer wrote
            kinds.update(dict.fromkeys(outs, "ohe"))
            continue
        else:
            return False
        if any(c in kinds or not _plain_column(raw, c) for c in ins):
            return False  # a produced, missing or vector input
        kinds.update(dict.fromkeys(outs, kind))
    attrs = input_attrs or {}
    return all(c in kinds or (_plain_column(raw, c)
                              and "numFeatures" not in (attrs.get(c) or {}))
               for c in assembler.getOrDefault("inputCols"))


def _compact_estimator(est) -> bool:
    from .classification import LogisticRegression
    from .regression import LinearRegression
    return isinstance(est, (LinearRegression, LogisticRegression))


def try_fast_fit(stages, raw, make_frame, input_attrs: Optional[dict] = None):
    """The whole-pipeline fused fit, when `fast_fit_applies`: every prep
    stage fits from the raw block, each OneHotEncoder takes its
    indexer's label count as its size, and the estimator gets a frame of
    the raw rows carrying the one-pass block (`_featurized`) or, for a
    linear or logistic fit whose (n, d) f32 block would reach
    `sml.linear.compactBytes`, its compact form (`_featurized_compact`),
    with the `_ml_attrs` the stage path publishes. Returns
    (fitted prep stages, the estimator's frame) or None; the caller fits
    the estimator, so its errors propagate.

    `make_frame()` gives a one-partition frame of `raw` carrying the
    input frame's `_ml_attrs`."""
    from ..conf import GLOBAL_CONF
    from .feature import (Imputer, OneHotEncoderModel, StringIndexer)
    if not fast_fit_applies(stages, raw, input_attrs):
        return None
    *prep, est = stages
    assembler = prep[-1]
    raw_frame = make_frame()
    fitted = []
    idx_labels: Dict[str, list] = {}
    for st in prep[:-1]:
        if isinstance(st, Imputer):
            fitted.append(st.fit(raw_frame))
        elif isinstance(st, StringIndexer):
            m = st.fit(raw_frame)
            for oc, ls in zip(st._in_out()[1], m.labelsArray):
                idx_labels[oc] = ls
            fitted.append(m)
        else:  # OneHotEncoder over indexer outputs
            ins, _ = st._in_out()
            m = OneHotEncoderModel(categorySizes=[len(idx_labels[c])
                                                  for c in ins])
            m._inherit_params(st)
            fitted.append(m)
    fitted.append(assembler)
    feat = CompiledFeaturizer.from_stages(fitted[:-1], assembler)
    out_col = assembler.getOrDefault("outputCol")
    shim = make_frame()
    shim._ml_attrs.update(feat.interim_attrs())
    shim._ml_attrs[out_col] = feat.feature_attrs(input_attrs)
    n = block_len(raw)
    if _compact_estimator(est) and n * feat.width * 4 \
            >= GLOBAL_CONF.getInt("sml.linear.compactBytes"):
        parts = feat.compact_parts(raw)
        if parts is not None:
            shim._featurized_compact = {out_col: (parts, raw)}
            return fitted, shim
    X, keep = feat.transform_with_mask(raw)
    shim._featurized = {out_col: (X, keep, raw)}
    return fitted, shim


def attach_fused_features(cur, fitted_transforms, est, raw,
                          input_attrs: Optional[dict] = None):
    """The stage path's fused block: when the fitted prep chain compiles
    and the last estimator reads the assembler's output and a raw label,
    the block is assembled in one pass over the raw rows and attached to
    `cur` (`_featurized`), so the estimator never materializes the
    transform chain. Decided from the fitted stages and the raw block
    before the estimator's fit; `cur` comes back unchanged otherwise."""
    from .feature import VectorAssembler
    if not routes_on() or not fitted_transforms:
        return cur
    assembler = fitted_transforms[-1]
    if not isinstance(assembler, VectorAssembler) or \
            not _reads_features_and_label(est):
        return cur
    out_col = assembler.getOrDefault("outputCol")
    if est.getOrDefault("featuresCol") != out_col or \
            est.getOrDefault("labelCol") not in raw or \
            prep_overwrites_label(fitted_transforms[:-1], est):
        return cur
    feat = CompiledFeaturizer.from_stages(fitted_transforms[:-1], assembler)
    if feat is None or not feat.inputs_ok(raw, input_attrs):
        return cur
    X, keep = feat.transform_with_mask(raw)
    cur._featurized = {out_col: (X, keep, raw)}
    return cur
