"""Feature transformers over numpy blocks.

The port's copy of `sml_tpu/ml/feature.py`: `VectorAssembler` (with the
per-slot metadata tree learners read), `StringIndexer`/
`StringIndexerModel`, `IndexToString`, `OneHotEncoder`, `Imputer`,
`StandardScaler`, `Bucketizer` and `RFormula`. Each computes what the
JAX package's pandas stage computes on the same rows: Imputer's median
is the exact median, its mean pandas' skipna mean (the same sums in the
same order), StringIndexer orders labels by descending frequency with
ties by label.

A vector output column is one (n, d) float64 block; a one-hot row of a
NULL index is a row of NaN.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from ..frame.column import block_len, object_array, to_numeric
from ..frame.functions import nanmean
from ..native.hashing import null_mask
from .base import (Estimator, Model, Transformer, _load_stages, _save_stages,
                   load_arrays, save_arrays)
from .linalg import Vector, to_matrix


def _numeric_present(values: np.ndarray) -> np.ndarray:
    """`pd.to_numeric(values, errors="coerce").dropna()`."""
    v = to_numeric(values)
    return v[~np.isnan(v)] if v.dtype.kind == "f" else v


# --------------------------------------------------------------------------
class VectorAssembler(Transformer):
    """Concatenate numeric / vector columns into one feature vector
    column."""

    def _init_params(self):
        self._declareParam("inputCols", doc="input column names")
        self._declareParam("outputCol", default="features",
                           doc="output column")
        self._declareParam("handleInvalid", default="error",
                           doc="error|skip|keep")

    def __init__(self, inputCols: Optional[List[str]] = None,
                 outputCol: Optional[str] = None,
                 handleInvalid: Optional[str] = None):
        super().__init__()
        self._set(inputCols=inputCols, outputCol=outputCol,
                  handleInvalid=handleInvalid)

    def getInputCols(self):
        return self.getOrDefault("inputCols")

    def getOutputCol(self):
        return self.getOrDefault("outputCol")

    def setInputCols(self, v):
        return self._set(inputCols=v)

    def setOutputCol(self, v):
        return self._set(outputCol=v)

    def _transform(self, df):
        in_cols = list(self.getOrDefault("inputCols"))
        out_col = self.getOrDefault("outputCol")
        invalid = self.getOrDefault("handleInvalid")

        def fn(block, ctx):
            out = dict(block)
            if block_len(block) == 0:
                out[out_col] = np.zeros((0, 0))
                return out
            blocks = []
            for c in in_cols:
                col = block[c]
                if col.ndim == 2:
                    blocks.append(col)
                elif col.dtype.kind == "O" and isinstance(col[0], Vector):
                    blocks.append(to_matrix(col))
                else:
                    blocks.append(to_numeric(col).astype(np.float64)[:, None])
            # the single-input case must not alias the input block
            mat = np.concatenate(blocks, axis=1) if len(blocks) > 1 \
                else blocks[0].copy()
            bad = ~np.isfinite(mat).all(axis=1)
            if bad.any():
                if invalid == "error":
                    raise ValueError(
                        f"VectorAssembler found NaN/null in {in_cols}; set "
                        f"handleInvalid='skip' or impute first")
                if invalid == "skip":
                    out = {k: v[~bad] for k, v in out.items()}
                    mat = mat[~bad]
            out[out_col] = mat
            return out

        res = df._derive(fn, op="VectorAssembler")
        # per-slot feature metadata: which assembled slots are
        # categorical (slot -> cardinality), read by tree learners
        slots: Dict[int, int] = {}
        pos = 0
        head = None
        for c in in_cols:
            width = 1
            attrs = df._ml_attrs.get(c)
            if attrs is not None and "categorical" in attrs:
                slots[pos] = int(attrs["categorical"])
            elif attrs is not None and "numFeatures" in attrs:
                width = int(attrs["numFeatures"])
            else:
                # a vector input column has its own width: peek one row
                if head is None:
                    head = df.limit(1)._whole()
                v = head.get(c)
                if v is not None and len(v):
                    if v.ndim == 2:
                        width = v.shape[1]
                    elif isinstance(v[0], Vector):
                        width = v[0].size
            pos += width
        res._ml_attrs[out_col] = {"slots": slots, "numFeatures": pos}
        return res


# --------------------------------------------------------------------------
class StringIndexer(Estimator):
    """Map string categories to double indices ordered by descending
    frequency (ties by label), MLlib's default `frequencyDesc`."""

    def _init_params(self):
        self._declareParam("inputCol", doc="input column")
        self._declareParam("outputCol", doc="output column")
        self._declareParam("inputCols", doc="input columns (multi)")
        self._declareParam("outputCols", doc="output columns (multi)")
        self._declareParam("handleInvalid", default="error",
                           doc="error|skip|keep")
        self._declareParam("stringOrderType", default="frequencyDesc",
                           doc="frequencyDesc|frequencyAsc|alphabetDesc|"
                               "alphabetAsc")

    def __init__(self, inputCol=None, outputCol=None, inputCols=None,
                 outputCols=None, handleInvalid=None, stringOrderType=None):
        super().__init__()
        self._set(inputCol=inputCol, outputCol=outputCol,
                  inputCols=inputCols, outputCols=outputCols,
                  handleInvalid=handleInvalid,
                  stringOrderType=stringOrderType)

    def _in_out(self):
        multi_in = self.getOrDefault("inputCols")
        if multi_in:
            return list(multi_in), list(self.getOrDefault("outputCols"))
        return [self.getOrDefault("inputCol")], \
            [self.getOrDefault("outputCol")]

    def _fit(self, df) -> "StringIndexerModel":
        in_cols, _ = self._in_out()
        order = self.getOrDefault("stringOrderType")
        whole = df._whole()
        labels: List[List[str]] = []
        for c in in_cols:
            col = whole[c]
            uniq, counts = np.unique(col[~null_mask(col)].astype(str),
                                     return_counts=True)
            uniq = uniq.tolist()
            if order.startswith("frequency"):
                # count desc, then label asc (MLlib's tie-break)
                lab = [k for k, _ in sorted(zip(uniq, counts.tolist()),
                                            key=lambda kv: (-kv[1], kv[0]))]
                if order == "frequencyAsc":
                    lab = lab[::-1]
            else:
                lab = sorted(uniq)
                if order == "alphabetDesc":
                    lab = lab[::-1]
            labels.append(lab)
        m = StringIndexerModel(labels=labels)
        m._inherit_params(self)
        return m


def label_map(labels) -> Dict[str, float]:
    """A fitted indexer's labels as label -> index."""
    return {lab: float(i) for i, lab in enumerate(labels)}


def index_codes(col: np.ndarray, mapping: Dict[str, float]) -> np.ndarray:
    """The float index of each value of `col` under `mapping` (its text,
    as `astype(str)` gives it), NaN for a NULL or an unseen label: the
    lookup before handleInvalid, shared by the stage and the compiled
    featurizer (`featurizer._IndexSource`) so that both give the same
    codes."""
    nulls = null_mask(col)
    # one lookup per distinct value
    uniq, inv = np.unique(col.astype(str), return_inverse=True)
    idx = np.array([mapping.get(u, np.nan) for u in uniq],
                   dtype=np.float64)[inv.reshape(-1)]
    idx[nulls] = np.nan
    return idx


class StringIndexerModel(Model):
    def _init_params(self):
        StringIndexer._init_params(self)

    def __init__(self, labels: Optional[List[List[str]]] = None):
        super().__init__()
        self.labelsArray: List[List[str]] = labels or []

    @property
    def labels(self) -> List[str]:
        return self.labelsArray[0] if self.labelsArray else []

    def _transform(self, df):
        in_cols, out_cols = StringIndexer._in_out(self)
        invalid = self.getOrDefault("handleInvalid")
        maps = [label_map(ls) for ls in self.labelsArray]

        def fn(block, ctx):
            out = dict(block)
            keep = np.ones(block_len(block), dtype=bool)
            for c, oc, mapping in zip(in_cols, out_cols, maps):
                col = block[c]
                idx = index_codes(col, mapping)
                missing = np.isnan(idx)
                if missing.any():
                    if invalid == "error":
                        bad = col[missing][0]
                        raise ValueError(f"Unseen label {bad!r} in column "
                                         f"{c!r} (handleInvalid='error')")
                    if invalid == "skip":
                        keep &= ~missing
                    else:  # keep: one more index, numLabels
                        idx[missing] = float(len(mapping))
                out[oc] = idx
            if not keep.all():
                out = {k: v[keep] for k, v in out.items()}
            return out

        res = df._derive(fn, op="StringIndexer")
        # an indexed column is categorical with known cardinality: tree
        # learners read it for maxBins semantics
        extra = 1 if invalid == "keep" else 0
        for oc, ls in zip(out_cols, self.labelsArray):
            res._ml_attrs[oc] = {"categorical": len(ls) + extra}
        return res

    def _extra_metadata(self):
        return {"labelsArray": self.labelsArray}

    def _load_state(self, path, meta):
        self.labelsArray = [list(x) for x in meta.get("labelsArray", [])]


class IndexToString(Transformer):
    def _init_params(self):
        self._declareParam("inputCol", doc="index column")
        self._declareParam("outputCol", doc="label column")
        self._declareParam("labels", doc="labels list")

    def __init__(self, inputCol=None, outputCol=None, labels=None):
        super().__init__()
        self._set(inputCol=inputCol, outputCol=outputCol, labels=labels)

    def _transform(self, df):
        labels = list(self.getOrDefault("labels"))
        ic, oc = self.getOrDefault("inputCol"), self.getOrDefault("outputCol")

        def fn(block, ctx):
            out = dict(block)
            idx = to_numeric(block[ic]).astype(np.float64)
            out[oc] = object_array(
                labels[int(i)] if i == i and int(i) < len(labels) else None
                for i in idx.tolist())
            return out

        return df._derive(fn, op="IndexToString")


# --------------------------------------------------------------------------
class OneHotEncoder(Estimator):
    """Index column(s) to one-hot vectors, `dropLast=True` like MLlib."""

    def _init_params(self):
        self._declareParam("inputCols", doc="input index columns")
        self._declareParam("outputCols", doc="output vector columns")
        self._declareParam("inputCol", doc="input index column")
        self._declareParam("outputCol", doc="output vector column")
        self._declareParam("dropLast", default=True, doc="drop last category")
        self._declareParam("handleInvalid", default="error", doc="error|keep")

    def __init__(self, inputCols=None, outputCols=None, inputCol=None,
                 outputCol=None, dropLast: Optional[bool] = None,
                 handleInvalid=None):
        super().__init__()
        self._set(inputCols=inputCols, outputCols=outputCols,
                  inputCol=inputCol, outputCol=outputCol,
                  handleInvalid=handleInvalid)
        if dropLast is not None:
            self._set(dropLast=dropLast)

    def _in_out(self):
        multi = self.getOrDefault("inputCols")
        if multi:
            return list(multi), list(self.getOrDefault("outputCols"))
        return [self.getOrDefault("inputCol")], \
            [self.getOrDefault("outputCol")]

    def _fit(self, df) -> "OneHotEncoderModel":
        in_cols, _ = self._in_out()
        whole = df._whole()
        sizes = [int(np.nanmax(to_numeric(whole[c]).astype(np.float64))) + 1
                 if block_len(whole) else 0 for c in in_cols]
        m = OneHotEncoderModel(categorySizes=sizes)
        m._inherit_params(self)
        return m


def write_onehot(idx: np.ndarray, out: np.ndarray) -> None:
    """The one-hot rows of float codes `idx` into `out` (n, width): a
    code out of range, as a dropped last category, is a zero row and a
    NaN code a NaN row. Shared by the stage and the compiled featurizer
    (`featurizer._OneHotSource`)."""
    width = out.shape[1]
    na = ~np.isfinite(idx)
    ok = ~na & (idx >= 0) & (idx < width)
    out[:] = 0.0
    out[np.nonzero(ok)[0], idx[ok].astype(np.intp)] = 1.0
    if na.any():
        out[na] = np.nan


class OneHotEncoderModel(Model):
    def _init_params(self):
        OneHotEncoder._init_params(self)

    def __init__(self, categorySizes: Optional[List[int]] = None):
        super().__init__()
        self.categorySizes: List[int] = categorySizes or []

    def _transform(self, df):
        in_cols, out_cols = OneHotEncoder._in_out(self)
        drop_last = bool(self.getOrDefault("dropLast"))
        sizes = self.categorySizes

        def fn(block, ctx):
            out = dict(block)
            for c, oc, size in zip(in_cols, out_cols, sizes):
                width = size - 1 if drop_last else size
                idx = to_numeric(block[c]).astype(np.float64)
                onehot = np.empty((len(idx), width))
                write_onehot(idx, onehot)
                out[oc] = onehot
            return out

        res = df._derive(fn, op="OneHotEncoder")
        # output widths as column metadata, so VectorAssembler needs no
        # data peek for one-hot inputs
        for oc, size in zip(out_cols, sizes):
            res._ml_attrs[oc] = {
                "numFeatures": size - 1 if drop_last else size}
        return res

    def _extra_metadata(self):
        return {"categorySizes": self.categorySizes}

    def _load_state(self, path, meta):
        self.categorySizes = list(meta.get("categorySizes", []))


# --------------------------------------------------------------------------
class Imputer(Estimator):
    """Fill numeric nulls with each column's median, mean or mode."""

    def _init_params(self):
        self._declareParam("inputCols", doc="columns to impute")
        self._declareParam("outputCols", doc="imputed output columns")
        self._declareParam("strategy", default="mean", doc="mean|median|mode")
        self._declareParam("missingValue", default=float("nan"),
                           doc="value treated as missing")

    def __init__(self, strategy: Optional[str] = None, inputCols=None,
                 outputCols=None, missingValue: Optional[float] = None):
        super().__init__()
        self._set(strategy=strategy, inputCols=inputCols,
                  outputCols=outputCols, missingValue=missingValue)

    def setStrategy(self, v):
        return self._set(strategy=v)

    def _fit(self, df) -> "ImputerModel":
        in_cols = list(self.getOrDefault("inputCols"))
        strategy = self.getOrDefault("strategy")
        whole = df._whole()
        surrogates = {}
        for c in in_cols:
            s = _numeric_present(whole[c])
            if not len(s):
                surrogates[c] = 0.0
            elif strategy == "median":
                surrogates[c] = float(np.median(s))
            elif strategy == "mode":
                uniq, counts = np.unique(s, return_counts=True)
                surrogates[c] = float(uniq[np.argmax(counts)])
            else:
                surrogates[c] = nanmean(s)
        m = ImputerModel(surrogates=surrogates)
        m._inherit_params(self)
        return m


class ImputerModel(Model):
    def _init_params(self):
        Imputer._init_params(self)

    def __init__(self, surrogates: Optional[Dict[str, float]] = None):
        super().__init__()
        self.surrogates = surrogates or {}

    @property
    def surrogateDF(self):
        from ..frame.session import get_session
        return get_session().createDataFrame(
            {c: np.array([v]) for c, v in self.surrogates.items()})

    def _transform(self, df):
        in_cols = list(self.getOrDefault("inputCols"))
        out_cols = list(self.getOrDefault("outputCols") or in_cols)
        surro = self.surrogates

        def fn(block, ctx):
            out = dict(block)
            for c, oc in zip(in_cols, out_cols):
                s = to_numeric(block[c])
                if s.dtype.kind == "f":
                    s = s.copy()
                    s[np.isnan(s)] = surro[c]
                out[oc] = s
            return out

        return df._derive(fn, op="Imputer")

    def _extra_metadata(self):
        return {"surrogates": self.surrogates}

    def _load_state(self, path, meta):
        self.surrogates = dict(meta.get("surrogates", {}))


# --------------------------------------------------------------------------
class StandardScaler(Estimator):
    def _init_params(self):
        self._declareParam("inputCol", doc="vector input")
        self._declareParam("outputCol", doc="scaled output")
        self._declareParam("withMean", default=False, doc="center")
        self._declareParam("withStd", default=True, doc="scale to unit std")

    def __init__(self, inputCol=None, outputCol=None, withMean=None,
                 withStd=None):
        super().__init__()
        self._set(inputCol=inputCol, outputCol=outputCol, withMean=withMean,
                  withStd=withStd)

    def _fit(self, df) -> "StandardScalerModel":
        from ._staging import extract_features
        X = extract_features(df, self.getOrDefault("inputCol"))
        m = StandardScalerModel(mean=X.mean(axis=0), std=X.std(axis=0, ddof=1))
        m._inherit_params(self)
        return m


class StandardScalerModel(Model):
    def _init_params(self):
        StandardScaler._init_params(self)

    def __init__(self, mean=None, std=None):
        super().__init__()
        self.mean = np.asarray(mean) if mean is not None else None
        self.std = np.asarray(std) if std is not None else None

    def _transform(self, df):
        ic = self.getOrDefault("inputCol")
        oc = self.getOrDefault("outputCol")
        with_mean = bool(self.getOrDefault("withMean"))
        with_std = bool(self.getOrDefault("withStd"))
        mean, std = self.mean, np.where(self.std == 0, 1.0, self.std)

        def fn(block, ctx):
            out = dict(block)
            X = to_matrix(block[ic])
            if with_mean:
                X = X - mean
            if with_std:
                X = X / std
            elif not with_mean:
                X = X.copy()
            out[oc] = X
            return out

        return df._derive(fn, op="StandardScaler")

    def _save_state(self, path):
        save_arrays(path, mean=self.mean, std=self.std)

    def _load_state(self, path, meta):
        d = load_arrays(path)
        self.mean, self.std = d.get("mean"), d.get("std")


# --------------------------------------------------------------------------
class Bucketizer(Transformer):
    def _init_params(self):
        self._declareParam("splits", doc="bucket boundaries")
        self._declareParam("inputCol", doc="input column")
        self._declareParam("outputCol", doc="output column")
        self._declareParam("handleInvalid", default="error",
                           doc="error|skip|keep")

    def __init__(self, splits=None, inputCol=None, outputCol=None,
                 handleInvalid=None):
        super().__init__()
        self._set(splits=splits, inputCol=inputCol, outputCol=outputCol,
                  handleInvalid=handleInvalid)

    def _transform(self, df):
        splits = np.asarray(self.getOrDefault("splits"), dtype=float)
        ic, oc = self.getOrDefault("inputCol"), self.getOrDefault("outputCol")

        def fn(block, ctx):
            out = dict(block)
            x = to_numeric(block[ic]).astype(np.float64)
            idx = np.digitize(x, splits[1:-1], right=False).astype(float)
            idx[~np.isfinite(x)] = np.nan
            out[oc] = idx
            return out

        return df._derive(fn, op="Bucketizer")


# --------------------------------------------------------------------------
class RFormula(Estimator):
    """R-style modeling formula: `label ~ .` / `label ~ a + b - c`.
    Strings are indexed and one-hot encoded; numerics pass through; the
    output is featuresCol + labelCol."""

    def _init_params(self):
        self._declareParam("formula", doc="R formula")
        self._declareParam("featuresCol", default="features",
                           doc="features output")
        self._declareParam("labelCol", default="label", doc="label output")
        self._declareParam("handleInvalid", default="error",
                           doc="error|skip|keep")

    def __init__(self, formula: Optional[str] = None, featuresCol=None,
                 labelCol=None, handleInvalid=None):
        super().__init__()
        self._set(formula=formula, featuresCol=featuresCol,
                  labelCol=labelCol, handleInvalid=handleInvalid)

    def _fit(self, df) -> "RFormulaModel":
        formula = self.getOrDefault("formula")
        m = re.match(r"\s*(.+?)\s*~\s*(.+)\s*", formula)
        if not m:
            raise ValueError(f"cannot parse formula {formula!r}")
        label, rhs = m.group(1), m.group(2)
        sch = {f.name: f.dataType.simpleString() for f in df.schema.fields}
        # strict `term (+ term | - term)*` parse, `-` excluding a term;
        # unknown terms or malformed sequences raise
        tokens = re.findall(r"[+-]|[^\s+-]+", rhs)
        if not tokens or tokens[0] in "+-" or tokens[-1] in "+-":
            raise ValueError(f"cannot parse formula {formula!r}")
        included, excluded = [], []
        op = "+"
        for tok in tokens:
            if tok in "+-":
                if op is not None:
                    raise ValueError(f"cannot parse formula {formula!r}")
                op = tok
                continue
            if op is None:
                raise ValueError(f"cannot parse formula {formula!r}")
            if tok != "." and tok != label and tok not in sch:
                raise ValueError(
                    f"formula {formula!r} references unknown column {tok!r}")
            (included if op == "+" else excluded).append(tok)
            op = None
        terms: List[str] = []
        for t in included:
            terms += [c for c in df.columns if c != label] if t == "." \
                else [t]
        seen: set = set()
        terms = [t for t in terms
                 if t not in set(excluded) and not
                 (t in seen or seen.add(t))]
        str_terms = [t for t in terms if sch.get(t) == "string"]
        num_terms = [t for t in terms if t not in str_terms]

        stages: List[Transformer] = []
        assembled: List[str] = []
        if str_terms:
            idx_cols = [f"{c}__idx" for c in str_terms]
            ohe_cols = [f"{c}__ohe" for c in str_terms]
            si_model = StringIndexer(
                inputCols=str_terms, outputCols=idx_cols,
                handleInvalid=self.getOrDefault("handleInvalid")).fit(df)
            ohe_model = OneHotEncoder(inputCols=idx_cols,
                                      outputCols=ohe_cols).fit(
                si_model.transform(df))
            stages += [si_model, ohe_model]
            assembled += ohe_cols
        assembled += num_terms
        stages.append(VectorAssembler(
            inputCols=assembled, outputCol=self.getOrDefault("featuresCol"),
            handleInvalid=self.getOrDefault("handleInvalid")))
        model = RFormulaModel(stages=stages, label=label,
                              labelCol=self.getOrDefault("labelCol"))
        model._inherit_params(self)
        return model


class RFormulaModel(Model):
    def _init_params(self):
        RFormula._init_params(self)

    def __init__(self, stages: Optional[List[Transformer]] = None,
                 label: Optional[str] = None, labelCol: str = "label"):
        super().__init__()
        self.stages = stages or []
        self.label_source = label
        self._label_col = labelCol

    def _transform(self, df):
        cur = df
        for s in self.stages:
            cur = s.transform(cur)
        src, dst = self.label_source, self._label_col

        def fn(block, ctx):
            out = dict(block)
            if src in out and dst != src:
                out[dst] = to_numeric(out[src])
            return out

        return cur._derive(fn, op="RFormula")

    def _extra_metadata(self):
        return {"label_source": self.label_source,
                "label_col": self._label_col, "n_stages": len(self.stages)}

    def _save_state(self, path):
        _save_stages(self.stages, path)

    def _load_state(self, path, meta):
        self.label_source = meta.get("label_source")
        self._label_col = meta.get("label_col", "label")
        self.stages = _load_stages(path)
