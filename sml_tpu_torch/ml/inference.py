"""Batch and online scoring of tree ensembles and linear models on one
device.

Counterpart of the forest and linear paths of `sml_tpu/ml/inference.py`.
For a forest, rows are binned on the host, the compact bin matrix is
staged once per content (`_staging.stage_bins_cached`), and the stacked
ensemble is traversed by `native.traverse_kernel.forest_traverse`, which
launches the CUDA kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors. A linear or logistic model scores `X @ w + b`
(through the sigmoid for the logistic) in float64 on the device, each
row's products summed in a fixed pairwise order (`_linear_forward`).

Each batch is routed by the dispatcher (`parallel/dispatch.decide`)
with the JAX package's work hints: a forest `4·n·T·depth` of kind
"traverse", a linear model `2·n·d` of kind "blas". On a card every batch
stays on the card ("local-chip"); the host route runs when
`sml.dispatch.mode=host` forces it, or when a caller asks for it
(`score_block_host`: the serving queue's overflow under
`sml.serve.hostFallback`, the canary's mirror). It gives the card's bits: a
forest's binned rows through the C++ host traversal
(`native/host_traverse.py`, the card's kernel's arithmetic), a linear
model's products summed in `_linear_forward`'s order in float64 numpy.
`DeviceScorer` is the load-once, score-many object a server holds. On
a pipeline it keeps the prep stages: `__call__` scores a raw batch (a
port DataFrame or a block, a mapping of column name to numpy array)
through the compiled featurizer's one pass (`featurizer.py`), and for a
linear model over that chain through the factorized scorer (host float64:
a numeric dot plus one weight-table lookup per one-hot column, with no
(n, d) block). `score_batches` (ML 12's batch scoring) runs a stream of
batches through `parallel.pipeline`: the factorized scorer through
`prefetch_map`, the device route through `prefetch_pipeline`, prep
(featurizing, binning) on worker threads while earlier batches run on
the card, each result copied back into pinned memory behind an event.

With the flight recorder on, a change of the traversal's launch plan
lands an `infer.kernel.spec` event; `kernel_report()` (the `infer_kernel`
block of `obs.engine_health()`) gives the last plan.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..native.traverse_kernel import forest_traverse, traverse_plan
from ..parallel import dispatch as _dispatch
from ._staging import stage_bins_cached

#: prediction links of the fused predict+eval program
#: (`sml_tpu/ml/base.RegStatsHook.LINKS`)
LINKS = {"identity": None, "exp": torch.exp, "log": torch.log}


def _tables(sf, sb, lv, weights, device: torch.device):
    """The stacked tables as contiguous device tensors, copied before
    return so any stream may read them."""
    out = (torch.from_numpy(np.ascontiguousarray(sf, np.int32)),
           torch.from_numpy(np.ascontiguousarray(sb, np.int32)),
           torch.from_numpy(np.ascontiguousarray(lv, np.float32)),
           torch.from_numpy(np.ascontiguousarray(weights, np.float32)))
    out = tuple(t.to(device, copy=True) for t in out)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out


def predict_forest_sharded(binned: np.ndarray, sf: np.ndarray,
                           sb: np.ndarray, lv: np.ndarray,
                           weights: np.ndarray, depth: int,
                           base: float = 0.0, *,
                           device=None) -> np.ndarray:
    """Stacked-ensemble margin of a host bin matrix: base + the weighted
    tree sum, as f64 on the host. The bin matrix keeps its compact dtype
    on the device."""
    dev = resolve_device(device)
    Bd = stage_bins_cached(binned, dev)
    out = forest_traverse(Bd, *_tables(sf, sb, lv, weights, dev),
                          depth=depth)
    return base + out.cpu().numpy().astype(np.float64)


def _linear_forward(Xd: torch.Tensor, w: torch.Tensor, b: float
                    ) -> torch.Tensor:
    """X @ w + b of device rows, in float64: each row's products summed
    pairwise in a fixed tree (the columns padded with zeros to a power of
    two, then halves added until one is left) by elementwise ops, then
    b. A row's score so depends on that row alone, not on the rows
    batched with it, and is the same on the card and on the CPU (a
    matrix-vector product picks its summation order by the batch's
    shape)."""
    terms = Xd.to(torch.float64) * w
    d = terms.shape[1]
    width = 1 << max(d - 1, 0).bit_length()
    if width > d:
        terms = torch.nn.functional.pad(terms, (0, width - d))
    while terms.shape[1] > 1:
        half = terms.shape[1] // 2
        terms = terms[:, :half] + terms[:, half:]
    return terms[:, 0] + b


def _linear_forward_host(X32: np.ndarray, w: np.ndarray, b: float
                         ) -> np.ndarray:
    """`_linear_forward` in float64 numpy: the same products summed in
    the same pairwise tree, then b, so the host route gives the card's
    bits (each f64 product and sum is rounded once on either side)."""
    terms = np.asarray(X32, np.float32).astype(np.float64) * w
    d = terms.shape[1]
    width = 1 << max(d - 1, 0).bit_length()
    if width > d:
        terms = np.pad(terms, ((0, 0), (0, width - d)))
    while terms.shape[1] > 1:
        half = terms.shape[1] // 2
        terms = terms[:, :half] + terms[:, half:]
    return terms[:, 0] + b


#: the traversal plan of the last launch on the card, process-wide
_last_plan = [None]
_plan_counts = {"launches": 0, "changes": 0}
_plan_lock = threading.Lock()


def _note_plan(plan: dict) -> None:
    """Keep the last launch plan; a change lands `infer.kernel.spec`."""
    with _plan_lock:
        changed = _last_plan[0] != plan
        _last_plan[0] = plan
        _plan_counts["launches"] += 1
        _plan_counts["changes"] += int(changed)
    if changed:
        from ..obs._recorder import RECORDER
        if RECORDER.enabled:
            RECORDER.emit("infer", "infer.kernel.spec", args=dict(plan))


def kernel_report() -> dict:
    """The `infer_kernel` block of `obs.engine_health()`: the kernel the
    scorers launch, the `traverse_plan` of the last launch on the card
    (None before one), and how many scorer launches resolved a plan and
    how many changed it. The JAX package's ladder, autotuner and their
    fallback counts have no counterpart: the card has one traversal."""
    with _plan_lock:
        plan = None if _last_plan[0] is None else dict(_last_plan[0])
        counts = dict(_plan_counts)
    return {"kernel": "forest_traverse", "plan": plan,
            "plan_launches": counts["launches"],
            "plan_changes": counts["changes"]}


def _logistic_forward(Xd: torch.Tensor, w: torch.Tensor, b: float
                      ) -> torch.Tensor:
    """sigmoid(X @ w + b) of device rows, in float64."""
    return torch.sigmoid(_linear_forward(Xd, w, b))


def predict_linear_sharded(X: np.ndarray, w: np.ndarray, b: float, *,
                           logistic: bool = False,
                           device=None) -> np.ndarray:
    """The linear (or, with `logistic`, the sigmoid) forward of a host
    block on `device` (the card by default), as float64 on the host."""
    from ._staging import stage_rows
    dev = resolve_device(device)
    Xd = stage_rows(np.asarray(X, np.float32), dev)
    wd = torch.from_numpy(np.asarray(w, np.float64)).to(dev)
    fwd = _logistic_forward if logistic else _linear_forward
    return fwd(Xd, wd, float(b)).cpu().numpy()


def forest_eval_fn(depth: int, link: str = "identity") -> Callable:
    """Fused predict+metric: traverse the ensemble and reduce the five
    regression sufficient statistics (n, Σd², Σ|d|, Σl, Σl²) on the
    device, so only five scalars come back.

    The returned fn takes (binned, l, lmask, sf, sb, lv, weights, base):
    device tensors, with `lmask` 1.0 where the label is finite and
    labels zeroed where it is not. `link` ("identity", "exp" or "log")
    applies to the predictions before the metric (the ML 11 shape: fit
    on log(label), evaluate exp(prediction)); a prediction the link
    makes non-finite drops out of every statistic, as on the host
    paths. The sums are plain torch ops outside the kernel: each row's
    f32 statistics, summed in float64 in the evaluators' ordered block
    reduction (`evaluation.block_partials` / `reduce_blocks`). Its
    keyword `blocks=(first, total, mesh)` says that the rows are this
    rank's blocks of a mesh's evaluation (`evaluation.eval_blocks`);
    by default they are every block. A rank with no rows launches no
    traversal."""
    if link not in LINKS:
        raise ValueError(f"unknown link {link!r}; one of {sorted(LINKS)}")
    link_fn = LINKS[link]

    def forest_eval(binned, l, lmask, sf, sb, lv, weights, base, *,
                    blocks=None):
        from .evaluation import (EVAL_BLOCK_ROWS, block_partials,
                                 reduce_blocks)
        m = lmask
        if binned.shape[0]:
            pred = base + forest_traverse(binned, sf, sb, lv, weights,
                                          depth=depth)
        else:
            pred = torch.zeros_like(l)
        if link_fn is not None:
            pred = link_fn(pred)
            ok = torch.isfinite(pred)
            m = m * ok.to(torch.float32)
            pred = torch.where(ok, pred, 0.0)
        d = (pred - l) * m
        cols = torch.stack([m, d * d, torch.abs(d), m * l, m * l * l], dim=1)
        first, total, mesh = blocks if blocks is not None else \
            (0, -(-l.shape[0] // EVAL_BLOCK_ROWS), None)
        return tuple(reduce_blocks(block_partials(cols), first, total,
                                   mesh).unbind(0))

    return forest_eval


class DeviceScorer:
    """Load-once, score-many wrapper of a fitted model: a tree ensemble
    (any object with an `_EnsembleSpec` as `_spec`), a linear or logistic
    regression model (`_coefficients`, `intercept`), or a PipelineModel
    that ends in one, whose `score_block` takes the feature block its last
    stage reads and whose `__call__` takes a raw batch.

    `device` defaults to the CUDA card and raises when there is none;
    pass device="cpu" to score with the plain PyTorch versions."""

    def __init__(self, model, device=None):
        from .featurizer import CompiledFeaturizer, routes_on
        stages = getattr(model, "stages", None)
        self._stages = list(stages[:-1]) if stages else []
        tail = stages[-1] if stages else model
        self._model = tail
        self.device = resolve_device(device)
        self._spec = None
        self._kernel_spec = None
        self._kind, self._params = self._compile_target(tail, self.device)
        if self._kind == "forest":
            self._spec = tail._spec
            # the host route's tables: the same stacked arrays, on the host
            sf, sb, lv, w = self._spec.stacked()
            self._host_params = (np.ascontiguousarray(sf, np.int32),
                                 np.ascontiguousarray(sb, np.int32),
                                 np.ascontiguousarray(lv, np.float32),
                                 np.ascontiguousarray(w, np.float32))
        else:
            w, b, logistic = self._params
            self._host_params = (w.cpu().numpy(), b, logistic)
        # the feature chain as one columnar pass, when it is the
        # supported Imputer / StringIndexer / OHE / VectorAssembler chain
        self._featurizer = None
        if self._stages and routes_on():
            from .feature import VectorAssembler
            last = self._stages[-1]
            if isinstance(last, VectorAssembler) and \
                    last.getOrDefault("outputCol") == self.featuresCol:
                self._featurizer = CompiledFeaturizer.from_stages(
                    self._stages[:-1], last)
        # a linear model over one-hot slots is an embedding sum:
        # w . onehot(i) == w[i], so no (n, d) block is needed
        self._factorized = None
        if self._featurizer is not None and self._kind == "linear":
            self._factorized = self._build_factorized()

    @staticmethod
    def _target_kind(model) -> Optional[str]:
        """"forest" for a tree ensemble, "linear" for a linear or logistic
        model, None for a model the scorer has no path for."""
        spec = getattr(model, "_spec", None)
        if spec is not None and hasattr(spec, "trees"):
            return "forest"
        if getattr(model, "_coefficients", None) is not None:
            return "linear"
        return None

    @staticmethod
    def supports(model) -> bool:
        """Whether the scorer has a path for `model` (or for the last
        stage of a PipelineModel), read from its type before any work."""
        stages = getattr(model, "stages", None)
        return DeviceScorer._target_kind(stages[-1] if stages else model) \
            is not None

    @staticmethod
    def _compile_target(model, device: torch.device):
        """("forest", the stacked tables on `device`) or ("linear", (w as
        float64 on `device`, b, whether logistic))."""
        kind = DeviceScorer._target_kind(model)
        if kind == "forest":
            return "forest", _tables(*model._spec.stacked(), device)
        if kind == "linear":
            coef = model._coefficients
            w = torch.from_numpy(np.asarray(coef, np.float64)).to(
                device, copy=True)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            return "linear", (w, float(getattr(model, "intercept", 0.0)),
                              hasattr(model, "numClasses"))
        raise TypeError(
            f"no device inference path for {type(model).__name__}: the "
            f"port scores tree ensembles and linear models only")

    @property
    def featuresCol(self) -> str:
        return self._model.getOrDefault("featuresCol")

    def _n_features(self) -> int:
        if self._kind == "linear":
            return int(self._params[0].shape[0])
        return self._spec.n_features

    def _host_prep(self, X: np.ndarray):
        """The host half of a launch: the checked f32 rows of a linear
        model, or a forest's binned rows."""
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self._n_features():
            raise ValueError(f"expected rows of {self._n_features()} "
                             f"features, got shape {X.shape}")
        if self._kind == "linear":
            return np.ascontiguousarray(X, dtype=np.float32)
        from .tree_impl import bin_with
        return bin_with(np.asarray(X, dtype=np.float64), self._spec.binning)

    def _hint(self, staged: np.ndarray) -> "_dispatch.WorkHint":
        """The JAX package's work estimate of scoring `staged`."""
        n = staged.shape[0]
        if self._kind == "linear":
            return _dispatch.WorkHint(flops=2.0 * n * staged.shape[1],
                                      kind="blas", out_bytes=4.0 * n)
        return _dispatch.WorkHint(
            flops=4.0 * n * len(self._spec.trees) * self._spec.depth,
            kind="traverse", out_bytes=4.0 * n)

    def _host_margin(self, staged: np.ndarray) -> np.ndarray:
        """The host route's margin of `_host_prep`'s rows: a forest's
        (n,) f32 through the C++ host traversal, a linear model's (n,)
        f64; the card's bits either way. Feeds the router's observed
        host rate."""
        hint = self._hint(staged)
        with _dispatch.observe_host(hint.kind, hint.flops):
            if self._kind == "linear":
                w, b, logistic = self._host_params
                out = _linear_forward_host(staged, w, b)
                if logistic:
                    out = torch.sigmoid(torch.from_numpy(out)).numpy()
                return out
            from ..native.host_traverse import forest_margin_host
            return forest_margin_host(staged, *self._host_params,
                                      depth=self._spec.depth)

    def _launch(self, staged: np.ndarray
                ) -> Tuple[torch.Tensor, int, Callable]:
        """Route `_host_prep`'s rows (`dispatch.decide`); on the host
        route score them there (the output a CPU tensor), else stage and
        launch. Returns (outputs, rows, finalize) without waiting for
        the device."""
        finalize = _identity if self._kind == "linear" \
            else self._finalize_forest
        if _dispatch.decide(self._hint(staged), self.device) == "host":
            return torch.from_numpy(self._host_margin(staged)), \
                staged.shape[0], finalize
        if self.device.type == "cuda":
            from ..parallel.prewarm import record_stage
            record_stage(self.device, staged.shape, staged.dtype)
        if self._kind == "linear":
            from ._staging import stage_rows
            w, b, logistic = self._params
            fwd = _logistic_forward if logistic else _linear_forward
            return fwd(stage_rows(staged, self.device), w, b), \
                staged.shape[0], finalize
        Bd = stage_bins_cached(staged, self.device)
        out = forest_traverse(Bd, *self._params, depth=self._spec.depth)
        if Bd.is_cuda and Bd.shape[0]:
            sf = self._params[0]
            self._kernel_spec = traverse_plan(
                Bd.shape[0], Bd.shape[1], Bd.element_size(), sf.shape[0],
                sf.shape[1], self._spec.depth)._asdict()
            _note_plan(self._kernel_spec)
        return out, staged.shape[0], finalize

    def _dispatch(self, X: np.ndarray) -> Tuple[torch.Tensor, int, Callable]:
        """Prep (binning a forest's rows), route, and score on the host or
        launch on the device; returns (outputs, rows, finalize) without
        waiting for the device."""
        return self._launch(self._host_prep(X))

    def _finalize_forest(self, margin: np.ndarray) -> np.ndarray:
        """Margin -> prediction: boosted binary margins go through the
        sigmoid, probability-leaf forests clip."""
        spec = self._spec
        margin = spec.base + margin
        if spec.mode == "binary":
            if spec.tree_weights is not None:
                return 1.0 / (1.0 + np.exp(-margin))
            return np.clip(margin, 0.0, 1.0)
        return margin

    def score_block(self, X: np.ndarray) -> np.ndarray:
        """Predict from a raw (n, d) feature block. The copy back to the
        host waits for the launch on this thread's current stream."""
        out, n, finalize = self._dispatch(X)
        return finalize(out.cpu().numpy().astype(np.float64)[:n])

    def score_block_host(self, X: np.ndarray) -> np.ndarray:
        """Predict a raw (n, d) feature block on the HOST route,
        unconditionally: the serving path's overflow and the canary's
        mirror. Never stages, never launches; gives `score_block`'s bits
        (a forest: `bin_with`, the C++ host traversal, `_finalize_forest`;
        a linear model: `_linear_forward_host`)."""
        staged = self._host_prep(X)
        margin = self._host_margin(staged)
        if self._kind == "linear":
            return margin
        return self._finalize_forest(margin.astype(np.float64))

    def kernel_spec(self) -> Optional[dict]:
        """The `traverse_plan` (as a dict) that this scorer's most recent
        launch of `forest_traverse` on the card resolved to, or None: a
        linear model, a CPU scorer, or no launch yet. Read once: a
        concurrent dispatch rebinds it."""
        spec = self._kernel_spec
        return None if spec is None else dict(spec)

    def resident_bytes(self) -> int:
        """Bytes a warm scorer pins on its device: the stacked tables or
        the coefficients — the cost the serving model cache budgets
        against."""
        tensors = self._params[:1] if self._kind == "linear" \
            else self._params
        return max(int(sum(t.numel() * t.element_size()
                           for t in tensors)), 64)

    # ------------------------------------------------- raw batches
    def _build_factorized(self):
        """(scalar sources with their weights, one-hot sources with their
        weight tables), aligned to the featurizer's slots; None when the
        model's width is not the featurizer's."""
        from .featurizer import _OneHotSource
        featurizer = self._featurizer
        w = np.asarray(self._model._coefficients, dtype=np.float64)
        if w.ndim != 1 or w.shape[0] != featurizer.width:
            return None
        scalars, embeds = [], []
        lo = 0
        for s in featurizer.sources:
            if isinstance(s, _OneHotSource):
                embeds.append((s, w[lo:lo + s.width].copy()))
            else:
                scalars.append((s, float(w[lo])))
            lo += s.width
        return scalars, embeds

    def _score_factorized(self, block) -> np.ndarray:
        """The linear (or logistic) prediction of a raw block without the
        one-hot block, in host float64: the numeric slots (f32-quantized,
        as the block route stages them) dotted with their weights, plus
        one weight-table lookup per one-hot column. The block route's
        result up to the order of the sums, with its NaN rows (a NaN code
        gives a NaN prediction) and its "skip" row drops."""
        from ..frame.column import block_len
        from .featurizer import (_IndexSource, _NumericSource,
                                 extract_numeric_block)
        # snapshot both compiled layers: score_batches calls this on
        # worker threads
        factorized, featurizer = self._factorized, self._featurizer
        scalars, embeds = factorized
        _, b, logistic = self._params
        n = block_len(block)
        drop = np.zeros(n, dtype=bool)
        acc = np.full(n, float(b), dtype=np.float64)
        num = [(s, wi) for s, wi in scalars if type(s) is _NumericSource]
        if num:
            fills = np.asarray([np.nan if s.fill is None else s.fill
                                for s, _ in num])
            vals = extract_numeric_block(block, [s.col for s, _ in num],
                                         fills)
            acc += vals.astype(np.float32).astype(np.float64) \
                @ np.asarray([wi for _, wi in num])
        for s, wi in scalars:
            if isinstance(s, _IndexSource):
                acc += wi * s.resolve(block, drop)
        for src, table in embeds:
            idx = src.codes(block, drop)
            na = ~np.isfinite(idx)
            ok = ~na & (idx >= 0) & (idx < len(table))
            contrib = np.zeros(n, dtype=np.float64)
            oki = np.nonzero(ok)[0]
            contrib[oki] = table[idx[oki].astype(np.intp)]
            contrib[na] = np.nan
            acc += contrib
        if featurizer.handle_invalid == "error" and \
                not np.isfinite(acc[~drop]).all():
            raise ValueError(
                f"VectorAssembler found NaN/null in {featurizer.in_cols}; "
                f"set handleInvalid='skip' or impute first")
        if drop.any():
            acc = acc[~drop]
        if logistic:
            acc = 1.0 / (1.0 + np.exp(-acc))
        return acc

    @staticmethod
    def _block_of(batch) -> dict:
        """A raw batch's columns: a port DataFrame's rows, a mapping of
        column name to values, or a pandas frame (ML 12's UDF batches,
        read through `.columns` and `to_numpy()` with no pandas
        import)."""
        from ..frame.dataframe import DataFrame
        if isinstance(batch, DataFrame):
            return batch._whole()
        if isinstance(batch, Mapping):
            return {k: np.asarray(v) for k, v in batch.items()}
        if hasattr(batch, "columns"):
            from ..frame._pandas import block_from_pandas
            return block_from_pandas(batch)
        raise TypeError(f"a batch is a DataFrame, a pandas frame, a mapping "
                        f"of columns or a feature block, not "
                        f"{type(batch).__name__}")

    def _prep(self, batch) -> np.ndarray:
        """The feature block of a batch: a numpy array as it is; a raw
        batch through the compiled featurizer, or else the prep stages
        one by one."""
        if isinstance(batch, np.ndarray):
            return batch
        block = self._block_of(batch)
        featurizer = self._featurizer
        if featurizer is not None:
            return featurizer(block)
        from ._staging import extract_features, features_of
        if not self._stages:
            return features_of(block, self.featuresCol)
        from ..frame.dataframe import DataFrame
        df = DataFrame.from_partitions([block])
        for s in self._stages:
            df = s.transform(df)
        return extract_features(df, self.featuresCol)

    def __call__(self, batch) -> np.ndarray:
        """Predict from a batch: a numpy array is a feature block
        (`score_block`); a raw batch (a port DataFrame, a pandas frame,
        or a mapping of column name to numpy array) goes through the factorized scorer
        where there is one, else its feature block (`_prep`) through
        `score_block`. A batch missing a raw column raises KeyError
        naming it; the next batch is scored as if it had not come."""
        if isinstance(batch, np.ndarray):
            return self.score_block(batch)
        if self._factorized is not None:
            return self._score_factorized(self._block_of(batch))
        return self.score_block(self._prep(batch))

    def score_batches(self, batches: Iterable, depth: Optional[int] = None,
                      order: Optional[list] = None) -> Iterator[np.ndarray]:
        """Score a stream of batches (as `__call__` takes them), results
        in order. The factorized scorer is host work: `prefetch_map` runs
        up to `depth` batches ahead on threads. Otherwise
        `prefetch_pipeline` runs each batch's prep (featurizing, and a
        forest's binning) on worker threads, dispatches up to `depth`
        batches ahead of the drain (their launches and an asynchronous
        copy back into pinned memory, behind an event) and drains in
        order, waiting on each batch's event before its buffer is read.
        `depth` defaults to `sml.infer.prefetchBatches`; `order`, a list,
        receives the ("dispatch" | "drain", batch) order."""
        from ..conf import GLOBAL_CONF
        from ..parallel.pipeline import prefetch_map, prefetch_pipeline
        if depth is None:
            depth = max(GLOBAL_CONF.getInt("sml.infer.prefetchBatches"), 1)
        if self._factorized is not None:
            yield from prefetch_map(batches, self.__call__, depth=depth)
            return

        def prep(batch):
            return self._host_prep(self._prep(batch))

        def dispatch(_i, staged):
            out, n, finalize = self._launch(staged)
            if out.device.type != "cuda":
                return out, None, n, finalize
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
            return host, done, n, finalize

        def drain(_i, handle):
            host, done, n, finalize = handle
            if done is not None:
                done.synchronize()  # the pinned copy has landed
            return finalize(host.numpy().astype(np.float64)[:n])

        yield from prefetch_pipeline(batches, prep, dispatch, drain,
                                     depth=depth, workers=4, family="infer",
                                     order=order)


def _identity(x: np.ndarray) -> np.ndarray:
    return x
