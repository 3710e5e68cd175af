"""Batch and online scoring of tree ensembles and linear models on one
device.

Counterpart of the forest and linear paths of `sml_tpu/ml/inference.py`.
For a forest, rows are binned on the host, the compact bin matrix is
staged once per content (`_staging.stage_bins_cached`), and the stacked
ensemble is traversed by `native.traverse_kernel.forest_traverse`, which
launches the CUDA kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors. A linear or logistic model scores `X @ w + b`
(through the sigmoid for the logistic) as a float64 matmul on the
device, always: there is no host route until the dispatcher is ported.
`DeviceScorer` is the load-once, score-many object a server holds.

Not ported yet: the factorized linear scorer, which rides the JAX
package's fused featurizer, `score_batches`, `score_block_host` and the
pandas `__call__`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..native.traverse_kernel import forest_traverse
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
    """X @ w + b of device rows, in float64."""
    return Xd.to(torch.float64) @ w + b


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
    paths. The sums are plain torch ops outside the kernel."""
    if link not in LINKS:
        raise ValueError(f"unknown link {link!r}; one of {sorted(LINKS)}")
    link_fn = LINKS[link]

    def forest_eval(binned, l, lmask, sf, sb, lv, weights, base):
        pred = base + forest_traverse(binned, sf, sb, lv, weights,
                                      depth=depth)
        m = lmask
        if link_fn is not None:
            pred = link_fn(pred)
            ok = torch.isfinite(pred)
            m = m * ok.to(torch.float32)
            pred = torch.where(ok, pred, 0.0)
        d = (pred - l) * m
        return (torch.sum(m), torch.sum(d * d), torch.sum(torch.abs(d)),
                torch.sum(m * l), torch.sum(m * l * l))

    return forest_eval


class DeviceScorer:
    """Load-once, score-many wrapper of a fitted model: a tree ensemble
    (any object with an `_EnsembleSpec` as `_spec`), a linear or logistic
    regression model (`_coefficients`, `intercept`), or a PipelineModel
    that ends in one, whose `score_block` takes the feature block its last
    stage reads.

    `device` defaults to the CUDA card and raises when there is none;
    pass device="cpu" to score with the plain PyTorch versions."""

    def __init__(self, model, device=None):
        stages = getattr(model, "stages", None)
        tail = stages[-1] if stages else model
        self.device = resolve_device(device)
        self._spec = None
        self._kind, self._params = self._compile_target(tail, self.device)
        if self._kind == "forest":
            self._spec = tail._spec

    @staticmethod
    def _compile_target(model, device: torch.device):
        """("forest", the stacked tables on `device`) or ("linear", (w as
        float64 on `device`, b, whether logistic))."""
        spec = getattr(model, "_spec", None)
        if spec is not None and hasattr(spec, "trees"):
            return "forest", _tables(*spec.stacked(), device)
        coef = getattr(model, "_coefficients", None)
        if coef is not None:
            w = torch.from_numpy(np.asarray(coef, np.float64)).to(
                device, copy=True)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            return "linear", (w, float(getattr(model, "intercept", 0.0)),
                              hasattr(model, "numClasses"))
        raise TypeError(
            f"no device inference path for {type(model).__name__}: the "
            f"port scores tree ensembles and linear models only")

    def _n_features(self) -> int:
        if self._kind == "linear":
            return int(self._params[0].shape[0])
        return self._spec.n_features

    def _dispatch(self, X: np.ndarray) -> Tuple[torch.Tensor, int, Callable]:
        """Stage and launch (binning a forest's rows first); returns
        (device outputs, rows, finalize) without waiting for the
        device."""
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self._n_features():
            raise ValueError(f"expected rows of {self._n_features()} "
                             f"features, got shape {X.shape}")
        if self._kind == "linear":
            from ._staging import stage_rows
            w, b, logistic = self._params
            fwd = _logistic_forward if logistic else _linear_forward
            out = fwd(stage_rows(X, self.device), w, b)
            return out, X.shape[0], _identity
        from .tree_impl import bin_with
        binned = bin_with(np.asarray(X, dtype=np.float64), self._spec.binning)
        Bd = stage_bins_cached(binned, self.device)
        out = forest_traverse(Bd, *self._params, depth=self._spec.depth)
        return out, binned.shape[0], self._finalize_forest

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

    def resident_bytes(self) -> int:
        """Bytes a warm scorer pins on its device: the stacked tables or
        the coefficients — the cost the serving model cache budgets
        against."""
        tensors = self._params[:1] if self._kind == "linear" \
            else self._params
        return max(int(sum(t.numel() * t.element_size()
                           for t in tensors)), 64)


def _identity(x: np.ndarray) -> np.ndarray:
    return x
