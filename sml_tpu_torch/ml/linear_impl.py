"""Linear-model solvers on one device.

The port's copy of the materialized half of `sml_tpu/ml/linear_impl.py`:

- one device pass builds the Gram block `[X 1]^T [X 1]`, `[X 1]^T y`,
  n and y'y (`gram_stats`); every least-squares variant is then host
  algebra on those (d+1)^2 moments (`_solve_gram`): the closed form with
  its ridge diagonal in float64 numpy, and FISTA on the Gram for an
  elastic-net penalty;
- logistic regression runs IRLS Newton steps (`fit_logistic`): each
  iteration is one device pass for the gradient, the Hessian and the
  log-likelihood, and one copy of them back; the solve and the proximal
  shrink stay on the host in float64.

Precision: the device passes accumulate in float64 and round once to
f32 where the JAX package hands f32 moments to the host, so that the
card and the CPU give the same moments (the port's histogram rule). The
products run as float64 matmuls: TF32 never enters. On integer data
whose partial sums stay below 2^24 the moments are exact in both
packages, so they are bit-equal.

Not ported yet: the compact front ends (`gram_stats_compact`,
`fit_linear_compact`, the fused compact IRLS), which only the JAX
package's fused featurizer reaches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiler import PROFILER


class LinearFit(NamedTuple):
    coefficients: np.ndarray
    intercept: float
    iterations: int
    # training-fit statistics derived from the same Gram pass (no second
    # data pass): {"sse", "var_y", "var_pred", "n"} — see fit_linear
    stats: Optional[dict] = None


def _stage_f64(X: np.ndarray, y: np.ndarray, device: torch.device):
    """[X 1] and y on `device` as float64 (the f32 values widened
    exactly)."""
    from ._staging import stage_rows
    Xd = stage_rows(X, device).to(torch.float64)
    Xa = torch.cat([Xd, torch.ones((Xd.shape[0], 1), dtype=torch.float64,
                                   device=device)], dim=1)
    return Xa, stage_rows(y, device).to(torch.float64)


def _to_host_f32(*parts: torch.Tensor) -> np.ndarray:
    """The parts flattened into one vector, rounded once to f32 and
    copied back in one transfer, as float64 on the host."""
    packed = torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)
    return packed.cpu().numpy().astype(np.float64)


def _gram_pass(Xa: torch.Tensor, y: torch.Tensor):
    """A = Xa^T Xa, b = Xa^T y and y'y, summed in float64."""
    return Xa.T @ Xa, Xa.T @ y, y @ y


def gram_stats(X: np.ndarray, y: np.ndarray, device=None
               ) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """One device pass: (A = [X 1]^T [X 1], b = [X 1]^T y, n, y^T y), as
    float64 host values of the f32 moments. `device` defaults to the
    card."""
    dev = resolve_device(device)
    n_rows, d = X.shape
    with PROFILER.span("program.gram", rows=int(n_rows), route=dev.type):
        A, b, yy = _gram_pass(*_stage_f64(X, y, dev))
        flat = _to_host_f32(A, b, yy)
    k = (d + 1) * (d + 1)
    return (flat[:k].reshape(d + 1, d + 1), flat[k:k + d + 1],
            float(np.float32(n_rows)), float(flat[-1]))


def _fit_stats(A, b, n_f, yy, w_full):
    """Training rmse/r2/explained-variance from Gram identities:
    SSE = y'y - 2 w'b + w'Aw;  sum(pred) = A[-1, :] @ w  (last Gram row is
    the column-sum of [X 1]);  var(pred) = w'Aw/n - mean(pred)^2."""
    sse = float(yy - 2.0 * w_full @ b + w_full @ A @ w_full)
    sy = b[-1] / n_f
    var_y = float(yy / n_f - sy * sy)
    mean_pred = float(A[-1, :] @ w_full) / n_f
    var_pred = float(w_full @ A @ w_full) / n_f - mean_pred ** 2
    return {"sse": max(sse, 0.0), "var_y": max(var_y, 0.0),
            "var_pred": max(var_pred, 0.0), "n": n_f}


def fit_linear(X: np.ndarray, y: np.ndarray, *, regParam: float = 0.0,
               elasticNetParam: float = 0.0, fitIntercept: bool = True,
               standardization: bool = True, maxIter: int = 100,
               tol: float = 1e-6, device=None) -> LinearFit:
    """Least squares with (optional) elastic-net penalty on the Gram
    sufficient statistics. Matches MLlib semantics: the penalty applies to
    standardized coefficients; the intercept is never penalized."""
    d = X.shape[1]
    A, b, n_f, yy = gram_stats(X, y, device)
    return _solve_gram(A, b, n_f, yy, d, regParam=regParam,
                       elasticNetParam=elasticNetParam,
                       fitIntercept=fitIntercept,
                       standardization=standardization,
                       maxIter=maxIter, tol=tol)


def _fista(Axx: np.ndarray, bxy: np.ndarray, L: float, l1: float,
           l2: float, max_iter: int) -> np.ndarray:
    """`max_iter` FISTA steps from 0 on the (d, d) Gram, in f32 as the
    JAX package's jitted loop runs them (no early exit)."""
    f32 = np.float32
    Axx = Axx.astype(f32)
    bxy = bxy.astype(f32)
    L32, thr, l2 = f32(L), f32(l1 / L), f32(l2)
    w = np.zeros(Axx.shape[0], f32)
    v = w
    t = f32(1.0)
    for _ in range(max_iter):
        g = Axx @ v - bxy + l2 * v
        z = v - g / L32
        w_new = np.sign(z) * np.maximum(np.abs(z) - thr, f32(0.0))
        t_new = (f32(1.0) + np.sqrt(f32(1.0) + f32(4.0) * t * t)) / f32(2.0)
        v = w_new + ((t - f32(1.0)) / t_new) * (w_new - w)
        w, t = w_new, t_new
    return w


def _solve_gram(A, b, n_f, yy, d, *, regParam, elasticNetParam,
                fitIntercept, standardization, maxIter, tol) -> LinearFit:
    """Every least-squares variant from the (d+1)^2 Gram moments."""
    # moments from the Gram pass (last row/col hold the sums)
    sx = A[-1, :d] / n_f
    sy = b[-1] / n_f
    xx_diag = np.diag(A)[:d] / n_f
    std = np.sqrt(np.maximum(xx_diag - sx ** 2, 1e-12))
    lam = float(regParam)
    alpha = float(elasticNetParam)

    if lam == 0.0 or alpha == 0.0:
        # closed form: (A + λ n S²)⁻¹ b with S scaling the standardized L2
        # penalty back to raw space; intercept row/col unpenalized
        reg = np.zeros_like(A)
        if lam > 0:
            # penalizing standardized coefficients (w_std = w·std) puts a
            # λ·std² diagonal on the raw-space normal equations — same
            # semantics as the FISTA branch below
            scale = (std ** 2) if standardization else np.ones(d)
            reg[:d, :d] = np.diag(lam * n_f * scale)
        if not fitIntercept:
            sol = np.linalg.solve(A[:d, :d] + reg[:d, :d] + 1e-9 * np.eye(d),
                                  b[:d])
            w_full = np.concatenate([sol, [0.0]])
            return LinearFit(sol, 0.0, 1, _fit_stats(A, b, n_f, yy, w_full))
        sol = np.linalg.solve(A + reg + 1e-9 * np.eye(d + 1), b)
        return LinearFit(sol[:d], float(sol[d]), 1,
                         _fit_stats(A, b, n_f, yy, sol))

    # elastic net via FISTA on the (tiny) Gram — centered space
    Axx = A[:d, :d] / n_f - np.outer(sx, sx)
    bxy = b[:d] / n_f - sx * sy
    if standardization:
        Axx = Axx / np.outer(std, std)
        bxy = bxy / std
    L = float(np.linalg.eigvalsh(Axx).max()) + lam * (1 - alpha)
    w = _fista(Axx, bxy, L, lam * alpha, lam * (1 - alpha), maxIter)
    w = np.asarray(w, dtype=np.float64)
    if standardization:
        w = w / std
    intercept = float(sy - sx @ w) if fitIntercept else 0.0
    w_full = np.concatenate([w, [intercept]])
    return LinearFit(w, intercept, maxIter, _fit_stats(A, b, n_f, yy, w_full))


def _newton_pass(Xa: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """grad, hess and log-likelihood of the logistic loss at `w`, summed
    in float64."""
    eta = Xa @ w
    p = torch.sigmoid(eta)
    Wdiag = torch.clamp_min(p * (1 - p), 1e-6)
    grad = Xa.T @ (p - y)
    hess = (Xa * Wdiag[:, None]).T @ Xa
    ll = torch.sum(y * torch.nn.functional.logsigmoid(eta)
                   + (1 - y) * torch.nn.functional.logsigmoid(-eta))
    return grad, hess, ll


def fit_logistic(X: np.ndarray, y: np.ndarray, *, regParam: float = 0.0,
                 elasticNetParam: float = 0.0, fitIntercept: bool = True,
                 standardization: bool = True, maxIter: int = 100,
                 tol: float = 1e-7, device=None) -> LinearFit:
    """Binomial logistic regression by IRLS Newton steps: each iteration
    is one device pass over the resident [X 1] (`_newton_pass`) and one
    copy back of the f32-rounded gradient, Hessian and log-likelihood.
    As with fit_linear, the default penalty applies to standardized
    coefficients, i.e. a per-feature std² scale in raw space."""
    dev = resolve_device(device)
    n, d = X.shape
    lam = float(regParam)
    l2 = lam * (1 - float(elasticNetParam))
    l1 = lam * float(elasticNetParam)
    if standardization and lam > 0:
        # f64 accumulation without materializing an f64 copy of X
        pen_scale = np.maximum(X.var(axis=0, dtype=np.float64), 1e-12)
    else:
        pen_scale = np.ones(d)

    w = np.zeros(d + 1, dtype=np.float32)
    n_f = float(len(y))
    prev_ll = -np.inf
    iters = 0
    k = (d + 1) * (d + 1)
    with PROFILER.span("program.irls", rows=int(n), route=dev.type):
        Xa, yd = _stage_f64(X, y, dev)
        for it in range(maxIter):
            wd = torch.from_numpy(w).to(dev).to(torch.float64)
            flat = _to_host_f32(*_newton_pass(Xa, yd, wd))
            grad = flat[:d + 1].copy()
            hess = flat[d + 1:d + 1 + k].reshape(d + 1, d + 1).copy()
            ll = flat[-1]
            if l2 > 0:
                grad[:d] += l2 * n_f * pen_scale * w[:d]
                hess[:d, :d] += l2 * n_f * np.diag(pen_scale)
            step = np.linalg.solve(hess + 1e-8 * np.eye(d + 1), grad)
            w_new = w - step.astype(np.float32)
            if l1 > 0:  # proximal shrink on coefficients (not intercept)
                # standardized L1 is λα·Σ σ_j|w_j| in raw space — linear
                # in σ, unlike the quadratic L2 term's σ²
                scale = np.abs(np.diag(hess)[:d]) + 1e-12
                w_new[:d] = np.sign(w_new[:d]) * np.maximum(
                    np.abs(w_new[:d])
                    - l1 * n_f * np.sqrt(pen_scale) / scale, 0.0)
            iters = it + 1
            if np.max(np.abs(w_new - w)) < tol:
                w = w_new
                break
            if float(ll) < prev_ll - 1e3:  # diverging: damp
                w = (w + w_new) / 2
            else:
                w = w_new
            prev_ll = float(ll)
    if not fitIntercept:
        return LinearFit(np.asarray(w[:d], dtype=np.float64), 0.0, iters)
    return LinearFit(np.asarray(w[:d], dtype=np.float64), float(w[d]), iters)


def predict_linear(X: np.ndarray, coefficients: np.ndarray,
                   intercept: float, device=None) -> np.ndarray:
    """X @ w + b on `device` (the card by default), in float64: always
    `inference.predict_linear_sharded` (the JAX package's dispatcher may
    take a batch to the host instead)."""
    if X.size == 0:
        return np.zeros((X.shape[0],))
    from .inference import predict_linear_sharded
    return predict_linear_sharded(X, coefficients, intercept, device=device)
