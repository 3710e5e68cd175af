"""Time-series models: Prophet-style decomposition, ARIMA, Holt smoothing.

The port's copy of `sml_tpu/timeseries.py` (the MLE 04 elective,
`SML/ML Electives/MLE 04 - Time Series Forecasting.py`):

- `Prophet`: additive trend + Fourier seasonality + holiday effects
  (`MLE 04:79-176`). The Gram and both FISTA runs (the pilot fit and the
  fit with L1 on the changepoint deltas, 500 iterations each) run as
  float64 torch ops on the session's device (`sml.device`). Dates are
  numpy `datetime64[us]`: `fit` takes the port's DataFrame or any
  mapping with "ds" and "y" columns, and `make_future_dataframe` /
  `predict` return the port's DataFrame.
- `adfuller`, `acf`, `pacf` (Durbin-Levinson) for the stationarity
  workflow (`MLE 04:280-303`): numpy on the host, as in the JAX package.
- `ARIMA(p, d, q)`: conditional-sum-of-squares fit by scipy's L-BFGS-B
  on the host over a float64 torch loss and its autograd gradient on the
  device. The innovation recursion is linear in the innovations: its AR
  part is a product of lagged values with the AR coefficients, and its
  MA part a unit lower-triangular banded Toeplitz system, solved with
  one `torch.linalg.solve_triangular` (a dense n x n matrix: 67 MB at
  2,905 points). Each evaluation copies the loss and the gradient back
  in one transfer. Where an innovation overflows (a line search far
  outside the invertible region), the loss is taken again step by step,
  forward only, so that it is the JAX package's inf (the solve gives
  NaN there, and L-BFGS-B backtracks from inf but not from NaN).
- `Holt` / `SimpleExpSmoothing` / `ExponentialSmoothing` with optimized
  smoothing parameters, incl. damped trend (`MLE 04:367-407`): numpy.

The JAX package runs Prophet's FISTA and ARIMA's loss in float32 unless
x64 is enabled; the port runs them in float64.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .utils.profiler import PROFILER

#: pandas' `date_range` frequencies the port reproduces, as the step of
#: the fixed-width ones ("W" is anchored on Sundays, as pandas' W-SUN)
_FIXED_FREQ = {"D": np.timedelta64(1, "D"), "h": np.timedelta64(1, "h"),
               "min": np.timedelta64(1, "m"), "s": np.timedelta64(1, "s"),
               "W": np.timedelta64(7, "D")}


def _to_datetime64(values) -> np.ndarray:
    """A column of dates as `datetime64[us]` (ISO text parses, as numpy
    parses it)."""
    arr = np.asarray(values)
    if arr.dtype.kind != "M":
        arr = np.array([np.datetime64(v) if v is not None else
                        np.datetime64("NaT") for v in arr.tolist()])
    return arr.astype("datetime64[us]")


def _columns(df) -> Dict[str, np.ndarray]:
    """Every column of the port's DataFrame, or of any mapping of
    columns (a dict, a pandas frame), as numpy arrays."""
    from .frame.dataframe import DataFrame
    if isinstance(df, DataFrame):
        return dict(df._whole())
    names = list(df.columns) if hasattr(df, "columns") else list(df.keys())
    return {str(c): np.asarray(df[c]) for c in names}


def _frame(block: Dict[str, np.ndarray]):
    from .frame.dataframe import DataFrame
    from .frame.session import get_session
    return DataFrame.from_block(block, session=get_session())


def _seconds(td: np.ndarray) -> np.ndarray:
    """`Timedelta.total_seconds()` of a timedelta64[us] array."""
    return td.astype("timedelta64[us]").astype(np.int64) / 1e6


def date_range_after(last: np.datetime64, periods: int,
                     freq: str) -> np.ndarray:
    """`pd.date_range(last, periods=periods + 1, freq=freq)[1:]` for the
    frequencies "D", "h", "min", "s", "W" (Sundays), "MS" (month starts)
    and "ME" (month ends), as datetime64[us]."""
    last = np.datetime64(last, "us")
    if freq in _FIXED_FREQ:
        step = _FIXED_FREQ[freq]
        first = last
        if freq == "W":  # the first Sunday on or after `last`
            day = last.astype("datetime64[D]")
            dow = (day.astype(np.int64) + 3) % 7  # Monday = 0
            first = last + np.timedelta64(int((6 - dow) % 7), "D")
        return first + step * np.arange(periods + 1)[1:]
    if freq in ("MS", "ME"):
        day = last.astype("datetime64[D]")
        tod = last - day.astype("datetime64[us]")
        month = day.astype("datetime64[M]")
        if freq == "MS":
            start = month if day == month.astype("datetime64[D]") \
                else month + 1
            months = start + np.arange(periods + 1)
            days = months.astype("datetime64[D]")
        else:  # this month's end is on or after `last`
            months = month + np.arange(periods + 1)
            days = (months + 1).astype("datetime64[D]") - 1
        return (days.astype("datetime64[us]") + tod)[1:]
    raise NotImplementedError(
        f"freq {freq!r}: the port reproduces pandas' date_range for 'D', "
        "'h', 'min', 's', 'W', 'MS' and 'ME' only")


def _fista_torch(G: torch.Tensor, b: torch.Tensor, l2: torch.Tensor,
                 L: float, l1: torch.Tensor, iters: int = 500
                 ) -> torch.Tensor:
    """Proximal gradient (FISTA) on 0.5 w'Gw - b'w + 0.5 l2 w'w + l1|w|,
    from zero, in the JAX package's step order."""
    w = torch.zeros_like(b)
    v = w.clone()
    tk = 1.0
    thresh = l1 / L
    for _ in range(iters):
        g = G @ v - b + l2 * v
        z = v - g / L
        w_new = torch.sign(z) * torch.clamp(z.abs() - thresh, min=0.0)
        t_new = (1 + math.sqrt(1 + 4 * tk * tk)) / 2
        v = w_new + ((tk - 1) / t_new) * (w_new - w)
        w, tk = w_new, t_new
    return w


# =============================================================== Prophet-lite
class Prophet:
    def __init__(self, growth: str = "linear", n_changepoints: int = 25,
                 changepoint_range: float = 0.8,
                 changepoint_prior_scale: float = 0.05,
                 yearly_seasonality="auto", weekly_seasonality="auto",
                 daily_seasonality="auto", holidays=None,
                 seasonality_mode: str = "additive",
                 interval_width: float = 0.8):
        self.growth = growth
        self.n_changepoints = n_changepoints
        self.changepoint_range = changepoint_range
        self.changepoint_prior_scale = changepoint_prior_scale
        self.yearly = yearly_seasonality
        self.weekly = weekly_seasonality
        self.daily = daily_seasonality
        self.holidays = holidays
        self.interval_width = interval_width
        self.changepoints: Optional[np.ndarray] = None
        self._fitted = False

    # -- design matrix ----------------------------------------------------
    def _scale_t(self, ds: np.ndarray) -> np.ndarray:
        t0, t1 = self._t_start, self._t_end
        return _seconds(ds - t0) / max(float(_seconds(
            np.asarray([t1 - t0]))[0]), 1.0)

    def _fourier(self, t_days: np.ndarray, period: float, order: int
                 ) -> np.ndarray:
        cols = []
        for k in range(1, order + 1):
            arg = 2 * np.pi * k * t_days / period
            cols += [np.sin(arg), np.cos(arg)]
        return np.stack(cols, axis=1) if cols \
            else np.zeros((len(t_days), 0))

    def _season_blocks(self, ds: np.ndarray,
                       force: Optional[List[str]] = None
                       ) -> Dict[str, np.ndarray]:
        """Seasonality design blocks. At fit time the 'auto' gates resolve
        against the training span; at predict time `force` carries the
        fitted block names, so a short frame gets the fitted columns."""
        t_days = _seconds(ds - self._t_start) / 86400.0
        span_days = t_days.max() - t_days.min() if len(t_days) else 0
        on = (lambda name, flag, gate: name in force) if force is not None \
            else (lambda name, flag, gate: (flag is True)
                  or (flag == "auto" and gate))
        blocks: Dict[str, np.ndarray] = {}
        if on("yearly", self.yearly, span_days >= 2 * 365):
            blocks["yearly"] = self._fourier(t_days, 365.25, 10)
        if on("weekly", self.weekly, span_days >= 14):
            blocks["weekly"] = self._fourier(t_days, 7.0, 3)
        if on("daily", self.daily, False):
            blocks["daily"] = self._fourier(t_days, 1.0, 4)
        if (self.holidays is not None if force is None
                else "holidays" in force):
            hd = _to_datetime64(_columns(self.holidays)["ds"]) \
                .astype("datetime64[D]")
            flag = np.isin(ds.astype("datetime64[D]"), hd)
            blocks["holidays"] = flag.astype(float)[:, None]
        return blocks

    def _trend_matrix(self, t: np.ndarray) -> np.ndarray:
        # piecewise-linear trend: base slope + per-changepoint slope deltas
        cps = self._cps
        A = np.maximum(t[:, None] - cps[None, :], 0.0)
        return np.concatenate([np.ones((len(t), 1)), t[:, None], A], axis=1)

    def fit(self, df) -> "Prophet":
        """Fit on a frame with "ds" and "y" columns, on the session's
        device (`sml.device`; without a card it raises unless that is
        "cpu")."""
        from .device import session_device
        device = session_device()
        with PROFILER.span("program.prophet", device=str(device)):
            return self._fit(df, device)

    def _fit(self, df, device) -> "Prophet":
        cols = _columns(df)
        ds = _to_datetime64(cols["ds"])
        order = np.argsort(ds.astype(np.int64), kind="quicksort")
        cols = {c: v[order] for c, v in cols.items()}
        ds = cols["ds"] = ds[order]
        self._t_start, self._t_end = ds[0], ds[-1]
        y = np.asarray(cols["y"], dtype=np.float64)
        self._y_mean, self._y_scale = float(np.mean(y)), \
            float(np.std(y) or 1.0)
        yn = (y - self._y_mean) / self._y_scale
        t = self._scale_t(ds)
        n_cp = min(self.n_changepoints, max(len(ds) // 3, 1))
        self._cps = np.linspace(0, self.changepoint_range, n_cp + 2)[1:-1]
        cp_idx = np.searchsorted(t, self._cps)
        self.changepoints = ds[np.clip(cp_idx, 0, len(ds) - 1)]

        T = self._trend_matrix(t)
        blocks = self._season_blocks(ds)
        self._block_names = list(blocks)
        X = np.concatenate([T] + [blocks[b] for b in self._block_names],
                           axis=1) if blocks else T
        self._n_trend = T.shape[1]

        # ridge on seasonality, L1 (sparsity) on changepoint deltas: the
        # Gram and FISTA run on the device in float64
        n, d = X.shape
        Xd = torch.from_numpy(X).to(device)
        G = Xd.T @ Xd / n
        b = Xd.T @ torch.from_numpy(yn).to(device) / n
        l1_mask = np.zeros(d)
        l1_mask[2:self._n_trend] = 1.0   # changepoint deltas
        l2 = np.full(d, 1e-4)
        l2[self._n_trend:] = 1.0 / (10.0 ** 2)  # seasonal prior scale
        L = float(np.linalg.eigvalsh(G.cpu().numpy()).max()) \
            + float(l2.max())
        l2_d = torch.from_numpy(l2).to(device)
        zeros = torch.zeros(d, dtype=torch.float64, device=device)

        # Laplace(tau = changepoint_prior_scale) MAP on the 1/n Gram
        # objective: lambda = sigma^2 / (n tau), sigma^2 from an
        # unpenalized pilot fit
        w_pilot = _fista_torch(G, b, l2_d, L, zeros).cpu().numpy()
        sigma2 = float(np.var(yn - X @ w_pilot))
        lam = sigma2 / (max(n, 1) * max(self.changepoint_prior_scale, 1e-12))
        l1 = torch.from_numpy(l1_mask * lam).to(device)
        w = _fista_torch(G, b, l2_d, L, l1).cpu().numpy()
        self._w = w
        resid = yn - X @ w
        self._sigma = float(np.std(resid))
        self._fitted = True
        self._history = cols
        return self

    @property
    def history(self):
        """The training frame, sorted by "ds" (the port's DataFrame)."""
        return _frame(self._history)

    def make_future_dataframe(self, periods: int, freq: str = "D",
                              include_history: bool = True):
        hist = self._history["ds"]
        future = date_range_after(hist[-1], periods, freq)
        ds = np.concatenate([hist, future]) if include_history else future
        return _frame({"ds": ds})

    def predict(self, df=None):
        ds = self._history["ds"] if df is None \
            else _to_datetime64(_columns(df)["ds"])
        t = self._scale_t(ds)
        T = self._trend_matrix(t)
        blocks = self._season_blocks(ds, force=self._block_names)
        X = np.concatenate([T] + [blocks[bn] for bn in self._block_names],
                           axis=1)
        yn = X @ self._w
        trend_n = T @ self._w[:self._n_trend]
        z = 1.2815515655446004  # 80% interval (Prophet default width)
        z = z * (self.interval_width / 0.8)
        out = {
            "ds": ds,
            "yhat": yn * self._y_scale + self._y_mean,
            "trend": trend_n * self._y_scale + self._y_mean,
            "yhat_lower": (yn - z * self._sigma) * self._y_scale
            + self._y_mean,
            "yhat_upper": (yn + z * self._sigma) * self._y_scale
            + self._y_mean,
        }
        col_off = self._n_trend
        for bn in self._block_names:
            width = blocks[bn].shape[1]
            comp = blocks[bn] @ self._w[col_off:col_off + width] \
                if width else 0.0
            out[bn] = np.broadcast_to(np.asarray(comp) * self._y_scale,
                                      (len(ds),)).copy()
            col_off += width
        return _frame(out)

    def plot(self, forecast, ax=None):
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        fc = _columns(forecast)
        if ax is None:
            _, ax = plt.subplots(figsize=(10, 6))
        ax.plot(self._history["ds"], self._history["y"], "k.", markersize=2)
        ax.plot(fc["ds"], fc["yhat"], "b-")
        ax.fill_between(fc["ds"], fc["yhat_lower"], fc["yhat_upper"],
                        alpha=0.2)
        return ax.figure

    def plot_components(self, forecast):
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        fc = _columns(forecast)
        comps = ["trend"] + [c for c in self._block_names if c in fc]
        fig, axes = plt.subplots(len(comps), 1, figsize=(10, 3 * len(comps)))
        axes = np.atleast_1d(axes)
        for ax, c in zip(axes, comps):
            ax.plot(fc["ds"], fc[c])
            ax.set_ylabel(c)
        return fig


def prophet_from_fitted(w, cps, t_start, t_end, y_mean: float,
                        y_scale: float, sigma: float, block_names,
                        n_trend: int, history, **params) -> Prophet:
    """A fitted Prophet from another fit's arrays (the JAX package's
    `_w`, `_cps`, `_t_start` / `_t_end` as datetime64, `_y_mean`,
    `_y_scale`, `_sigma`, `_block_names`, `_n_trend`), its training frame
    (a frame or mapping with "ds" and "y") and its constructor arguments
    (`holidays` among them when it had a holiday block)."""
    m = Prophet(**params)
    cols = _columns(history)
    ds = _to_datetime64(cols["ds"])
    order = np.argsort(ds.astype(np.int64), kind="quicksort")
    m._history = {c: v[order] for c, v in cols.items()}
    m._history["ds"] = ds[order]
    m._w = np.asarray(w, dtype=np.float64)
    m._cps = np.asarray(cps, dtype=np.float64)
    m._t_start = np.datetime64(t_start, "us")
    m._t_end = np.datetime64(t_end, "us")
    m._y_mean, m._y_scale = float(y_mean), float(y_scale)
    m._sigma = float(sigma)
    m._block_names = list(block_names)
    m._n_trend = int(n_trend)
    m._fitted = True
    return m


# ========================================================== stationarity tools
def acf(x: np.ndarray, nlags: int = 40) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = len(x)
    denom = np.sum(x * x)
    return np.array([1.0] + [np.sum(x[:n - k] * x[k:]) / denom
                             for k in range(1, nlags + 1)])


def pacf(x: np.ndarray, nlags: int = 40) -> np.ndarray:
    """Durbin-Levinson recursion."""
    r = acf(x, nlags)
    phi = np.zeros((nlags + 1, nlags + 1))
    out = np.zeros(nlags + 1)
    out[0] = 1.0
    for k in range(1, nlags + 1):
        num = r[k] - np.sum(phi[k - 1, 1:k] * r[1:k][::-1])
        den = 1.0 - np.sum(phi[k - 1, 1:k] * r[1:k])
        phi[k, k] = num / den if den != 0 else 0.0
        for j in range(1, k):
            phi[k, j] = phi[k - 1, j] - phi[k, k] * phi[k - 1, k - j]
        out[k] = phi[k, k]
    return out


def adfuller(x, maxlag: Optional[int] = None, regression: str = "c"):
    """Augmented Dickey-Fuller test. Returns (stat, pvalue, usedlag, nobs,
    critical values, icbest) like statsmodels (`MLE 04:280-303`)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if maxlag is None:
        maxlag = int(np.ceil(12.0 * (n / 100.0) ** 0.25))
        maxlag = min(maxlag, n // 2 - 2)
    dx = np.diff(x)
    lag = maxlag
    # regression: dx_t = a + rho*x_{t-1} + sum_j b_j dx_{t-j} + e
    rows = len(dx) - lag
    X = [np.ones(rows), x[lag:-1]]
    if regression == "ct":
        X.append(np.arange(rows, dtype=float))
    for j in range(1, lag + 1):
        X.append(dx[lag - j:-j])
    X = np.stack(X, axis=1)
    yv = dx[lag:]
    beta, res, *_ = np.linalg.lstsq(X, yv, rcond=None)
    resid = yv - X @ beta
    s2 = resid @ resid / (rows - X.shape[1])
    cov = s2 * np.linalg.inv(X.T @ X)
    stat = beta[1] / np.sqrt(cov[1, 1])
    # MacKinnon approximate critical values (constant-only case)
    crit = {"1%": -3.43, "5%": -2.86, "10%": -2.57}
    # coarse p-value by interpolation over the tau table
    taus = np.array([-4.5, -3.43, -2.86, -2.57, -1.94, -0.6, 1.0])
    ps = np.array([1e-4, 0.01, 0.05, 0.10, 0.30, 0.85, 0.999])
    pvalue = float(np.interp(stat, taus, ps))
    return float(stat), pvalue, lag, rows, crit, float("nan")


# ==================================================================== ARIMA
class ARIMAResults:
    def __init__(self, model: "ARIMA", params: np.ndarray, sigma2: float,
                 llf: float):
        self.model = model
        self.params = params
        self.sigma2 = sigma2
        self.llf = llf

    @property
    def aic(self) -> float:
        k = len(self.params) + 1
        return 2 * k - 2 * self.llf

    def forecast(self, steps: int = 1) -> np.ndarray:
        return self.model._forecast(self.params, steps)

    def predict(self, start=None, end=None) -> np.ndarray:
        return self.model._fitted_values(self.params)

    @property
    def fittedvalues(self) -> np.ndarray:
        return self.model._fitted_values(self.params)

    def summary(self) -> str:
        p, d, q = self.model.order
        return (f"ARIMA({p},{d},{q})  n={len(self.model._y)}  "
                f"sigma2={self.sigma2:.5f}  llf={self.llf:.2f}  "
                f"aic={self.aic:.2f}\n"
                f"params: {np.array2string(self.params, precision=4)}")


def css_loss_fn(y: np.ndarray, p: int, q: int, device):
    """The conditional sum of squares of an ARMA(p, q) on the differenced
    series `y`, as a function of theta = (mu, ar[p], ma[q]) (a float64
    tensor on `device`) built from torch ops, so autograd differentiates
    it.

    The JAX package scans the recursion eps_i = z_i - sum_{j < min(p, i)}
    ar_j z_{i-1-j} - sum_{j < q} ma_j eps_{i-1-j} (z = y - mu, eps_k = 0
    for k < 0). Its AR part is a product of the lagged z with ar; its MA
    part is (I + sum_j ma_j S^{j+1}) eps with S the shift down a row, a
    unit lower-triangular banded Toeplitz matrix: one triangular solve."""
    n = len(y)
    yt = torch.from_numpy(np.asarray(y, dtype=np.float64)).to(device)
    # lagged-index table of the AR part: z[i-1-j], or none where i-1-j < 0
    lag_idx = np.arange(n)[:, None] - 1 - np.arange(p)[None, :]
    lag_ok = torch.from_numpy(lag_idx >= 0).to(device)
    lag_at = torch.from_numpy(np.maximum(lag_idx, 0)).to(device)
    rows = np.concatenate([np.arange(j + 1, n) for j in range(q)]) \
        if q else np.zeros(0, np.int64)
    cols = np.concatenate([np.arange(0, n - j - 1) for j in range(q)]) \
        if q else np.zeros(0, np.int64)
    which = np.concatenate([np.full(n - j - 1, j) for j in range(q)]) \
        if q else np.zeros(0, np.int64)
    band = (torch.from_numpy(rows).to(device),
            torch.from_numpy(cols).to(device))
    which_t = torch.from_numpy(which).to(device)
    eye = torch.eye(n, dtype=torch.float64, device=device) if q else None

    def loss(theta: torch.Tensor) -> torch.Tensor:
        mu, ar, ma = theta[0], theta[1:1 + p], theta[1 + p:1 + p + q]
        z = yt - mu
        a = z
        if p:
            lagged = torch.where(lag_ok, z[lag_at],
                                 torch.zeros((), dtype=z.dtype,
                                             device=z.device))
            a = z - lagged @ ar
        if not q:
            return torch.sum(a * a)
        T = eye.index_put(band, ma[which_t])
        eps = torch.linalg.solve_triangular(T, a[:, None], upper=False,
                                            unitriangular=True)[:, 0]
        return torch.sum(eps * eps)

    return loss


def css_loss_sequential_fn(y: np.ndarray, p: int, q: int, device):
    """The same loss as `css_loss_fn`, forward only, with the innovations
    taken one step after another (n steps of a few ops). Where an
    innovation overflows, this is the form whose loss is the JAX
    package's: the recursion gives inf (or NaN where overflowed MA terms
    of opposite signs meet), where the triangular solve multiplies the
    overflowed values by the matrix's zeros and gives NaN."""
    yt = torch.from_numpy(np.asarray(y, dtype=np.float64)).to(device)
    n = len(yt)
    lag_idx = np.arange(n)[:, None] - 1 - np.arange(p)[None, :]
    lag_ok = torch.from_numpy(lag_idx >= 0).to(device)
    lag_at = torch.from_numpy(np.maximum(lag_idx, 0)).to(device)

    @torch.no_grad()
    def loss(theta: torch.Tensor) -> torch.Tensor:
        mu, ar, ma = theta[0], theta[1:1 + p], theta[1 + p:1 + p + q]
        z = yt - mu
        a = z - torch.where(lag_ok, z[lag_at], 0.0) @ ar if p else z
        # q zeros, then the innovations: eps[q + i] is step i's
        eps = torch.zeros(q + n, dtype=torch.float64, device=yt.device)
        ma_rev = ma.flip(0)
        for i in range(n):
            eps[q + i] = a[i] - (ma_rev * eps[i:i + q]).sum() if q \
                else a[i]
        return torch.sum(eps[q:] * eps[q:])

    return loss


class ARIMA:
    """ARIMA(p, d, q) by conditional sum of squares: scipy's L-BFGS-B on
    the host over a torch loss and its autograd gradient on the session's
    device."""

    def __init__(self, endog, order=(1, 0, 0)):
        self._orig = np.asarray(endog, dtype=np.float64)
        self.order = tuple(order)
        d = self.order[1]
        self._y = np.diff(self._orig, n=d) if d else self._orig

    def fit(self, method: str = "css", **kw) -> ARIMAResults:
        """Fit on the session's device (`sml.device`; without a card it
        raises unless that is "cpu"). `self.evaluations` counts the
        loss-and-gradient evaluations, `self.sequential_evaluations` those
        whose loss overflowed and was taken again step by step."""
        from scipy.optimize import minimize

        from .device import session_device
        device = session_device()
        p, d, q = self.order
        y = self._y
        loss = css_loss_fn(y, p, q, device)
        sequential = css_loss_sequential_fn(y, p, q, device)
        self.evaluations = self.sequential_evaluations = 0

        def fun_and_grad(th):
            self.evaluations += 1
            theta = torch.tensor(th, dtype=torch.float64, device=device,
                                 requires_grad=True)
            f = loss(theta)
            (g,) = torch.autograd.grad(f, theta)
            both = torch.cat([f.detach()[None], g]).cpu().numpy()
            if not np.isfinite(both[0]):
                # an innovation overflowed: the JAX package's recursion
                # gives inf where the solve gives NaN, and L-BFGS-B
                # backtracks from inf but not from NaN. Its gradient there
                # is NaN, as the JAX package's is; the line search does
                # not read it at a non-finite loss
                self.sequential_evaluations += 1
                both[0] = float(sequential(theta.detach()).cpu())
                both[1:] = np.nan
            return float(both[0]), both[1:]

        x0 = np.zeros(1 + p + q)
        x0[0] = float(np.mean(y))
        with PROFILER.span("program.arima", device=str(device)):
            res = minimize(fun_and_grad, x0, jac=True, method="L-BFGS-B")
        css = float(res.fun)
        n = len(y)
        sigma2 = css / n
        llf = -0.5 * n * (np.log(2 * np.pi * sigma2) + 1)
        self._params = res.x
        return ARIMAResults(self, res.x, sigma2, llf)

    # -- prediction helpers ----------------------------------------------
    def _innovations(self, params):
        p, d, q = self.order
        y = self._y
        mu, ar, ma = params[0], params[1:1 + p], params[1 + p:1 + p + q]
        z = y - mu
        eps = np.zeros(len(y))
        for i in range(len(y)):
            ar_part = sum(ar[j] * z[i - 1 - j] for j in range(min(p, i)))
            ma_part = sum(ma[j] * eps[i - 1 - j] for j in range(min(q, i)))
            eps[i] = z[i] - ar_part - ma_part
        return z, eps

    def _fitted_values(self, params) -> np.ndarray:
        z, eps = self._innovations(params)
        fitted_diff = (z - eps) + params[0]
        p, d, q = self.order
        if d == 0:
            return fitted_diff
        # one-step-ahead in levels from the actual history (the
        # statsmodels in-sample predict convention), any d
        from math import comb
        n = len(self._orig)
        hist = np.zeros(n - d)
        for k in range(1, d + 1):
            hist += ((-1) ** (k + 1)) * comb(d, k) * self._orig[d - k:n - k]
        return hist + fitted_diff

    def _forecast(self, params, steps: int) -> np.ndarray:
        p, d, q = self.order
        mu, ar, ma = params[0], params[1:1 + p], params[1 + p:1 + p + q]
        z, eps = self._innovations(params)
        z_hist = list(z)
        eps_hist = list(eps)
        out = []
        for _ in range(steps):
            ar_part = sum(ar[j] * z_hist[-1 - j]
                          for j in range(min(p, len(z_hist))))
            ma_part = sum(ma[j] * eps_hist[-1 - j]
                          for j in range(min(q, len(eps_hist))))
            znew = ar_part + ma_part
            z_hist.append(znew)
            eps_hist.append(0.0)
            out.append(znew + mu)
        out = np.asarray(out)
        if d == 0:
            return out
        # invert one difference at a time, each integration seeded with
        # the last observed value of the next lower difference
        for j in range(d, 0, -1):
            prev = np.diff(self._orig, n=j - 1) if j > 1 else self._orig
            out = prev[-1] + np.cumsum(out)
        return out


def arima_results_from_fitted(endog, order, params, sigma2: float,
                              llf: float) -> ARIMAResults:
    """A fitted ARIMAResults from another fit's `params`, `sigma2` and
    `llf`, its order and the original series."""
    model = ARIMA(endog, order=order)
    model._params = np.asarray(params, dtype=np.float64)
    return ARIMAResults(model, model._params, float(sigma2), float(llf))


# ============================================================ Holt smoothing
class HoltResults:
    def __init__(self, fittedvalues: np.ndarray, level: float, trend: float,
                 params: Dict[str, float], model: "Holt"):
        self.fittedvalues = fittedvalues
        self._level = level
        self._trend = trend
        self.params = params
        self.model = model

    def forecast(self, steps: int) -> np.ndarray:
        phi = self.params.get("damping_trend", 1.0)
        ks = np.arange(1, steps + 1, dtype=np.float64)
        if phi == 1.0:
            mult = ks
        else:
            mult = np.array([sum(phi ** j for j in range(1, k + 1))
                             for k in range(1, steps + 1)])
        return self._level + mult * self._trend


class Holt:
    """Holt's linear (optionally damped/exponential) trend method
    (`MLE 04:367-407`)."""

    def __init__(self, endog, exponential: bool = False, damped: bool = False,
                 damped_trend: Optional[bool] = None):
        self._y = np.asarray(endog, dtype=np.float64)
        self.exponential = exponential
        self.damped = bool(damped if damped_trend is None else damped_trend)

    def fit(self, smoothing_level: Optional[float] = None,
            smoothing_trend: Optional[float] = None,
            damping_trend: Optional[float] = None, optimized: bool = True,
            **kw) -> HoltResults:
        y = np.log(self._y) if self.exponential else self._y

        def run(alpha, beta, phi):
            level, trend = y[0], y[1] - y[0] if len(y) > 1 else 0.0
            fitted = np.zeros(len(y))
            for i in range(len(y)):
                fitted[i] = level + phi * trend
                if i < len(y):
                    err_target = y[i]
                    new_level = alpha * err_target \
                        + (1 - alpha) * (level + phi * trend)
                    new_trend = beta * (new_level - level) \
                        + (1 - beta) * phi * trend
                    level, trend = new_level, new_trend
            sse = float(np.sum((fitted - y) ** 2))
            return fitted, level, trend, sse

        phi = damping_trend if damping_trend is not None else \
            (0.98 if self.damped else 1.0)
        if smoothing_level is not None and smoothing_trend is not None:
            alpha, beta = smoothing_level, smoothing_trend
        else:
            best = (0.5, 0.1, np.inf)
            for alpha in np.linspace(0.05, 0.95, 19):
                for beta in np.linspace(0.05, 0.95, 10):
                    _, _, _, sse = run(alpha, beta, phi)
                    if sse < best[2]:
                        best = (alpha, beta, sse)
            alpha, beta = best[0], best[1]
        fitted, level, trend, sse = run(alpha, beta, phi)
        if self.exponential:
            fitted = np.exp(fitted)
            res = HoltResults(fitted, 0.0, 0.0,
                              {"smoothing_level": alpha,
                               "smoothing_trend": beta,
                               "damping_trend": phi}, self)
            res._level_log, res._trend_log = level, trend

            def fc(steps, _res=res, _phi=phi):
                ks = np.arange(1, steps + 1, dtype=np.float64)
                mult = ks if _phi == 1.0 else np.array(
                    [sum(_phi ** j for j in range(1, k + 1))
                     for k in range(1, steps + 1)])
                return np.exp(_res._level_log + mult * _res._trend_log)

            res.forecast = fc
            return res
        return HoltResults(fitted, level, trend,
                           {"smoothing_level": alpha, "smoothing_trend": beta,
                            "damping_trend": phi}, self)


class SimpleExpSmoothing(Holt):
    def fit(self, smoothing_level: Optional[float] = None, **kw
            ) -> HoltResults:
        return super().fit(smoothing_level=smoothing_level or 0.5,
                           smoothing_trend=1e-9, damping_trend=1.0)


ExponentialSmoothing = Holt
