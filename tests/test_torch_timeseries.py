"""The port's time-series models (MLE 04) against the JAX package's live
ones, on the CPU (`sml.device=cpu`).

- `acf`, `pacf`, `adfuller` and every Holt form are numpy in both
  packages: bit for bit.
- ARIMA's CSS loss and its gradient at fixed parameters: within 1e-10
  relative of the JAX package under `jax.enable_x64()` (measured: 6e-16;
  a gradient element also within 1e-10 of its scale sqrt(n * loss)).
  Fitted parameters: within 1e-6 absolute under x64 (measured: 4e-15);
  against the JAX package's default float32 run within 1e-3 absolute
  (the JAX package's f32 loss moves them; measured: 6.4e-5 on MLE 04's
  ARIMA(1,2,1), 7.6e-4 on the mean of an AR(1) of 400 points). The one
  exception is an ARIMA(1,2,1) of a 120-point quadratic whose MA root
  leaves the unit circle (|ma| = 1.15): the CSS surface is explosive
  there, L-BFGS-B takes ~900 evaluations, and paths that part at the
  1e-16 level stop 7e-3 apart (CSS within 0.7%); it is held to 0.02 in
  the params and 1% in the CSS (`ROADMAP.md` §3).
- Prophet's yhat, bounds, trend and components: within 1e-6 of std(y)
  under x64 (measured up to 2.7e-7, on 900 days with yearly and holiday
  blocks: FISTA's 500 steps on a Gram with a condition number of 6e6 and
  more carry the summation order of the Gram and of its products), and
  within 2e-3 of std(y) against the default f32 run (measured 2.5e-4 on
  the 400-day weekly series, 1.4e-3 on MLE 04's 160 days).
- On parameters carried across from the JAX package's fits, `predict`,
  `forecast` and `fittedvalues` are exact.
"""

import numpy as np
import pandas as pd
import pytest

from sml_tpu_torch import timeseries as P
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF

X64_ARIMA_RTOL = 1e-10
X64_PARAM_ATOL = 1e-6
F32_PARAM_ATOL = 1e-3
X64_PROPHET_TOL = 1e-6
F32_PROPHET_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


def _jax():
    from sml_tpu import timeseries as J
    return J


def mle04_series():
    t = np.arange(160, dtype=float)
    rng = np.random.default_rng(42)
    return 0.02 * t * t + 1.5 * t + 20 + rng.normal(scale=1.0, size=len(t))


def _series():
    rng = np.random.default_rng(1)
    stationary = rng.normal(0, 1, 500)
    walk = np.cumsum(rng.normal(0, 1, 500))
    ar = np.zeros(1000)
    for i in range(1, 1000):
        ar[i] = 0.7 * ar[i - 1] + rng.normal()
    rng2 = np.random.default_rng(2)
    ar1 = np.zeros(400)
    for i in range(1, 400):
        ar1[i] = 0.6 * ar1[i - 1] + rng2.normal(0, 1)
    rng3 = np.random.default_rng(3)
    drift = np.cumsum(0.5 + rng3.normal(0, 0.3, 300))
    t = np.arange(120, dtype=float)
    quad = 0.05 * t * t + 2 * t + 10 + np.random.default_rng(0).normal(
        scale=0.5, size=len(t))
    y80 = np.cumsum(1.0 + np.random.default_rng(1).normal(scale=0.3,
                                                          size=80)) + 5
    return {"stationary": stationary, "walk": walk, "ar": ar, "ar1": ar1,
            "drift": drift, "quad": quad, "y80": y80, "mle04": mle04_series()}


SERIES = _series()


# -------------------------------------------------- numpy tools, bit for bit
@pytest.mark.parametrize("name", sorted(SERIES))
def test_acf_pacf_adfuller_bit_equal(name):
    J = _jax()
    x = SERIES[name]
    for nlags in (5, 10, 40):
        np.testing.assert_array_equal(P.acf(x, nlags), J.acf(x, nlags))
        np.testing.assert_array_equal(P.pacf(x, nlags), J.pacf(x, nlags))
    for kw in ({}, {"regression": "ct"}, {"maxlag": 3}):
        got, want = P.adfuller(x, **kw), J.adfuller(x, **kw)
        assert got[:5] == want[:5] and np.isnan(got[5]) and np.isnan(want[5])


HOLT = {
    "holt": (lambda m, y: m.Holt(y).fit(), 10),
    "damped": (lambda m, y: m.Holt(y, damped=True).fit(), 10),
    "damped_0.8": (lambda m, y: m.Holt(y, damped=True)
                   .fit(damping_trend=0.8), 10),
    "damped_trend_kw": (lambda m, y: m.Holt(y, damped_trend=True)
                        .fit(smoothing_level=0.4, smoothing_trend=0.2), 7),
    "exponential": (lambda m, y: m.Holt(np.abs(y) + 1.0, exponential=True)
                    .fit(), 10),
    "exponential_damped": (lambda m, y: m.ExponentialSmoothing(
        np.abs(y) + 1.0, exponential=True, damped=True).fit(), 5),
    "ses": (lambda m, y: m.SimpleExpSmoothing(y).fit(), 5),
    "ses_0.3": (lambda m, y: m.SimpleExpSmoothing(y)
                .fit(smoothing_level=0.3), 5),
}


@pytest.mark.parametrize("form", list(HOLT))
@pytest.mark.parametrize("name", ["mle04", "drift", "line"])
def test_holt_forms_bit_equal(form, name):
    J = _jax()
    y = 3.0 + 2.0 * np.arange(100.0) if name == "line" else SERIES[name]
    fit, steps = HOLT[form]
    got, want = fit(P, y), fit(J, y)
    np.testing.assert_array_equal(got.fittedvalues, want.fittedvalues)
    assert got.params == want.params
    np.testing.assert_array_equal(got.forecast(steps), want.forecast(steps))


# ------------------------------------------------------------------ ARIMA
LOSS_CASES = [("mle04", (1, 2, 1)), ("ar1", (1, 0, 0)), ("drift", (0, 1, 1)),
              ("quad", (2, 1, 2)), ("y80", (0, 0, 0)), ("walk", (0, 0, 1)),
              ("ar", (3, 0, 2))]


@pytest.mark.parametrize("name, order", LOSS_CASES)
def test_css_loss_and_gradient_match_jax_x64(name, order):
    import jax
    import jax.numpy as jnp
    import torch
    J = _jax()
    y = SERIES[name]
    p, d, q = order
    rng = np.random.default_rng(p * 7 + q)
    for theta in (np.r_[np.mean(np.diff(y, n=d) if d else y),
                        np.zeros(p + q)],
                  rng.uniform(-0.6, 0.6, 1 + p + q)):
        with jax.enable_x64():
            loss, _ = J.ARIMA(y, order=order)._css_loss()
            want = float(loss(jnp.asarray(theta)))
            want_g = np.asarray(jax.grad(loss)(jnp.asarray(theta)))
        args = (np.diff(y, n=d) if d else y, p, q, torch.device("cpu"))
        th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
        f = P.css_loss_fn(*args)(th)
        (g,) = torch.autograd.grad(f, th)
        assert abs(float(f) - want) <= X64_ARIMA_RTOL * abs(want)
        # a gradient element is a sum of n products of innovations: its
        # scale is sqrt(n * loss), and at a stationary point (mu at the
        # mean, no AR or MA) it is rounding noise on that scale
        scale = np.sqrt(len(y) * want)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=X64_ARIMA_RTOL,
                                   atol=X64_ARIMA_RTOL * scale)
        seq = float(P.css_loss_sequential_fn(*args)(th.detach()))
        assert abs(seq - want) <= X64_ARIMA_RTOL * abs(want)


def _page_views(n=800, seed=0):
    """A daily series shaped as Prophet's quick start (`chip_smoke.py`'s
    `ts_quickstart`: a random-walk level, weekly and yearly terms, bumps
    on January Sundays, noise, on the log scale), whose ARIMA(1,1,1) line
    search overflows once."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=float)
    day = np.datetime64("2007-12-10") + np.arange(n)
    jan = (day.astype("datetime64[M]").astype(np.int64) % 12 == 0) & \
        ((day.astype(np.int64) + 3) % 7 == 6)
    return (8.0 + np.cumsum(rng.normal(0, 0.03, n))
            + 0.25 * np.sin(2 * np.pi * t / 7)
            + 0.1 * np.cos(4 * np.pi * t / 7)
            + 0.6 * np.sin(2 * np.pi * t / 365.25)
            + 0.3 * np.cos(2 * np.pi * t / 365.25)
            + 1.2 * jan + rng.normal(0, 0.05, n))


def test_an_overflowed_evaluation_keeps_the_jax_packages_path():
    """The overflowed evaluation gives the JAX package's inf (the solve
    alone gives NaN, from which L-BFGS-B does not backtrack), so the fit
    follows the JAX package's path."""
    import jax
    J = _jax()
    y = _page_views()
    model = P.ARIMA(y, order=(1, 1, 1))
    got = model.fit()
    assert model.sequential_evaluations >= 1
    with jax.enable_x64():
        want = J.ARIMA(y, order=(1, 1, 1)).fit()
    np.testing.assert_allclose(got.params, want.params, rtol=0,
                               atol=X64_PARAM_ATOL)


def _lbfgsb_over_the_solve(y, order, at_overflow):
    """scipy's L-BFGS-B over `css_loss_fn` (the port's fit without its
    overflow handling), with `at_overflow(theta, loss, grad)` giving the
    (loss, grad) handed over where the solve's loss is not finite:
    (params, evaluations, non-finite evaluations)."""
    import torch
    from scipy.optimize import minimize
    p, d, q = order
    diffed = np.diff(y, n=d) if d else y
    loss = P.css_loss_fn(diffed, p, q, torch.device("cpu"))
    seen = [0, 0]

    def fun_and_grad(th):
        seen[0] += 1
        theta = torch.tensor(th, dtype=torch.float64, requires_grad=True)
        f = loss(theta)
        (g,) = torch.autograd.grad(f, theta)
        f, g = float(f), g.numpy().copy()
        if not np.isfinite(f):
            seen[1] += 1
            f, g = at_overflow(theta.detach(), f, g)
        return f, g

    x0 = np.zeros(1 + p + q)
    x0[0] = float(np.mean(diffed))
    res = minimize(fun_and_grad, x0, jac=True, method="L-BFGS-B")
    return res.x, seen[0], seen[1]


def test_lbfgsb_backtracks_from_an_inf_loss_without_reading_its_gradient():
    """What the overflow handling rests on: handed the JAX package's inf,
    L-BFGS-B takes the same path whatever the gradient is (NaN or zeros),
    and it is the port's fit; handed the solve's NaN it does not
    backtrack, and the path changes (on the CPU, 17 evaluations became
    51, 36 of them non-finite)."""
    import torch
    y = _page_views(600, 0)
    steps = P.css_loss_sequential_fn(np.diff(y), 1, 1, torch.device("cpu"))

    def inf_and(grad):
        return lambda th, f, g: (float(steps(th)), np.full_like(g, grad))
    nan_grad = _lbfgsb_over_the_solve(y, (1, 1, 1), inf_and(np.nan))
    zero_grad = _lbfgsb_over_the_solve(y, (1, 1, 1), inf_and(0.0))
    nan_loss = _lbfgsb_over_the_solve(y, (1, 1, 1), lambda th, f, g: (f, g))
    np.testing.assert_array_equal(nan_grad[0], zero_grad[0])
    assert nan_grad[1:] == zero_grad[1:] and nan_grad[2] >= 1
    model = P.ARIMA(y, order=(1, 1, 1))
    np.testing.assert_array_equal(model.fit().params, nan_grad[0])
    assert (model.evaluations, model.sequential_evaluations) == nan_grad[1:]
    assert nan_loss[2] > nan_grad[2] and nan_loss[1] > nan_grad[1]


def test_an_overflowing_loss_is_the_jax_packages_inf():
    import jax
    import jax.numpy as jnp
    import torch
    J = _jax()
    y = SERIES["quad"]
    theta = np.array([5.05e6, -0.557, 5.95e5])
    with jax.enable_x64():
        loss, _ = J.ARIMA(y, order=(1, 2, 1))._css_loss()
        want = float(loss(jnp.asarray(theta)))
    args = (np.diff(y, n=2), 1, 1, torch.device("cpu"))
    th = torch.tensor(theta, dtype=torch.float64)
    assert want == np.inf
    assert float(P.css_loss_sequential_fn(*args)(th)) == np.inf
    assert np.isnan(float(P.css_loss_fn(*args)(th)))


FIT_CASES = [("mle04", (1, 2, 1)), ("ar1", (1, 0, 0)), ("drift", (0, 1, 1)),
             ("y80", (1, 1, 0))]


@pytest.mark.parametrize("name, order", FIT_CASES)
def test_arima_fit_matches_jax(name, order):
    import jax
    J = _jax()
    y = SERIES[name]
    model = P.ARIMA(y, order=order)
    got = model.fit()
    assert model.evaluations > 0
    with jax.enable_x64():
        want = J.ARIMA(y, order=order).fit()
    np.testing.assert_allclose(got.params, want.params, rtol=0,
                               atol=X64_PARAM_ATOL)
    for a in ("sigma2", "llf", "aic"):
        assert getattr(got, a) == pytest.approx(getattr(want, a), rel=1e-9)
    np.testing.assert_allclose(got.forecast(10), want.forecast(10),
                               rtol=1e-6, atol=1e-6)
    f32 = J.ARIMA(y, order=order).fit()
    np.testing.assert_allclose(got.params, f32.params, rtol=0,
                               atol=F32_PARAM_ATOL)


def test_arima_with_an_explosive_ma_root_stays_near_jax():
    import jax
    J = _jax()
    y = SERIES["quad"]
    model = P.ARIMA(y, order=(1, 2, 1))
    got = model.fit()
    with jax.enable_x64():
        want = J.ARIMA(y, order=(1, 2, 1)).fit()
    assert abs(want.params[2]) > 1 and abs(got.params[2]) > 1
    assert model.sequential_evaluations > 0  # overflowed line searches
    np.testing.assert_allclose(got.params, want.params, rtol=0, atol=0.02)
    assert got.sigma2 == pytest.approx(want.sigma2, rel=1e-2)


@pytest.mark.parametrize("name, order", FIT_CASES + [("quad", (1, 2, 1))])
def test_arima_on_carried_parameters_is_exact(name, order):
    J = _jax()
    y = SERIES[name]
    want = J.ARIMA(y, order=order).fit()
    got = P.arima_results_from_fitted(y, order, want.params, want.sigma2,
                                      want.llf)
    np.testing.assert_array_equal(got.forecast(12), want.forecast(12))
    np.testing.assert_array_equal(got.fittedvalues, want.fittedvalues)
    np.testing.assert_array_equal(got.predict(), want.predict())
    assert got.aic == want.aic
    assert got.summary() == want.summary()


# ---------------------------------------------------------------- Prophet
def _daily(n, seed, start="2020-01-01"):
    rng = np.random.default_rng(seed)
    ds = pd.date_range(start, periods=n, freq="D")
    y = np.linspace(10, 30, n) + 3 * np.sin(2 * np.pi * np.arange(n) / 7) \
        + rng.normal(0, 0.5, n)
    return pd.DataFrame({"ds": ds, "y": y})


def _decomposition():
    n = 400
    ds = pd.date_range("2020-01-01", periods=n, freq="D")
    t = np.arange(n, dtype=float)
    y = (10 + 0.20 * np.minimum(t, 200) + 0.05 * np.maximum(t - 200, 0)
         + 3.0 * np.sin(2 * np.pi * t / 7.0)
         + np.random.default_rng(7).normal(0, 0.15, n))
    return pd.DataFrame({"ds": ds, "y": y})


HOLIDAYS = pd.DataFrame({"ds": pd.to_datetime(
    ["2020-12-25", "2021-12-25", "2021-01-01", "2022-01-01"])})
PROPHETS = {
    "weekly_400": (dict(weekly_seasonality=True, yearly_seasonality=False),
                   lambda: _daily(400, 0)),
    "mle04_160": ({}, lambda: pd.DataFrame({
        "ds": pd.date_range("2020-01-01", periods=160, freq="D"),
        "y": mle04_series()})),
    "yearly_holidays_900": (dict(holidays=HOLIDAYS), lambda: _daily(900, 2)),
    "decomposition": (dict(weekly_seasonality=True,
                           yearly_seasonality=False,
                           daily_seasonality=False), _decomposition),
    "shuffled_daily_on": (dict(daily_seasonality=True,
                               changepoint_prior_scale=0.5),
                          lambda: _daily(200, 3).sample(
                              frac=1.0, random_state=0)),
}


def _port_holidays(kw):
    if "holidays" in kw:
        return dict(kw, holidays={"ds": kw["holidays"]["ds"].to_numpy()})
    return kw


def _assert_forecasts_close(got, want, scale, tol):
    got = got.toPandas()
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got["ds"].to_numpy(),
                                  want["ds"].to_numpy())
    for c in want.columns[1:]:
        err = np.max(np.abs(got[c].to_numpy() - want[c].to_numpy()))
        assert err <= tol * scale, (c, err / scale)


@pytest.mark.parametrize("case", list(PROPHETS))
def test_prophet_matches_jax(case):
    import jax
    J = _jax()
    kw, make = PROPHETS[case]
    df = make()
    scale = float(np.std(df["y"].to_numpy()))
    with jax.enable_x64():
        mj = J.Prophet(**kw).fit(df)
        want = mj.predict(mj.make_future_dataframe(periods=30))
    mf = J.Prophet(**kw).fit(df)
    want32 = mf.predict(mf.make_future_dataframe(periods=30))
    mp = P.Prophet(**_port_holidays(kw)).fit(
        {"ds": df["ds"].to_numpy(), "y": df["y"].to_numpy()})
    got = mp.predict(mp.make_future_dataframe(periods=30))
    assert mp._block_names == mj._block_names
    np.testing.assert_array_equal(mp.changepoints,
                                  mj.changepoints.to_numpy())
    _assert_forecasts_close(got, want, scale, X64_PROPHET_TOL)
    _assert_forecasts_close(got, want32, scale, F32_PROPHET_TOL)
    insample = mp.predict()
    _assert_forecasts_close(insample, mj.predict(), scale, X64_PROPHET_TOL)


def test_prophet_takes_the_ports_frame_a_dict_and_a_pandas_frame():
    from sml_tpu_torch.frame.session import get_session
    df = _daily(120, 4)
    block = {"ds": df["ds"].to_numpy(), "y": df["y"].to_numpy()}
    outs = [P.Prophet().fit(src).predict().toPandas() for src in
            (df, block, get_session().createDataFrame(block))]
    for other in outs[1:]:
        pd.testing.assert_frame_equal(other, outs[0])


@pytest.mark.parametrize("case", list(PROPHETS))
def test_prophet_on_carried_parameters_is_exact(case):
    J = _jax()
    kw, make = PROPHETS[case]
    df = make()
    mj = J.Prophet(**kw).fit(df)
    mp = P.prophet_from_fitted(
        mj._w, mj._cps, mj._t_start.to_datetime64(),
        mj._t_end.to_datetime64(), mj._y_mean, mj._y_scale, mj._sigma,
        mj._block_names, mj._n_trend,
        {"ds": df["ds"].to_numpy(), "y": df["y"].to_numpy()},
        **_port_holidays(kw))
    for future in (mj.make_future_dataframe(periods=45),
                   mj.make_future_dataframe(periods=10,
                                            include_history=False)):
        want = mj.predict(future)
        got = mp.predict({"ds": future["ds"].to_numpy()}).toPandas()
        assert list(got.columns) == list(want.columns)
        for c in want.columns:
            np.testing.assert_array_equal(got[c].to_numpy(),
                                          want[c].to_numpy(), err_msg=c)
    pf = mp.make_future_dataframe(periods=45).toPandas()
    np.testing.assert_array_equal(
        pf["ds"].to_numpy(),
        mj.make_future_dataframe(periods=45)["ds"].to_numpy())


@pytest.mark.parametrize("freq", ["D", "h", "min", "s", "W", "MS", "ME"])
@pytest.mark.parametrize("last", ["2020-01-15", "2020-02-29 10:30:00",
                                  "2021-01-31", "2021-08-01", "2022-05-08"])
def test_future_dates_match_pandas_date_range(freq, last):
    want = pd.date_range(pd.Timestamp(last), periods=13, freq=freq)[1:]
    got = P.date_range_after(np.datetime64(last), 12, freq)
    np.testing.assert_array_equal(got, want.to_numpy()
                                  .astype("datetime64[us]"))


def test_unsupported_frequencies_raise():
    for freq in ("H", "Q", "YS", "B"):
        with pytest.raises(NotImplementedError, match="freq"):
            P.date_range_after(np.datetime64("2020-01-01"), 3, freq)


def test_plots_draw():
    m = P.Prophet(weekly_seasonality=True).fit(_daily(60, 5))
    fc = m.predict(m.make_future_dataframe(periods=5))
    assert m.plot(fc) is not None
    assert m.plot_components(fc) is not None
