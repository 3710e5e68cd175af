"""The compact linear routes (`featurizer.CompactParts` and
`linear_impl.fit_linear_compact` / `fit_logistic_compact`) against the
port's materialized route and the JAX package's compact route, on the
CPU: the cases of `tests/test_compact_linear.py` at 8,000 rows, the gate
`sml.linear.compactBytes` flipped per case in each package's conf.

- Against the port's materialized route: the compact Gram is the
  materialized one bit for bit (the expanded [X 1] is the same float64
  matrix), so LinearRegression and elastic net are bit-equal; the
  whole-fit IRLS within atol 5e-4 with accuracy and AUROC within 5e-3
  (measured: equal); a penalized logistic fit takes `expand_host` and
  `fit_logistic`, within atol 1e-5 (measured: equal).
- Against the JAX package's compact route: logistic coefficients within
  atol 5e-4 (measured 2.4e-7), accuracy and AUROC within 5e-3
  (measured: equal); the penalized fit within atol 1e-5. The IRLS step
  counts differ: the port freezes after 7 steps, as its materialized
  IRLS does, while the JAX package's f32 sums and f32 solve keep w
  moving by more than tol, so it runs all 12
  (`test_logistic_compact_steps`). The course chain's one-hot Gram is
  nearly collinear, and the JAX package sums it in f32 where the port
  sums in float64 and rounds once: the linear coefficients differ by up
  to 1.4e-4 (elastic net 1.1e-4, intercepts 9e-3 to 1e-2), beyond rtol /
  atol 1e-5. They are held as `tests/test_torch_linear.py` holds ML
  03's: through the predictions, within 2e-5 of the largest
  |prediction|, and the port's are the closer to a float64 least-squares
  solution on the same block.
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import classification as pcls
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import featurizer as pfz
from sml_tpu_torch.ml import linear_impl as plin
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.utils.profiler import PROFILER

N_ROWS = 8_000
CAT = ["neighbourhood_cleansed", "room_type", "property_type"]
NUM = ["accommodates", "bathrooms", "bedrooms", "beds",
       "minimum_nights", "number_of_reviews", "review_scores_rating"]
ON, OFF = 0, 1 << 40
#: name -> (estimator params, binary label)
CASES = {"linear": ({}, False),
         "enet": ({"regParam": 0.1, "elasticNetParam": 0.5}, False),
         "logistic": ({"maxIter": 12}, True),
         "penalized": ({"maxIter": 8, "regParam": 0.01}, True)}


def _stages(feat, est):
    idx = [c + "_idx" for c in CAT]
    ohe = [c + "_ohe" for c in CAT]
    imp = [c + "_imp" for c in NUM]
    return [feat.Imputer(strategy="median", inputCols=NUM, outputCols=imp),
            feat.StringIndexer(inputCols=CAT, outputCols=idx,
                               handleInvalid="skip"),
            feat.OneHotEncoder(inputCols=idx, outputCols=ohe),
            feat.VectorAssembler(inputCols=ohe + imp, outputCol="features"),
            est]


def _est(lin, logr, name):
    params, binary = CASES[name]
    if binary:
        return logr(labelCol="label", **params)
    return lin(labelCol="price", **params)


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")
    PCONF.unset("sml.linear.compactBytes")


@pytest.fixture(scope="module")
def port_frames():
    cols = make_airbnb_dataset(n=N_ROWS, seed=7)
    binary = dict(cols)
    binary["label"] = (cols["price"] > np.median(cols["price"])).astype(float)
    return (get_session().createDataFrame(cols),
            get_session().createDataFrame(binary))


def _port_fit(frames, name, gate):
    PCONF.set("sml.linear.compactBytes", gate)
    df = frames[1] if CASES[name][1] else frames[0]
    return pbase.Pipeline(stages=_stages(pfeat, _est(
        preg.LinearRegression, pcls.LogisticRegression, name))).fit(df)


@pytest.fixture(scope="module")
def port_runs(port_frames):
    """{name: (materialized model, compact model, compact IRLS steps)}."""
    out = {}
    steps = []
    real = plin.fit_logistic_compact

    def spy(*a, **k):
        res = real(*a, **k)
        steps.append(res.iterations)
        return res

    plin.fit_logistic_compact = spy
    try:
        for name in CASES:
            steps.clear()
            mat = _port_fit(port_frames, name, OFF)
            assert not steps
            comp = _port_fit(port_frames, name, ON)
            out[name] = (mat, comp, list(steps))
    finally:
        plin.fit_logistic_compact = real
    return out


@pytest.fixture(scope="module")
def jax_runs(spark):
    """{name: (compact model, compact IRLS steps)} of the JAX package on
    a one-device mesh."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    from sml_tpu.ml import Pipeline as JP
    from sml_tpu.ml import feature as jfeat
    from sml_tpu.ml import linear_impl as jlin
    from sml_tpu.ml.classification import LogisticRegression as JLogR
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu.parallel import mesh as meshlib
    pdf = jmake(n=N_ROWS, seed=7)
    pdf_bin = pdf.copy()
    pdf_bin["label"] = (pdf_bin["price"]
                        > pdf_bin["price"].median()).astype(float)
    frames = (spark.createDataFrame(pdf), spark.createDataFrame(pdf_bin))
    steps = []
    real = jlin.fit_logistic_compact

    def spy(*a, **k):
        res = real(*a, **k)
        steps.append(res.iterations)
        return res

    old = JCONF.get("sml.linear.compactBytes")
    JCONF.set("sml.linear.compactBytes", ON)
    jlin.fit_logistic_compact = spy
    out = {}
    try:
        with meshlib.use_mesh(meshlib.build_mesh(1)):
            for name in CASES:
                steps.clear()
                df = frames[1] if CASES[name][1] else frames[0]
                model = JP(stages=_stages(jfeat, _est(JLR, JLogR, name))
                           ).fit(df)
                out[name] = (model, list(steps))
    finally:
        jlin.fit_logistic_compact = real
        JCONF.set("sml.linear.compactBytes", old)
    return out


def _coefs(model):
    tail = model.stages[-1]
    return tail.coefficients.toArray(), tail.intercept


@pytest.mark.parametrize("name", ["linear", "enet"])
def test_linear_compact_equals_materialized(port_runs, name):
    mat, comp, _ = port_runs[name]
    c1, i1 = _coefs(mat)
    c2, i2 = _coefs(comp)
    np.testing.assert_array_equal(c1, c2)
    assert i1 == i2
    s1, s2 = mat.stages[-1].summary, comp.stages[-1].summary
    assert s1.rootMeanSquaredError == s2.rootMeanSquaredError
    np.testing.assert_allclose(s1.meanAbsoluteError, s2.meanAbsoluteError,
                               rtol=1e-12)


def test_logistic_compact_matches_materialized(port_runs):
    mat, comp, steps = port_runs["logistic"]
    assert len(steps) == 1  # the whole-fit IRLS ran once
    c1, i1 = _coefs(mat)
    c2, i2 = _coefs(comp)
    np.testing.assert_allclose(c1, c2, atol=5e-4)
    assert abs(i1 - i2) <= 5e-4
    s1, s2 = mat.stages[-1].summary, comp.stages[-1].summary
    assert abs(s1.accuracy - s2.accuracy) < 5e-3
    assert abs(s1.areaUnderROC - s2.areaUnderROC) < 5e-3
    assert s2.totalIterations == steps[0]


def test_penalized_logistic_takes_the_expanded_block(port_runs):
    mat, comp, steps = port_runs["penalized"]
    assert steps == []  # no compact IRLS: expand_host + fit_logistic
    c1, _ = _coefs(mat)
    c2, _ = _coefs(comp)
    np.testing.assert_allclose(c1, c2, atol=1e-5)


def test_logistic_compact_matches_jax_compact(port_runs, jax_runs):
    _, comp, steps = port_runs["logistic"]
    jmodel, jsteps = jax_runs["logistic"]
    c1, i1 = _coefs(comp)
    c2, i2 = _coefs(jmodel)
    np.testing.assert_allclose(c1, c2, atol=5e-4)
    assert abs(i1 - i2) <= 5e-4
    assert len(steps) == len(jsteps) == 1
    s1, s2 = comp.stages[-1].summary, jmodel.stages[-1].summary
    assert abs(s1.accuracy - s2.accuracy) < 5e-3
    assert abs(s1.areaUnderROC - s2.areaUnderROC) < 5e-3


def test_logistic_compact_steps(port_runs, jax_runs):
    """The compact IRLS freezes where the port's materialized IRLS stops
    (7 steps here): both sum in float64 and solve in float64. The JAX
    package's compact fit runs all 12: its f32 sums and f32 solve of a
    Gram of condition number 9.4e7 leave w moving by 5.7e-6 to 1.8e-5 a
    step after step 7, above tol 1e-6 (its materialized fit runs 12 as
    well), so the step counts differ (ROADMAP.md section 3)."""
    mat, _, steps = port_runs["logistic"]
    assert steps == [mat.stages[-1].summary.totalIterations] == [7]
    assert jax_runs["logistic"][1] == [12]


def test_penalized_logistic_matches_jax(port_runs, jax_runs):
    c1, _ = _coefs(port_runs["penalized"][1])
    c2, _ = _coefs(jax_runs["penalized"][0])
    np.testing.assert_allclose(c1, c2, atol=1e-5)


def _expanded(frames):
    """The compact parts of the course chain on the 8,000 rows, their
    labels and the expanded f32 block."""
    from sml_tpu_torch.ml._staging import extract_compact
    PCONF.set("sml.linear.compactBytes", ON)
    stages = _stages(pfeat, preg.LinearRegression(labelCol="price"))
    raw = frames[0]._whole()
    _, shim = pfz.try_fast_fit(stages, raw, lambda: get_session()
                               .createDataFrame(raw, numPartitions=1))
    parts, y = extract_compact(shim, "features", "price")
    return parts, y, parts.expand_host()


@pytest.mark.parametrize("name", ["linear", "enet"])
def test_linear_compact_predictions_match_jax(port_runs, jax_runs,
                                              port_frames, name):
    parts, _, X = _expanded(port_frames)
    c1, i1 = _coefs(port_runs[name][1])
    c2, i2 = _coefs(jax_runs[name][0])
    p1 = X.astype(np.float64) @ c1 + i1
    p2 = X.astype(np.float64) @ c2 + i2
    assert np.max(np.abs(p1 - p2)) <= 2e-5 * np.max(np.abs(p2))


def test_linear_compact_nearer_the_float64_solution(port_runs, jax_runs,
                                                    port_frames):
    """Why the coefficients differ across the packages: on the same f32
    block, the port's fit (float64 sums rounded once) is closer to the
    float64 least-squares solution than the JAX package's (f32 sums)."""
    parts, y, X = _expanded(port_frames)
    Xa = np.concatenate([X.astype(np.float64), np.ones((len(y), 1))], 1)
    ref = np.linalg.lstsq(Xa, y.astype(np.float64), rcond=None)[0]
    pred = Xa @ ref
    errs = []
    for model in (port_runs["linear"][1], jax_runs["linear"][0]):
        c, b = _coefs(model)
        errs.append(np.max(np.abs(Xa @ np.append(c, b) - pred)))
    assert errs[0] < errs[1], errs


def test_compact_gram_equals_the_materialized_gram(port_frames):
    parts, y, X = _expanded(port_frames)
    A1, b1, n1, yy1 = plin.gram_stats_compact(parts, y, device="cpu")
    A2, b2, n2, yy2 = plin.gram_stats(X, y, device="cpu")
    np.testing.assert_array_equal(A1, A2)
    np.testing.assert_array_equal(b1, b2)
    assert (n1, yy1) == (n2, yy2)


def test_compact_route_copies_a_quarter_of_the_bytes(port_frames):
    """What the host copies to the device for one fit: the compact
    block's n * (p + k) words and the labels, against the materialized
    n * d words and the labels."""
    copied = []
    for gate in (OFF, ON):
        before = PROFILER.counters().get("staging.h2d_bytes", 0.0)
        _port_fit(port_frames, "linear", gate)
        copied.append(PROFILER.counters().get("staging.h2d_bytes", 0.0)
                      - before)
    parts, y, X = _expanded(port_frames)
    assert copied[0] == X.nbytes + y.nbytes
    assert copied[1] == parts.num.nbytes + parts.codes.nbytes + y.nbytes
    assert copied[1] * 4 <= copied[0]


@pytest.mark.parametrize("offset, compact", [(0, True), (1, False)])
def test_gate_read_when_fit_is_called(port_frames, offset, compact):
    """The route flips at n * d * 4 >= sml.linear.compactBytes, n the raw
    rows and d the assembled width (49 on the course chain)."""
    raw = port_frames[0]._whole()
    seen = []
    real = plin.fit_linear_compact

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    plin.fit_linear_compact = spy
    try:
        _port_fit(port_frames, "linear", N_ROWS * 49 * 4 + offset)
    finally:
        plin.fit_linear_compact = real
    assert len(raw["price"]) == N_ROWS
    assert bool(seen) is compact


def test_irls_reads_nothing_back_inside_the_loop(port_frames):
    """The whole fit runs with no host read of a device value: every
    route from a tensor to the host raises while the steps run."""
    parts, y, _ = _expanded(port_frames)
    labels = (y > np.median(y)).astype(np.float32)
    num = torch.from_numpy(parts.num)
    codes = torch.from_numpy(parts.codes)
    Xa = plin._expand(num, codes, parts.layout)
    yd = torch.from_numpy(labels).to(torch.float64)
    names = ("item", "cpu", "numpy", "tolist", "__bool__", "__float__",
             "__int__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(*a, **k):
        raise AssertionError("a device value read back inside the loop")

    for n in names:
        setattr(torch.Tensor, n, refuse)
    try:
        w, iters = plin._irls_steps(Xa, yd, 12, 1e-6)
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    assert w.dtype == torch.float32 and 1 <= int(iters) <= 12


def test_spd_solve_matches_numpy():
    rng = np.random.default_rng(3)
    B = rng.normal(size=(30, 30))
    A = B @ B.T + 30 * np.eye(30)
    b = rng.normal(size=30)
    x = plin._solve_spd(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("n", [100, 65_536, 65_537, 200_000])
def test_cross_products_over_row_chunks(n):
    """`_cross` is the plain A.T @ B up to one chunk of rows, bit for bit,
    and within float64 rounding past it (its partials added in chunk
    order)."""
    rng = np.random.default_rng(n)
    A = torch.from_numpy(rng.normal(size=(n, 7)))
    B = torch.from_numpy(rng.normal(size=(n, 3)))
    got = plin._cross(A, B)
    want = A.T @ B
    if n <= plin.GRAM_CHUNK_ROWS:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
