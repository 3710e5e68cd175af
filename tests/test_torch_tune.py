"""The port's hyperopt surface (`sml_tpu_torch/tune/`) against the JAX
package's live one (`sml_tpu.tune`), on the CPU.

- Every `hp` dimension samples, maps to the unit interval and back as
  the JAX package's does under the same `np.random.RandomState`, value
  for value.
- `fmin` with `tpe` (past its 10 startup trials) and `rand` over a numpy
  objective gives the JAX package's trial history bit for bit at
  `max_evals=30`, with `Trials` and with `SparkTrials(parallelism=3)`.
  The objective is pure numpy, so each generation's trials finish in
  the order they were proposed in the JAX package too (the port records
  them in that order whatever the threads do).
- A `score_batch` that returns None sends its generation to the
  per-trial path (the same history); one that raises propagates; an
  objective that raises is a `STATUS_FAIL` trial.
- `fmin` over the port's random forest with a `score_batch` over
  `fused_param_scores` gives the per-trial history, in a fraction of the
  fits.
"""

import numpy as np
import pytest

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.tune import (STATUS_FAIL, STATUS_OK, SparkTrials,
                                Trials, fmin, hp, rand, space_eval, tpe)
from sml_tpu_torch.tune import _space as pspace


@pytest.fixture()
def port_cpu():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


DIMS = [("uniform", (-2.0, 3.0)), ("quniform", (2, 9, 1)),
        ("loguniform", (-3.0, 1.0)), ("qloguniform", (0.0, 4.0, 2)),
        ("normal", (1.0, 2.0)), ("qnormal", (0.0, 3.0, 0.5)),
        ("lognormal", (0.0, 0.7)), ("choice", (["a", "b", "c", "d"],)),
        ("randint", (5,))]


@pytest.mark.parametrize("kind, args", DIMS, ids=[d[0] for d in DIMS])
def test_dimension_draws_and_unit_maps_equal_jax(kind, args):
    from sml_tpu.tune import hp as jhp
    jd = getattr(jhp, kind)("x", *args)
    pd_ = getattr(hp, kind)("x", *args)
    rj, rp = np.random.RandomState(7), np.random.RandomState(7)
    sj = [jd.sample(rj) for _ in range(64)]
    sp = [pd_.sample(rp) for _ in range(64)]
    assert sp == sj
    assert rp.get_state()[1].tolist() == rj.get_state()[1].tolist()
    assert [pd_.to_unit(v) for v in sp] == [jd.to_unit(v) for v in sj]
    grid = np.linspace(0.0, 1.0, 41)
    assert [pd_.from_unit(u) for u in grid] == \
        [jd.from_unit(u) for u in grid]


def _space(h):
    return {"x": h.uniform("x", -3.0, 3.0),
            "depth": h.quniform("depth", 2, 8, 1),
            "lr": h.loguniform("lr", -4.0, 0.0),
            "kind": h.choice("kind", ["gini", "entropy", "mse"])}


def _objective(params):
    """A numpy loss with a plateau in `depth` and a categorical effect."""
    bias = {"gini": 0.3, "entropy": 0.0, "mse": 0.7}[params["kind"]]
    return float((params["x"] - 1.25) ** 2 + 0.1 * abs(params["depth"] - 5)
                 + (np.log(params["lr"]) + 2.0) ** 2 / 10 + bias)


def _history(trials):
    return [({k: v[0] for k, v in t["misc"]["vals"].items()},
             t["result"].get("loss"), t["result"]["status"])
            for t in trials.trials]


def _run_jax(algo_name, parallel):
    from sml_tpu import tune as jt
    trials = jt.SparkTrials(parallelism=3) if parallel else jt.Trials()
    best = jt.fmin(_objective, _space(jt.hp),
                   algo=getattr(jt, algo_name), max_evals=30,
                   trials=trials, rstate=np.random.RandomState(11))
    return best, _history(trials)


def _run_port(algo, parallel, objective=_objective, max_evals=30):
    trials = SparkTrials(parallelism=3) if parallel else Trials()
    best = fmin(objective, _space(hp), algo=algo, max_evals=max_evals,
                trials=trials, rstate=np.random.RandomState(11))
    return best, _history(trials)


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["Trials", "SparkTrials3"])
@pytest.mark.parametrize("algo_name", ["tpe", "rand"])
def test_fmin_history_equals_jax(spark, port_cpu, algo_name, parallel):
    want_best, want = _run_jax(algo_name, parallel)
    best, got = _run_port({"tpe": tpe, "rand": rand}[algo_name], parallel)
    assert len(got) == 30
    assert got == want
    assert best == want_best
    assert all(s == STATUS_OK for _, _, s in got)


def test_score_batch_none_declines_to_per_trial(port_cpu):
    calls = []

    def objective(params):
        return _objective(params)

    def score_batch(values):
        calls.append(len(values))
        return None

    objective.score_batch = score_batch
    PCONF.set("sml.tune.candidatesPerDispatch", 3)
    try:
        _, got = _run_port(tpe, False, objective, max_evals=14)
        # the same generations of 3, scored one by one
        plain = lambda p: _objective(p)  # noqa: E731
        plain.score_batch = lambda values: [_objective(v) for v in values]
        _, want = _run_port(tpe, False, plain, max_evals=14)
    finally:
        PCONF.unset("sml.tune.candidatesPerDispatch")
    assert calls == [3, 3, 3, 3, 2]
    assert got == want


def test_score_batch_error_propagates(port_cpu):
    def objective(params):
        return _objective(params)

    def score_batch(values):
        raise RuntimeError("fused scoring failed")

    objective.score_batch = score_batch
    with pytest.raises(RuntimeError, match="fused scoring failed"):
        _run_port(tpe, False, objective, max_evals=6)


def test_objective_error_is_a_failed_trial(port_cpu):
    def objective(params):
        if params["kind"] == "mse":
            raise ValueError("bad kind")
        return _objective(params)

    _, got = _run_port(rand, True, objective, max_evals=12)
    failed = [s for p, _, s in got if p["kind"] == 2]
    assert failed and all(s == STATUS_FAIL for s in failed)
    assert all(s == STATUS_OK for p, _, s in got if p["kind"] != 2)


def test_space_eval_resolves_choices():
    space = _space(hp)
    assert space_eval(space, {"x": 0.5, "depth": 3.0, "lr": 0.1,
                              "kind": 1})["kind"] == "entropy"
    assert isinstance(space["kind"], pspace.Choice)


def test_fmin_over_forest_score_batch_gives_per_trial_history(port_cpu):
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import RandomForestRegressor
    from sml_tpu_torch.ml.tuning import fused_param_scores
    from sml_tpu_torch.utils.profiler import PROFILER
    rng = np.random.default_rng(3)
    n = 2000
    cols = {f"f{i}": rng.normal(size=n) for i in range(4)}
    cols["label"] = np.round((cols["f0"] * 2 - cols["f1"] ** 2
                              + rng.normal(0, 0.3, n)) * 8) / 8
    df = VectorAssembler(inputCols=[f"f{i}" for i in range(4)],
                         outputCol="features").transform(
        get_session().createDataFrame(cols))
    train, val = df.randomSplit([0.8, 0.2], seed=42)
    train.cache()
    val.cache()
    rf = RandomForestRegressor(labelCol="label", maxBins=16, seed=5)
    ev = RegressionEvaluator(labelCol="label")
    space = {"max_depth": hp.quniform("max_depth", 2, 5, 1),
             "num_trees": hp.quniform("num_trees", 3, 9, 3)}

    def pmap(v):
        return {rf.getParam("maxDepth"): int(v["max_depth"]),
                rf.getParam("numTrees"): int(v["num_trees"])}

    def run(batched):
        def objective(params):
            return ev.evaluate(rf.copy(pmap(params)).fit(train)
                               .transform(val))
        if batched:
            objective.score_batch = lambda values: fused_param_scores(
                rf, [pmap(v) for v in values], train, val, ev)
        trials = Trials()
        before = PROFILER.counters().get("tree.fit_dispatch", 0.0)
        PCONF.set("sml.tune.candidatesPerDispatch", 4)
        try:
            fmin(objective, space, algo=tpe, max_evals=8, trials=trials,
                 rstate=np.random.RandomState(3))
        finally:
            PCONF.unset("sml.tune.candidatesPerDispatch")
        fits = PROFILER.counters().get("tree.fit_dispatch", 0.0) - before
        return _history(trials), fits

    fused, fused_fits = run(True)
    one_by_one, fits = run(False)
    assert fused == one_by_one
    assert fused_fits == 2 and fits == 8
