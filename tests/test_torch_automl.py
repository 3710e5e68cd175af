"""The port's AutoML (`sml_tpu_torch.automl`) against the JAX package's,
on the CPU (modelled on tests/test_feature_store_automl.py:82-98).

`regress` and `classify` with `max_trials=3` on the course's columns
(`bedrooms`, `accommodates`, `room_type` and `price`, or a price class)
of `make_airbnb_dataset(n=2000, seed=42)`. The JAX package fits with
`sml.tree.kernel=xla` on a one-device mesh; the port with
`sml.device=cpu`. Both search with TPE from `RandomState(42)`, and the
first trials are its random start-up draws, so the trials have the same
families and parameters exactly. Metrics, by the rules of
tests/test_torch_pipeline.py: a val_rmse within max(1e-3, 1e-5·|rmse|),
and within 1e-3·rmse for a boosted family (the port sums histograms in
float64, the JAX package in f32, and a boosted fit flips near-tied
splits); an AUROC within 1e-6, and 1e-3 for a boosted family. Every
trial is a finished run of the port's store with its params, its metric
and a model that loads through `runs:/` and scores.
"""

import numpy as np
import pandas as pd
import pytest

from sml_tpu import tracking as jt
from sml_tpu_torch import automl as pa
from sml_tpu_torch import tracking as pt
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session

COLS = ["bedrooms", "accommodates", "room_type", "price"]


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


def _block(task):
    d = make_airbnb_dataset(n=2000, seed=42)
    block = {c: d[c] for c in COLS}
    if task == "classify":
        block["price"] = (block["price"] > np.median(block["price"])
                          ).astype(float)
    return block


@pytest.fixture(scope="module", params=["regress", "classify"])
def searches(request, spark, tmp_path_factory):
    """(task, port summary, JAX summary, the port's frame)."""
    from sml_tpu import automl as ja
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.parallel import mesh as meshlib
    task = request.param
    root = str(tmp_path_factory.mktemp("automl") / "runs")
    for m in (pt, jt):
        m.set_tracking_uri(root)
    block = _block(task)
    pdf = get_session().createDataFrame(block)
    port = getattr(pa, task)(pdf, target_col="price", max_trials=3,
                             experiment_name=f"port-{task}")
    prev = JCONF.get("sml.tree.kernel")
    JCONF.set("sml.tree.kernel", "xla")
    try:
        with meshlib.use_mesh(meshlib.build_mesh(1)):
            jax = getattr(ja, task)(
                spark.createDataFrame(pd.DataFrame(block)),
                target_col="price", max_trials=3,
                experiment_name=f"jax-{task}")
    finally:
        JCONF.set("sml.tree.kernel", prev)
    for m in (pt, jt):
        m._active_experiment["id"] = None
    return task, port, jax, pdf


def test_same_families_and_parameters(searches):
    task, port, jax, _ = searches
    assert len(port.trials) == len(jax.trials) == 3
    assert [t.model_description for t in port.trials] == \
        [t.model_description for t in jax.trials]
    for a, b in zip(port.trials, jax.trials):
        assert a.params == b.params


def test_metrics_within_the_pipeline_rules(searches):
    task, port, jax, _ = searches
    key = "val_rmse" if task == "regress" else "val_areaUnderROC"
    for a, b in zip(port.trials, jax.trials):
        got, want = a.metrics[key], b.metrics[key]
        boosted = a.model_description == "gbt"
        if task == "regress":
            tol = 1e-3 * want if boosted else max(1e-3, 1e-5 * abs(want))
        else:
            tol = 1e-3 if boosted else 1e-6
        assert abs(got - want) <= tol, (a.model_description, got, want)
    best = port.best_trial
    pick = min if task == "regress" else max
    assert best.metrics[key] == pick(t.metrics[key] for t in port.trials)


def test_trials_are_runs_with_loadable_models(searches):
    task, port, _, pdf = searches
    key = "val_rmse" if task == "regress" else "val_areaUnderROC"
    exp = pt.MlflowClient().get_experiment(port.experiment.experiment_id)
    assert exp.name == f"port-{task}"
    runs = pt.search_runs(port.experiment.experiment_id,
                          output_format="list")
    assert {r.info.run_id for r in runs} == \
        {t.mlflow_run_id for t in port.trials}
    for t in port.trials:
        run = pt.get_run(t.mlflow_run_id)
        assert run.info.status == "FINISHED"
        assert run.data.tags["mlflow.runName"] == \
            f"trial-{t.model_description}"
        assert run.data.metrics[key] == t.metrics[key]
        assert run.data.params["family"] == t.model_description
    model = pt.spark.load_model(f"runs:/{port.best_trial.mlflow_run_id}"
                                f"/model")
    pred = model.transform(pdf).select("prediction")._whole()["prediction"]
    assert pred.shape == (pdf.count(),) and np.isfinite(pred).all()
    if task == "regress":
        # better than predicting the mean
        assert port.best_trial.metrics[key] < float(np.std(
            _block(task)["price"]))
    assert "n_trials=3" in repr(port)
    assert port.best_trial.notebook_path is None


def test_feature_pipeline_follows_the_schema():
    frame = get_session().createDataFrame(_block("regress"))
    stages = pa._build_feature_pipeline(frame, "price")
    names = [type(s).__name__ for s in stages]
    assert names == ["Imputer", "StringIndexer", "OneHotEncoder",
                     "VectorAssembler"]
    assert stages[0].getOrDefault("inputCols") == ["bedrooms",
                                                   "accommodates"]
    assert stages[-1].getOrDefault("inputCols") == [
        "bedrooms__imp", "accommodates__imp", "room_type__ohe"]
