"""The port's tracking and model registry (`sml_tpu_torch.tracking`)
against the JAX package's, on the CPU (modelled on tests/test_tracking.py
and the registry cases of tests/test_serving.py).

Both packages point at the same store directory in each test, so every
round trip reads what the other package wrote:

- runs, params, metrics (latest and history), tags, nested runs,
  artifacts; `search_runs` under a filter and an `order_by`: the port's
  DataFrame holds the JAX package's pandas frame column for column and
  row for row (NULL where a run lacks a key);
- the registry: versions, stages, `resolve_stage`, the archive order
  and listener hygiene, written by either package and read by the other;
- the flavors: a forest pipeline the port logs, loaded and transformed
  by the JAX package, within the rule of tests/test_torch_inference.py
  (rtol 1e-5, atol 1e-5 of the largest |prediction|: the f32 sums over
  trees run in another order); a linear pipeline within the rule of
  tests/test_torch_linear.py (2e-5 of the largest |prediction|); pyfunc
  and `spark_udf` on a port frame to the same rules; a pickled model
  with a `predict` either way, exactly;
- `input_example.json` in pandas' `orient="split"` layout (the JAX
  package writes it with pandas, which keeps 10 significant digits:
  values within rtol 1e-9);
- `infer_signature` of a port frame, a mapping and an array.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from sml_tpu import tracking as jt
from sml_tpu.tracking import _store as jstore
from sml_tpu.utils.profiler import PROFILER as JPROF
from sml_tpu_torch import tracking as pt
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.frame.dataframe import DataFrame as PFrame
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.tracking import _store as pstore
from sml_tpu_torch.utils.profiler import PROFILER as PPROF

RTOL = 1e-5
LINEAR_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


@pytest.fixture(autouse=True)
def stores(tmp_path):
    root = str(tmp_path / "runs")
    for m in (pt, jt):
        m.set_tracking_uri(root)
        m._active_experiment["id"] = None
    yield root
    for m in (pt, jt):
        while m.active_run():
            m.end_run()
        m._active_experiment["id"] = None


class Doubler:
    """A pickled (sklearn-flavor) model: any object with a `predict`."""

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        return 2.0 * X.sum(axis=1) + 1.0


def _block(n=400, seed=0):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=n), rng.normal(size=n)
    return {"a": a, "b": b, "c": rng.integers(0, 4, n).astype(float),
            "y": 2.0 * a - b + rng.normal(0, 0.1, n)}


def _frames(spark, block):
    return get_session().createDataFrame(block), \
        spark.createDataFrame(pd.DataFrame(block))


def _column(frame, name):
    return frame.select(name)._whole()[name]


def _log_runs(m, exp_name):
    """Three runs with params, metrics and tags, one without a tag."""
    exp = m.set_experiment(exp_name)
    for i, rmse in enumerate([3.0, 1.0, 2.0]):
        with m.start_run(run_name=f"r{i}"):
            m.log_param("data_version", str(i))
            m.log_metric("rmse", rmse)
            if i != 1:
                m.set_tag("team", "blue" if i else "red")
    return exp.experiment_id


# ------------------------------------------------------------- runs
def test_run_lifecycle_params_metrics_and_history():
    with pt.start_run(run_name="LR-Single-Feature") as run:
        pt.log_param("label", "price")
        pt.log_metric("rmse", 123.4)
        pt.log_metric("rmse", 120.0)
        pt.log_metrics({"r2": 0.5}, step=3)
    rec = pt.get_run(run.info.run_id)
    assert rec.data.params["label"] == "price"
    assert rec.data.metrics == {"rmse": 120.0, "r2": 0.5}
    assert rec.info.status == "FINISHED"
    assert rec.data.tags["mlflow.runName"] == "LR-Single-Feature"
    # the JAX package reads the same run, history and all
    jrec = jt.get_run(run.info.run_id)
    assert jrec.data.metrics == rec.data.metrics
    hist = jstore.read_run(jstore.find_run(run.info.run_id))
    assert [h["value"] for h in hist["metrics_history"]["rmse"]] == \
        [123.4, 120.0]
    assert hist["metrics_history"]["r2"][0]["step"] == 3


def test_failed_run_and_nested_runs():
    with pt.start_run(run_name="parent") as parent:
        with pt.start_run(run_name="child", nested=True) as child:
            pt.log_metric("mse", 1.0)
        with pytest.raises(RuntimeError):
            pt.start_run()
    with pytest.raises(ValueError):
        with pt.start_run() as failed:
            raise ValueError("boom")
    assert jt.get_run(child.info.run_id).data.tags["mlflow.parentRunId"] \
        == parent.info.run_id
    assert jt.get_run(failed.info.run_id).info.status == "FAILED"
    assert pt.active_run() is None


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("query", [
    dict(order_by=["metrics.rmse ASC"]),
    dict(order_by=["params.data_version DESC"]),
    dict(filter_string="params.data_version='1'"),
    dict(filter_string="params.data_version='1' and metrics.rmse<2"),
    dict(filter_string="metrics.rmse >= 2", order_by=["metrics.rmse DESC"]),
    dict(filter_string="tags.team LIKE '%lu%'"),
    dict(filter_string="attributes.status = 'FINISHED'",
         order_by=["attributes.start_time ASC"]),
    dict(filter_string="metrics.rmse > 99"),
])
def test_search_runs_frame_matches_the_jax_packages_pandas(writer, query):
    exp_id = _log_runs(jt if writer == "jax" else pt, "search-test")
    want = jt.search_runs(exp_id, **query)
    got = pt.search_runs(exp_id, **query)
    assert isinstance(got, PFrame)
    if want.empty:
        assert got.count() == 0
        return
    assert got.columns == list(want.columns)
    block = got._whole()
    for c in want.columns:
        w = want[c].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(block[c], w)
        else:
            assert list(block[c]) == [None if v is None or v != v else v
                                      for v in w], c
    runs = pt.search_runs(exp_id, output_format="list", **query)
    assert [r.info.run_id for r in runs] == list(want["run_id"])
    client = pt.MlflowClient().search_runs(
        exp_id, query.get("filter_string"), query.get("order_by"))
    assert [r.info.run_id for r in client] == list(want["run_id"])


def test_search_runs_rejects_a_bad_filter():
    exp_id = _log_runs(pt, "bad-filter")
    with pytest.raises(ValueError, match="cannot parse"):
        pt.search_runs(exp_id, filter_string="rmse < 2")


def test_artifacts_text_dict_and_client_listing(tmp_path):
    f = tmp_path / "note.txt"
    f.write_text("hello")
    d = tmp_path / "dir"
    d.mkdir()
    (d / "inner.txt").write_text("x")
    with pt.start_run() as run:
        pt.log_artifact(str(f))
        pt.log_artifacts(str(d), "copied")
        pt.log_text("summary", "report/summary.txt")
        pt.log_dict({"k": [1, 2]}, "report/d.json")
        pt.log_engine_metrics({"device_ms": 1.5})
    pt.log_engine_metrics({"device_ms": 2.0})  # no active run: no new run
    for m in (pt, jt):
        arts = {a.path for a in m.MlflowClient().list_artifacts(
            run.info.run_id)}
        assert arts == {"note.txt", "copied/inner.txt", "report/summary.txt",
                        "report/d.json"}
    assert pt.get_run(run.info.run_id).data.metrics == \
        {"engine.device_ms": 1.5}
    assert len(pt.search_runs(output_format="list")) == 1


def test_experiments_and_client_tags():
    exp_id = pt.MlflowClient().create_experiment("exp-a")
    assert jt.MlflowClient().get_experiment_by_name("exp-a").experiment_id \
        == exp_id
    assert pt.MlflowClient().get_experiment(exp_id).name == "exp-a"
    assert pt.MlflowClient().get_experiment_by_name("missing") is None
    with jt.start_run(experiment_id=exp_id) as run:
        pass
    pt.MlflowClient().set_tag(run.info.run_id, "reviewed", "yes")
    assert jt.get_run(run.info.run_id).data.tags["reviewed"] == "yes"
    names = {e.name for e in pt.MlflowClient().search_experiments()}
    assert names == {e.name for e in jt.MlflowClient().search_experiments()}


# --------------------------------------------------------------- registry
@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_registry_round_trip(writer, reader):
    w, r = (jt, pt) if writer == "jax" else (pt, jt)
    rstore = pstore if reader == "port" else jstore
    for _ in range(3):
        with w.start_run():
            w.sklearn.log_model(Doubler(), "model",
                                registered_model_name="demo")
    client = w.MlflowClient()
    client.update_registered_model("demo", "three doublers")
    client.transition_model_version_stage("demo", 1, "Staging")
    client.transition_model_version_stage("demo", 2, "Production")
    client.transition_model_version_stage("demo", 3, "Production",
                                          archive_existing_versions=True)
    client.update_model_version("demo", 1, "first")
    rc = r.MlflowClient()
    assert rc.get_registered_model("demo").description == "three doublers"
    assert [v.current_stage for v in
            rc.get_registered_model("demo").latest_versions] == \
        ["Staging", "Archived", "Production"]
    assert rstore.resolve_stage("demo", "Production")["version"] == 3
    assert rstore.resolve_stage("demo", "Staging")["version"] == 1
    assert rstore.resolve_stage("demo", "None") is None
    assert rc.get_model_version("demo", 1).description == "first"
    assert rc.get_model_version("demo", 2).status == "READY"
    assert [v.version for v in rc.get_latest_versions(
        "demo", ["Production", "Staging"])] == [1, 3]
    assert [v.version for v in rc.get_latest_versions("demo")] == [3]
    assert [v.version for v in rc.search_model_versions(
        "name='demo'")] == [1, 2, 3]
    X = np.arange(6.0).reshape(3, 2)
    want = Doubler().predict(X)
    for uri in ("models:/demo/Production", "models:/demo/1",
                "models:/demo"):
        got = r.pyfunc.load_model(uri).predict(
            pd.DataFrame(X, columns=["p", "q"]) if reader == "jax"
            else {"p": X[:, 0], "q": X[:, 1]})
        np.testing.assert_array_equal(got, want)
    rc.delete_model_version("demo", 1)
    assert [v.version for v in w.MlflowClient().search_model_versions(
        "name='demo'")] == [2, 3]
    rc.delete_registered_model("demo")
    with pytest.raises(ValueError):
        w.MlflowClient().get_registered_model("demo")


def test_missing_model_uri_and_version_raise():
    with pytest.raises(ValueError, match="has no versions"):
        pt.pyfunc.load_model("models:/nothing/Production")
    with pt.start_run():
        pt.sklearn.log_model(Doubler(), "model", registered_model_name="one")
    with pytest.raises(ValueError, match="matches"):
        pt.pyfunc.load_model("models:/one/Production")
    with pytest.raises(ValueError, match="not found"):
        pt.MlflowClient().get_model_version("one", 7)
    with pytest.raises(ValueError, match="not found"):
        pt.get_run("0" * 32)
    with pytest.raises(ValueError, match="unsupported filter"):
        pt.MlflowClient().search_model_versions("version=1")


def _two_versions():
    for _ in range(2):
        with pt.start_run():
            pt.sklearn.log_model(Doubler(), "model",
                                 registered_model_name="staged")
    pt.MlflowClient().transition_model_version_stage("staged", 1,
                                                     "Production")


def test_listener_sees_the_commit_with_its_archived_versions():
    _two_versions()
    seen = []

    def listener(name, v, stage, archived):
        seen.append((name, v, stage, archived))

    pstore.on_stage_transition(listener)
    pstore.on_stage_transition(listener)  # idempotent per function
    try:
        pt.MlflowClient().transition_model_version_stage(
            "staged", 2, "Production", archive_existing_versions=True)
    finally:
        pstore.remove_stage_listener(listener)
    pstore.remove_stage_listener(listener)  # a second removal is a no-op
    assert seen == [("staged", 2, "Production", [1])]
    assert jstore.get_model_version("staged", 1)["current_stage"] == \
        "Archived"


def test_raising_listener_is_counted_and_does_not_block_later_ones():
    """Listener hygiene, as in the JAX package: a raising listener
    neither stops later listeners nor reaches the promoter; it counts
    under `tracking.listener_error`."""
    _two_versions()
    calls = []

    def bad(name, v, stage, archived):
        calls.append("bad")
        raise RuntimeError("torn subscriber")

    def good(name, v, stage, archived):
        calls.append("good")

    pstore.on_stage_transition(bad)
    pstore.on_stage_transition(good)
    try:
        before = PPROF.counters().get("tracking.listener_error", 0.0)
        meta = pstore.set_version_stage("staged", 2, "Production",
                                        archive_existing_versions=True)
    finally:
        pstore.remove_stage_listener(bad)
        pstore.remove_stage_listener(good)
    assert meta["current_stage"] == "Production"
    assert calls == ["bad", "good"]
    assert PPROF.counters()["tracking.listener_error"] == before + 1
    assert pstore.resolve_stage("staged", "Production")["version"] == 2


@pytest.mark.parametrize("store", [pstore, jstore], ids=["port", "jax"])
def test_bad_promote_archives_nothing(store):
    """The target version is validated before any incumbent is archived,
    in both packages."""
    _two_versions()
    with pytest.raises(ValueError, match="not found"):
        store.set_version_stage("staged", 99, "Production",
                                archive_existing_versions=True)
    for s in (pstore, jstore):
        assert s.resolve_stage("staged", "Production")["version"] == 1


def test_on_disk_layout_is_the_jax_packages():
    """Both packages write the same files with the same keys."""
    metas = {}
    for name, m, s in (("p", pt, pstore), ("j", jt, jstore)):
        exp = m.set_experiment(f"layout-{name}")
        with m.start_run() as run:
            m.log_param("x", 1)
            m.log_metric("y", 2.0)
            m.sklearn.log_model(Doubler(), "model",
                                registered_model_name=f"layout-{name}")
        d = s.run_dir(exp.experiment_id, run.info.run_id)
        files = sorted(os.path.relpath(os.path.join(r, f), d)
                       for r, _, fs in os.walk(d) for f in fs)
        vd = os.path.join(s.model_dir(f"layout-{name}"), "versions", "1")
        metas[name] = (files, {k: sorted(json.load(open(os.path.join(
            d, f"{k}.json")))) for k in ("meta", "params", "metrics",
                                         "tags")},
            sorted(json.load(open(os.path.join(vd, "meta.json")))),
            sorted(json.load(open(os.path.join(
                s.model_dir(f"layout-{name}"), "meta.json")))),
            sorted(os.listdir(os.path.join(vd, "model"))))
    assert metas["p"] == metas["j"]


def test_wait_for_model_polls_until_ready_and_times_out():
    from sml_tpu_torch.courseware import wait_for_model
    _two_versions()
    assert wait_for_model("staged", 1, "Production").version == 1
    assert wait_for_model("staged", 2).current_stage == "None"
    with pytest.raises(TimeoutError):
        wait_for_model("staged", 2, "Production", timeout_s=0.3)
    with pytest.raises(TimeoutError):
        wait_for_model("staged", 5, timeout_s=0.3)


# ---------------------------------------------------------------- flavors
def _port_pipeline(kind, frame):
    stages = [pfeat.VectorAssembler(inputCols=["a", "b", "c"],
                                    outputCol="features")]
    if kind == "forest":
        stages.append(preg.RandomForestRegressor(
            labelCol="y", numTrees=5, maxDepth=4, maxBins=16, seed=3))
    else:
        stages.append(preg.LinearRegression(labelCol="y"))
    return pbase.Pipeline(stages=stages).fit(frame)


def _tol(kind, want):
    scale = float(np.max(np.abs(want)))
    return (RTOL, RTOL * scale) if kind == "forest" \
        else (0.0, LINEAR_TOL * scale)


@pytest.mark.parametrize("kind", ["forest", "linear"])
def test_port_logged_model_loads_in_the_jax_package(spark, kind):
    block = _block()
    pf, jf = _frames(spark, block)
    model = _port_pipeline(kind, pf)
    want = _column(model.transform(pf), "prediction")
    with pt.start_run() as run:
        pt.spark.log_model(model, "model", registered_model_name="flavor")
    jmodel = jt.spark.load_model("models:/flavor/1")
    got = jmodel.transform(jf).toPandas()["prediction"].to_numpy()
    rtol, atol = _tol(kind, want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # and back through the port's own loader, by run URI
    again = pt.spark.load_model(f"runs:/{run.info.run_id}/model")
    np.testing.assert_array_equal(
        _column(again.transform(pf), "prediction"), want)
    assert pt.get_run(run.info.run_id).data.params == {}


@pytest.mark.parametrize("kind", ["forest", "linear"])
def test_pyfunc_and_spark_udf_on_a_port_frame(spark, kind):
    """A model the JAX package logs, scored by the port's pyfunc (a
    mapping of columns and a frame; the `DeviceScorer` route) and
    `spark_udf`, against the JAX package's own pyfunc."""
    from sml_tpu.ml import Pipeline as JPipeline
    from sml_tpu.ml.feature import VectorAssembler as JVA
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu.ml.regression import RandomForestRegressor as JRF
    block = _block(seed=1)
    pf, jf = _frames(spark, block)
    est = JRF(labelCol="y", numTrees=5, maxDepth=4, maxBins=16, seed=3) \
        if kind == "forest" else JLR(labelCol="y")
    jmodel = JPipeline(stages=[
        JVA(inputCols=["a", "b", "c"], outputCol="features"), est]).fit(jf)
    with jt.start_run() as run:
        jt.spark.log_model(jmodel, "model")
    uri = f"runs:/{run.info.run_id}/model"
    feats = pd.DataFrame({c: block[c] for c in ("a", "b", "c")})
    want = np.asarray(jt.pyfunc.load_model(uri).predict(feats))
    rtol, atol = _tol(kind, want)
    py = pt.pyfunc.load_model(uri)
    assert py._kind == "scorer"
    for data in ({c: block[c] for c in ("a", "b", "c")}, pf):
        np.testing.assert_allclose(py.predict(data), want, rtol=rtol,
                                   atol=atol)
    predict = pt.pyfunc.spark_udf(get_session(), uri)
    out = pf.withColumn("pred", predict("a", "b", "c"))
    np.testing.assert_allclose(_column(out, "pred"), want, rtol=rtol,
                               atol=atol)
    assert out.count() == len(want)


def test_pyfunc_takes_the_transform_route_for_other_models():
    """A native model the scorer has no path for (a KMeans pipeline)
    goes through `transform` and returns its prediction column; the
    route is read from the model's type."""
    from sml_tpu_torch.ml.clustering import KMeans
    pf = get_session().createDataFrame(_block())
    model = pbase.Pipeline(stages=[
        pfeat.VectorAssembler(inputCols=["a", "b"], outputCol="features"),
        KMeans(k=3, seed=1)]).fit(pf)
    with pt.start_run() as run:
        pt.spark.log_model(model, "model")
    py = pt.pyfunc.load_model(f"runs:/{run.info.run_id}/model")
    assert py._kind == "transform"
    want = _column(model.transform(pf), "prediction")
    np.testing.assert_array_equal(py.predict(pf), want)
    np.testing.assert_array_equal(
        py.predict({"a": _block()["a"], "b": _block()["b"]}), want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pickled_model_flavor_either_way(writer):
    w = jt if writer == "jax" else pt
    X = np.arange(12.0).reshape(4, 3)
    with w.start_run() as run:
        w.sklearn.log_model(Doubler(), "model",
                            signature=w.infer_signature(X, X[:, 0]))
    uri = f"runs:/{run.info.run_id}/model"
    np.testing.assert_array_equal(
        pt.pyfunc.load_model(uri).predict(
            {"x": X[:, 0], "y": X[:, 1], "z": X[:, 2]}),
        Doubler().predict(X))
    assert isinstance(pt.sklearn.load_model(uri), Doubler)
    np.testing.assert_array_equal(
        jt.pyfunc.load_model(uri).predict(pd.DataFrame(X)),
        Doubler().predict(X))
    sig = pt.pyfunc.load_model(uri).metadata.signature
    assert sig["inputs"] == [{"type": "float64", "shape": [4, 3]}]


def test_save_model_and_load_by_path(tmp_path):
    pf = get_session().createDataFrame(_block())
    model = _port_pipeline("linear", pf)
    path = str(tmp_path / "saved")
    pt.spark.save_model(model, path)
    got = jt.spark.load_model(path)
    assert type(got).__name__ == "PipelineModel"
    pt.sklearn.save_model(Doubler(), str(tmp_path / "pickled"))
    assert isinstance(pt.sklearn.load_model(str(tmp_path / "pickled")),
                      Doubler)


def test_input_example_is_pandas_split_json(spark):
    block = _block(n=5)
    block["name"] = np.array(["x", None, "z", "w", "v"], dtype=object)
    block["a"][1] = np.nan
    pf, jf = _frames(spark, block)
    pdf = pd.DataFrame(block)
    model = _port_pipeline("linear", pf.dropna())
    for example in (pf, {k: v for k, v in block.items()}):
        with pt.start_run() as run:
            out = pt.spark.log_model(model, "model", input_example=example)
        got = json.load(open(os.path.join(out, "input_example.json")))
        want = json.loads(pdf.to_json(orient="split"))
        assert list(got) == ["columns", "index", "data"]
        assert got["columns"] == want["columns"]
        assert got["index"] == want["index"]
        for g, w in zip(got["data"], want["data"]):
            for gv, wv in zip(g, w):
                if isinstance(wv, float):
                    assert gv == pytest.approx(wv, rel=1e-9)
                else:
                    assert gv == wv
        assert pt.get_run(run.info.run_id).info.status == "FINISHED"
    with pt.start_run():
        out = pt.sklearn.log_model(Doubler(), "m2",
                                   input_example=np.ones((2, 3)))
    got = json.load(open(os.path.join(out, "input_example.json")))
    assert got == json.loads(pd.DataFrame(np.ones((2, 3))).to_json(
        orient="split"))


def test_infer_signature_of_a_frame_a_mapping_and_an_array():
    block = {"a": np.arange(3.0), "k": np.array(["x", "y", "z"])}
    pf = get_session().createDataFrame(block)
    sig = pt.infer_signature(pf, np.zeros(3, np.float32))
    assert sig.inputs == [{"name": "a", "type": "double"},
                          {"name": "k", "type": "string"}]
    assert sig.outputs == [{"type": "float32", "shape": [3]}]
    # a mapping's columns as the port stores them: text is an object
    # column (pandas 3 names its text dtype "str", pandas 2 "object")
    got = pt.infer_signature(block, np.zeros(3))
    want = jt.infer_signature(pd.DataFrame(block), np.zeros(3))
    assert got.inputs == [{"name": "a", "type": "float64"},
                          {"name": "k", "type": "object"}]
    assert [i["name"] for i in got.inputs] == \
        [i["name"] for i in want.inputs]
    assert got.inputs[0] == want.inputs[0] and got.outputs == want.outputs
    assert "inputs:" in repr(sig)


def test_autolog_stubs_and_self_alias():
    pt.autolog(log_models=False)
    assert pt._AutologState.enabled and not pt._AutologState.log_models
    pt.pyspark.ml.autolog(disable=True)
    assert not pt._AutologState.enabled
    assert pt.tracking is pt
    assert pt.get_tracking_uri() == jt.get_tracking_uri()
    assert set(pt.__all__) == set(jt.__all__)
    assert JPROF is not PPROF
