"""The port stands alone: importing every module of `sml_tpu_torch`, and
running a DataFrame pipeline, a CrossValidator, `fmin`, the time-series
models, the frame's SQL and CSV paths, the registry, a `ServingEndpoint`
and AutoML, the host route, the batcher's host fallback, the dispatcher
and prewarm with the session's device set to the CPU, loads neither JAX,
the JAX package, pandas nor pyarrow; the data plane (the parquet codec,
Delta tables, the feature store and
`ClassroomSetup().install_datasets()`) runs with those four blocked
from importing at all; and without a CUDA device the entry points
(scoring, fitting, a DataFrame fit, transform and evaluate, a
CrossValidator's fit, `fmin`'s placed trials, the chunked fits,
`Prophet.fit`, `ARIMA.fit`, `ServingEndpoint` and `automl.regress`)
raise rather than carry on on the CPU (each check runs in a fresh
interpreter with no CUDA device visible)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=REPO, args=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable] + (args if args is not None else ["-c", code])
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


IMPORT_ALL = """
import importlib, pkgutil, sys
import sml_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sml_tpu_torch.__path__,
                                                "sml_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(len(names), bad)
"""


def test_importing_the_whole_port_loads_no_jax_and_no_sml_tpu():
    proc = _run(IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 36
    assert bad == "[]"


def test_the_fit_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("sml_tpu_torch.native.hist_kernel",
                 "sml_tpu_torch.native.prng_kernel",
                 "sml_tpu_torch.native.binning",
                 "sml_tpu_torch.native.build",
                 "sml_tpu_torch.utils.prng", "sml_tpu_torch.conf",
                 "sml_tpu_torch.ml._staging",
                 "sml_tpu_torch.ml.tree_impl", "sml_tpu_torch.ml._tree_models",
                 "sml_tpu_torch.xgboost"):
        assert name in proc.stdout


def test_the_host_layer_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("frame.dataframe", "frame.column", "frame.functions",
                 "frame.sampling", "frame.session", "frame.types",
                 "native.hashing", "courseware", "ml.param", "ml.linalg",
                 "ml.base", "ml.feature", "ml.evaluation", "ml.regression",
                 "ml.classification"):
        assert f"sml_tpu_torch.{name}" in proc.stdout


def test_the_selection_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("tune", "tune._fmin", "tune._space", "ml.tuning"):
        assert f"sml_tpu_torch.{name}" in proc.stdout


def test_the_chunked_plane_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("frame._chunks", "parallel", "parallel.pipeline",
                 "ml._chunked", "ct", "ct._checkpoint"):
        assert f"sml_tpu_torch.{name}" in proc.stdout


def test_the_nontree_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("ml.linear_impl", "ml.regression", "ml.classification",
                 "ml.clustering", "ml.recommendation", "ml.inference",
                 "courseware"):
        assert f"sml_tpu_torch.{name}'" in proc.stdout


def test_the_timeseries_and_frame_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("version", "timeseries", "compat", "frame.grouped",
                 "frame.sql", "frame.io"):
        assert f"sml_tpu_torch.{name}'" in proc.stdout


def test_the_featurizer_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("ml.featurizer", "ml.inference", "parallel.pipeline"):
        assert f"sml_tpu_torch.{name}'" in proc.stdout


def test_the_registry_endpoint_and_automl_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("tracking", "tracking._store", "serving._endpoint",
                 "automl"):
        assert f"sml_tpu_torch.{name}'" in proc.stdout


def test_the_dispatcher_obs_and_host_route_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("obs", "obs._recorder", "obs._context", "obs._metrics",
                 "obs._watchdog", "obs._audit", "parallel.dispatch",
                 "parallel.prewarm", "native.host_traverse"):
        assert f"sml_tpu_torch.{name}'" in proc.stdout


def test_the_data_plane_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("frame.parquet", "frame.parquet._thrift",
                 "frame.parquet._encoding", "frame.parquet._arrow",
                 "native.snappy", "delta", "delta.table", "feature_store",
                 "courseware"):
        assert f"sml_tpu_torch.{name}'" in proc.stdout


BLOCKED = """
import importlib.abc, sys


class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                  "pyarrow"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Blocked())
"""

DATA_PLANE = BLOCKED + """
import os, tempfile
from sml_tpu_torch import GLOBAL_CONF, functions as F
from sml_tpu_torch.courseware import ClassroomSetup, TestResults
from sml_tpu_torch.delta import DeltaTable
from sml_tpu_torch.feature_store import FeatureLookup, FeatureStoreClient
from sml_tpu_torch.frame.io import read_parquet_chunks
from sml_tpu_torch.frame.session import get_session
GLOBAL_CONF.set("sml.device", "cpu")
base = tempfile.mkdtemp()
setup = ClassroomSetup(base_dir=base)
root = setup.install_datasets()
spark = get_session()
clean = os.path.join(root, "airbnb", "sf-listings",
                     "sf-listings-2019-03-06-clean")
pq = spark.read.parquet(clean + ".parquet")
dl = spark.read.format("delta").load(clean + ".delta")
print("clean", pq.count(), dl.count(), pq.getNumPartitions(),
      sorted(pq.columns) == sorted(dl.columns))
dl.limit(3).write.format("delta").mode("append").save(clean + ".delta")
print("history", len(DeltaTable.forPath(spark, clean + ".delta")
                     .history().collect()))
ratings = spark.read.parquet(os.path.join(root, "movielens",
                                          "ratings.parquet"))
src = read_parquet_chunks(clean + ".parquet", ["bedrooms"], "price",
                          chunkRows=1000)
print("chunks", sum(len(X) for X, _ in src.chunks()) == pq.count())
people = spark.read.option("header", "true").option("sep", ":") \
    .option("inferSchema", "true").csv(os.path.join(
        root, "dedup", "people-with-dups.txt"))
print("people", people.count(), TestResults.to_hash(100000),
      ratings.count() > 0)
fs = FeatureStoreClient(os.path.join(base, "fs"))
feats = pq.coalesce(1).withColumn("id", F.monotonically_increasing_id())
fs.create_table("f", "id", df=feats.select("id", "bedrooms"))
print("fs", fs.create_training_set(feats.select("id", "price"),
                                   [FeatureLookup("f", "id")],
                                   label="price").load_df().count()
      == pq.count())
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_the_data_plane_runs_with_pandas_pyarrow_and_jax_blocked():
    proc = _run(DATA_PLANE)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("clean ") and lines[0].endswith(" 8 True")
    n = int(lines[0].split()[1])
    assert lines[0] == f"clean {n} {n} 8 True"
    assert lines[1:] == ["history 2", "chunks True",
                         "people 103000 972882115 True", "fs True", "[]"]


HOST_ROUTE = """
import os, sys, tempfile
import numpy as np
from sml_tpu_torch import GLOBAL_CONF, obs
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.ml.regression import DecisionTreeRegressor
from sml_tpu_torch.parallel import dispatch, prewarm
from sml_tpu_torch.serving import MicroBatcher
GLOBAL_CONF.set("sml.compile.cacheDir", tempfile.mkdtemp())
GLOBAL_CONF.set("sml.obs.enabled", True)
rng = np.random.default_rng(0)
X = rng.normal(size=(300, 3))
model = DecisionTreeRegressor(maxDepth=3).fit(X, X[:, 0], device="cpu")
scorer = DeviceScorer(model, device="cpu")
print("host", np.array_equal(scorer.score_block_host(X),
                             scorer.score_block(X)))
with MicroBatcher(scorer.score_block, host_score=scorer.score_block_host,
                  host_fallback=True, queue_rows=4, start=False) as b:
    futs = [b.submit(X[i:i + 3]) for i in range(0, 12, 3)]
    b.start()
    print("served", all(np.array_equal(f.result(30),
                                       scorer.score_block(X[i * 3:i * 3 + 3]))
                        for i, f in enumerate(futs)))
print("route", dispatch.decide(dispatch.WorkHint(1e9), device="cpu"))
print("prewarm", prewarm.prewarm(device="cpu")["programs"])
print("audit", len(obs.audit_records()) > 0)
try:
    DeviceScorer(model)
except RuntimeError as e:
    print("scorer raised:", str(e)[:14])
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_host_route_batcher_fallback_and_prewarm_load_no_jax():
    proc = _run(HOST_ROUTE)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == [
        "host True", "served True", "route device",
        "prewarm 0", "audit True", "scorer raised: no CUDA device", "[]"]


REGISTRY = """
import os, sys, tempfile
import numpy as np
from sml_tpu_torch import GLOBAL_CONF, automl, get_session
from sml_tpu_torch import tracking as mlflow
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.ml import Pipeline
from sml_tpu_torch.ml.feature import VectorAssembler
from sml_tpu_torch.ml.regression import DecisionTreeRegressor
from sml_tpu_torch.serving import ServingEndpoint
mlflow.set_tracking_uri(os.path.join(tempfile.mkdtemp(), "runs"))
d = make_airbnb_dataset(n=300, seed=1)
df = get_session().createDataFrame(
    {c: d[c] for c in ("bedrooms", "accommodates", "room_type", "price")})
GLOBAL_CONF.set("sml.device", "cpu")
model = Pipeline(stages=[
    VectorAssembler(inputCols=["bedrooms", "accommodates"],
                    outputCol="features", handleInvalid="skip"),
    DecisionTreeRegressor(labelCol="price", maxDepth=3)]).fit(df)
with mlflow.start_run():
    mlflow.spark.log_model(model, "model", registered_model_name="m")
mlflow.MlflowClient().transition_model_version_stage("m", 1, "Production")
GLOBAL_CONF.set("sml.device", DEVICE)


def served(dev):
    with ServingEndpoint("m", device=dev) as ep:
        return ep.score(np.ones((2, 2)), timeout=30).shape


for what, call in (
        ("endpoint", lambda dev: served(dev)),
        ("automl", lambda dev: len(automl.regress(
            df, target_col="price", max_trials=2).trials))):
    try:
        out = call(None)
    except RuntimeError as e:
        print(what, "raised:", e)
        GLOBAL_CONF.set("sml.device", "cpu")
        out = call("cpu")
        GLOBAL_CONF.set("sml.device", DEVICE)
    print(what, out)
print("runs", mlflow.search_runs(output_format="list")[-1].info.status)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""

REGISTRY_OUT = ["endpoint (2,)", "automl 2", "runs FINISHED", "[]"]


def test_registry_endpoint_and_automl_on_the_cpu_load_no_pandas_or_jax():
    proc = _run(REGISTRY.replace("DEVICE", repr("cpu")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == REGISTRY_OUT


def test_endpoint_and_automl_raise_without_a_card():
    proc = _run(REGISTRY.replace("DEVICE", repr("cuda")))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    raised = [ln for ln in lines if " raised: " in ln]
    assert [ln.split(" ")[0] for ln in raised] == ["endpoint", "automl"], \
        lines
    assert all("no CUDA device" in ln for ln in raised), lines
    assert [ln for ln in lines if " raised: " not in ln] == REGISTRY_OUT


TIMESERIES = """
import os, sys, tempfile
import numpy as np
from sml_tpu_torch import GLOBAL_CONF, functions as F, get_session
from sml_tpu_torch.courseware import make_dedup_dataset
from sml_tpu_torch.timeseries import ARIMA, Prophet, adfuller
GLOBAL_CONF.set("sml.device", DEVICE)
t = np.arange(60, dtype=float)
y = 0.02 * t * t + 1.5 * t + np.random.default_rng(0).normal(size=60)
ds = np.datetime64("2020-01-01") + np.arange(60) * np.timedelta64(1, "D")
for what, call in (
        ("prophet", lambda: Prophet().fit({"ds": ds, "y": y}).predict()
         .count()),
        ("arima", lambda: len(ARIMA(y, order=(1, 1, 1)).fit().forecast(3)))):
    try:
        out = call()
    except RuntimeError as e:
        print(what, "raised:", e)
        GLOBAL_CONF.set("sml.device", "cpu")
        out = call()
        GLOBAL_CONF.set("sml.device", DEVICE)
    print(what, out)
print("adf", adfuller(y)[2])
spark = get_session()
people = make_dedup_dataset(n=300, n_unique=250)
path = os.path.join(tempfile.mkdtemp(), "people")
people.write.option("header", True).csv(path)
back = spark.read.option("header", "true").option("inferSchema", "true") \
    .csv(path)
back.createOrReplaceTempView("people")
n = spark.sql("SELECT gender, count(*) AS n FROM people GROUP BY gender")
print("frame", back.count(), sorted(r["n"] for r in n.collect()),
      back.groupBy("gender").agg(F.avg("salary")).count())
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""

TIMESERIES_OUT = ["prophet 60", "arima 3", "adf 11", "frame 300 [148, 152] 2",
                  "[]"]


def test_timeseries_and_frame_on_the_cpu_load_no_pandas_jax_or_sml_tpu():
    proc = _run(TIMESERIES.replace("DEVICE", repr("cpu")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == TIMESERIES_OUT


def test_prophet_and_arima_fits_raise_without_a_card():
    proc = _run(TIMESERIES.replace("DEVICE", repr("cuda")))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    raised = [ln for ln in lines if " raised: " in ln]
    assert [ln.split(" ")[0] for ln in raised] == ["prophet", "arima"], lines
    assert all("no CUDA device" in ln for ln in raised), lines
    assert [ln for ln in lines if " raised: " not in ln] == TIMESERIES_OUT


NONTREE = """
import sys
import numpy as np
from sml_tpu_torch import get_session, GLOBAL_CONF
from sml_tpu_torch.courseware import make_airbnb_dataset, make_movielens_dataset
from sml_tpu_torch.ml import (ALS, DeviceScorer, KMeans, LinearRegression,
                              LogisticRegression)
from sml_tpu_torch.ml.feature import Imputer, VectorAssembler
GLOBAL_CONF.set("sml.device", DEVICE)
num = ["bedrooms", "bathrooms", "accommodates"]
df = get_session().createDataFrame(make_airbnb_dataset(n=400, seed=1))
df = Imputer(strategy="median", inputCols=num, outputCols=num).fit(df) \\
    .transform(df)
df = VectorAssembler(inputCols=num, outputCol="features").transform(df)
df = df.withColumn("label", df["price"] > 150)
ratings = get_session().createDataFrame(make_movielens_dataset(40, 30, 600, 2))
for what, call in (
        ("linear", lambda: LinearRegression(labelCol="price").fit(df)
         .transform(df).count()),
        ("logistic", lambda: LogisticRegression().fit(df).summary
         .numInstances),
        ("kmeans", lambda: KMeans(k=3, seed=1).fit(df).summary.k),
        ("als", lambda: ALS(userCol="userId", itemCol="movieId", rank=3,
                            maxIter=2).fit(ratings).rank),
        ("scorer", lambda: len(DeviceScorer(
            model, device=GLOBAL_CONF.get("sml.device")).score_block(
            np.ones((5, 3)))))):
    try:
        out = call()
    except RuntimeError as e:
        print(what, "raised:", e)
        GLOBAL_CONF.set("sml.device", "cpu")
        out = call()
        GLOBAL_CONF.set("sml.device", DEVICE)
    if what == "linear":
        GLOBAL_CONF.set("sml.device", "cpu")
        model = LinearRegression(labelCol="price").fit(df)
        GLOBAL_CONF.set("sml.device", DEVICE)
    print(what, out)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""

NONTREE_OUT = ["linear 400", "logistic 400", "kmeans 3", "als 3",
               "scorer 5", "[]"]


def test_nontree_programs_on_the_cpu_load_no_pandas_jax_or_sml_tpu():
    proc = _run(NONTREE.replace("DEVICE", repr("cpu")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == NONTREE_OUT


def test_nontree_entry_points_raise_without_a_card():
    proc = _run(NONTREE.replace("DEVICE", repr("cuda")))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    raised = [ln for ln in lines if " raised: " in ln]
    assert [ln.split(" ")[0] for ln in raised] == [
        "linear", "logistic", "kmeans", "als", "scorer"], lines
    assert all("no CUDA device" in ln for ln in raised), lines
    assert [ln for ln in lines if " raised: " not in ln] == NONTREE_OUT


CHUNKED = """
import sys
import numpy as np
from sml_tpu_torch.ct import checkpointed_fit
from sml_tpu_torch.frame._chunks import ArrayChunkSource
from sml_tpu_torch.ml._chunked import fit_ensemble_chunked
rng = np.random.default_rng(0)
X = rng.normal(size=(600, 4))
y = X[:, 0] + rng.normal(0, 0.1, 600)
for what, call in (
        ("fit", lambda dev: fit_ensemble_chunked(
            ArrayChunkSource(X, y, chunk_rows=128), max_depth=2,
            max_bins=8, n_trees=2, boosting=True, device=dev)),
        ("checkpointed", lambda dev: checkpointed_fit(
            ArrayChunkSource(X, y, chunk_rows=128), CKDIR, n_trees=4,
            max_depth=2, max_bins=8, rounds_per_dispatch=2, device=dev))):
    try:
        out = call(None)
    except RuntimeError as e:
        print(what, "raised:", e)
        out = call("cpu")
    print(what, len(out.trees))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_chunked_fits_load_no_jax_and_raise_without_a_card(tmp_path):
    proc = _run(CHUNKED.replace("CKDIR", repr(str(tmp_path / "ck"))))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("fit raised: no CUDA device"), lines
    assert lines[2].startswith("checkpointed raised: no CUDA device"), lines
    assert [lines[1], lines[3], lines[4]] == ["fit 2", "checkpointed 4",
                                              "[]"]


SELECTION = """
import sys
import numpy as np
from sml_tpu_torch import get_session, GLOBAL_CONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.ml import CrossValidator, ParamGridBuilder, Pipeline
from sml_tpu_torch.ml.evaluation import RegressionEvaluator
from sml_tpu_torch.ml.feature import StringIndexer, VectorAssembler
from sml_tpu_torch.ml.regression import RandomForestRegressor
from sml_tpu_torch.tune import SparkTrials, fmin, hp, tpe
GLOBAL_CONF.set("sml.device", DEVICE)
df = get_session().createDataFrame(make_airbnb_dataset(n=600, seed=1))
rf = RandomForestRegressor(labelCol="price", maxBins=16, seed=1)
pipe = Pipeline(stages=[
    StringIndexer(inputCol="room_type", outputCol="rt", handleInvalid="skip"),
    VectorAssembler(inputCols=["rt", "accommodates"], outputCol="features"),
    rf])
grid = ParamGridBuilder().addGrid(rf.getParam("maxDepth"), [2, 3]).build()
ev = RegressionEvaluator(labelCol="price")
for what, call in (
        ("cv", lambda: CrossValidator(estimator=pipe, estimatorParamMaps=grid,
                                      evaluator=ev, numFolds=2,
                                      parallelism=2).fit(df).avgMetrics),
        ("fmin", lambda: fmin(lambda p: float(p["x"]) ** 2,
                              {"x": hp.uniform("x", -1, 1)}, algo=tpe,
                              max_evals=4,
                              trials=SparkTrials(parallelism=2),
                              rstate=np.random.RandomState(0)))):
    try:
        out = call()
    except RuntimeError as e:
        print(what, "raised:", e)
        GLOBAL_CONF.set("sml.device", "cpu")
        out = call()
        GLOBAL_CONF.set("sml.device", DEVICE)
    print(what, len(out))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_model_selection_on_the_cpu_loads_no_pandas_jax_or_sml_tpu():
    proc = _run(SELECTION.replace("DEVICE", repr("cpu")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == ["cv 2", "fmin 1", "[]"]


def test_model_selection_entry_points_raise_without_a_card():
    proc = _run(SELECTION.replace("DEVICE", repr("cuda")))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("cv raised: no CUDA device"), lines
    assert lines[2].startswith("fmin raised: no CUDA device"), lines
    assert [lines[1], lines[3], lines[4]] == ["cv 2", "fmin 1", "[]"]


PIPELINE = """
import sys
import numpy as np
from sml_tpu_torch import functions as F, get_session, GLOBAL_CONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.ml import Pipeline
from sml_tpu_torch.ml.evaluation import RegressionEvaluator
from sml_tpu_torch.ml.feature import Imputer, StringIndexer, VectorAssembler
from sml_tpu_torch.ml.regression import DecisionTreeRegressor
GLOBAL_CONF.set("sml.device", DEVICE)
num = ["bedrooms", "bathrooms", "accommodates"]
df = get_session().createDataFrame(make_airbnb_dataset(n=600, seed=1))
train, test = df.randomSplit([0.8, 0.2], seed=42)
prep = Pipeline(stages=[
    Imputer(strategy="median", inputCols=num, outputCols=num),
    StringIndexer(inputCol="room_type", outputCol="rt",
                  handleInvalid="skip"),
    VectorAssembler(inputCols=["rt"] + num, outputCol="features")]).fit(train)
tr, te = prep.transform(train), prep.transform(test)
est = DecisionTreeRegressor(labelCol="price", maxDepth=3, maxBins=16)
for what, call in (("fit", lambda: est.fit(tr)),
                   ("transform", lambda: model.transform(te)),
                   ("evaluate", lambda: RegressionEvaluator(
                       labelCol="price").evaluate(scored))):
    try:
        out = call()
    except RuntimeError as e:
        print(what, "raised:", e)
        GLOBAL_CONF.set("sml.device", "cpu")
        out = call()
        GLOBAL_CONF.set("sml.device", DEVICE)
    if what == "fit":
        model = out
    elif what == "transform":
        scored = out
    else:
        print("rmse", np.isfinite(out))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_dataframe_pipeline_on_the_cpu_loads_no_pandas_jax_or_sml_tpu():
    proc = _run(PIPELINE.replace("DEVICE", repr("cpu")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == ["rmse True", "[]"]


def test_dataframe_entry_points_raise_without_a_card():
    proc = _run(PIPELINE.replace("DEVICE", repr("cuda")))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    for line, what in zip(lines, ("fit", "transform", "evaluate")):
        assert line.startswith(f"{what} raised: no CUDA device"), lines
    assert lines[3:] == ["rmse True", "[]"]


FIT_WITHOUT_DEVICE = """
import numpy as np
from sml_tpu_torch.xgboost import XgboostRegressor
rng = np.random.default_rng(0)
X = rng.normal(size=(300, 4))
y = X[:, 0] + 0.1 * rng.normal(size=300)
model = XgboostRegressor(n_estimators=3, max_depth=3, max_bins=16).fit(
    X, y, device="cpu")
print(model.getNumTrees(), model.predict(X[:2], device="cpu").shape)
try:
    XgboostRegressor().fit(X, y)
except RuntimeError as e:
    print("raised:", e)
else:
    print("no error")
"""


def test_fit_without_device_raises_when_cuda_is_absent():
    proc = _run(FIT_WITHOUT_DEVICE)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "3 (2,)"
    assert lines[1].startswith("raised: no CUDA device")


GRID_WITHOUT_DEVICE = """
import numpy as np
from sml_tpu_torch.ml._tree_models import _fit_ensembles_grid
rng = np.random.default_rng(0)
Xs = [rng.normal(size=(200, 3)) for _ in range(2)]
ys = [X[:, 0] for X in Xs]
trials = [dict(max_depth=d, max_bins=8, min_instances=1, min_info_gain=0.0,
               n_trees=2, feature_k=None, bootstrap=True, subsample=1.0,
               seed=1) for d in (1, 2)]
print(len(_fit_ensembles_grid(Xs, ys, {}, trials, 16, device="cpu")))
try:
    _fit_ensembles_grid(Xs, ys, {}, trials, 16)
except RuntimeError as e:
    print("raised:", e)
else:
    print("no error")
"""


def test_grid_fit_without_device_raises_when_cuda_is_absent():
    proc = _run(GRID_WITHOUT_DEVICE)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "4"
    assert lines[1].startswith("raised: no CUDA device")


SCORER_WITHOUT_DEVICE = """
import types
import numpy as np
from sml_tpu_torch.ml._tree_models import _EnsembleSpec
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.ml.tree_impl import Binning, FittedTree
n = 7
tree = FittedTree(np.full(n, -1, np.int32), np.zeros(n, np.int32),
                  np.ones(n, np.float32), np.zeros(n, np.float32),
                  np.zeros(n, np.float32))
spec = _EnsembleSpec([tree], 2, Binning(np.full((2, 3), np.inf, np.float32),
                                        {}), None, 0.0, 2, "regression")
model = types.SimpleNamespace(_spec=spec)
print(DeviceScorer(model, device="cpu").score_block(np.zeros((3, 2))))
try:
    DeviceScorer(model)
except RuntimeError as e:
    print("raised:", e)
else:
    print("no error")
"""


def test_scorer_without_device_raises_when_cuda_is_absent():
    proc = _run(SCORER_WITHOUT_DEVICE)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "[1. 1. 1.]"
    assert lines[1].startswith("raised: no CUDA device")


@pytest.mark.parametrize("device, ok", [("cpu", True), ("cuda", False),
                                        (None, False)])
def test_resolve_device_without_cuda(device, ok):
    proc = _run(f"from sml_tpu_torch.device import resolve_device\n"
                f"print(resolve_device({device!r}))")
    assert (proc.returncode == 0) == ok, proc.stderr
    if ok:
        assert proc.stdout.strip() == "cpu"
    else:
        assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_without_cuda():
    proc = _run(None, args=[os.path.join(REPO, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(None, cwd=str(tmp_path),
                args=[str(tmp_path / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
