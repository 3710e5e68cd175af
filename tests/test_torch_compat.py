"""The port's course import shims (`sml_tpu_torch/compat.py`), each check
in a fresh interpreter: `tests/test_compat.py` installs the JAX
package's shims when it is imported, and the first package to install a
name keeps it (`sys.modules.setdefault`).

The import census is `tests/test_compat.py`'s (the course's own import
lines); every name must resolve to a module of `sml_tpu_torch`,
mlflow's, databricks.automl's, databricks.feature_store's,
databricks.koalas' and `pandas_udf`'s included, and installing the
shims and importing them loads no pandas. Then an ML 02-shaped cell
sequence and an ML 04 / ML 05 / ML 09 one (tracking, the registry's
stage transitions, AutoML, `spark_udf`), written the course's way, run
on the port (`sml.device=cpu`) and load neither JAX, the JAX package
nor pandas.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


CENSUS = """
import sys
from sml_tpu_torch.compat import install_shims
install_shims()
install_shims()  # idempotent
from pyspark.sql import SparkSession, DataFrame, Row  # noqa
from pyspark.sql.functions import col, lit, log, exp, when, translate  # noqa
from pyspark.sql.functions import monotonically_increasing_id, rand  # noqa
from pyspark.sql.functions import pandas_udf, udf  # noqa
import databricks.koalas as ks
from pyspark.sql.types import (DoubleType, IntegerType, StringType,  # noqa
                               StructType, Row)
import pyspark.sql.functions as F
from pyspark.sql.dataframe import DataFrame as DF2  # noqa
from pyspark.ml import Pipeline, PipelineModel  # noqa
from pyspark.ml.pipeline import Pipeline as P2  # noqa
from pyspark.ml.feature import (Imputer, OneHotEncoder, RFormula,  # noqa
                                StringIndexer, VectorAssembler)
from pyspark.ml.regression import (DecisionTreeRegressor,  # noqa
                                   LinearRegression, RandomForestRegressor)
from pyspark.ml.classification import LogisticRegression  # noqa
from pyspark.ml.clustering import KMeans  # noqa
from pyspark.ml.recommendation import ALS  # noqa
from pyspark.ml.evaluation import (BinaryClassificationEvaluator,  # noqa
                                   MulticlassClassificationEvaluator,
                                   RegressionEvaluator)
from pyspark.ml.tuning import CrossValidator, ParamGridBuilder  # noqa
from pyspark.ml.linalg import Vectors  # noqa
from hyperopt import SparkTrials, STATUS_OK, Trials, fmin, hp, tpe  # noqa
from sparkdl.xgboost import XgboostRegressor  # noqa
import sparkdl
objs = [SparkSession, DataFrame, Row, col, F, Pipeline, Imputer,
        DecisionTreeRegressor, LogisticRegression, KMeans, ALS,
        RegressionEvaluator, CrossValidator, Vectors, fmin, Trials,
        XgboostRegressor, sparkdl.xgboost, DF2, P2, pandas_udf, udf, ks]
mods = sorted({getattr(o, "__module__", None) or o.__name__ for o in objs})
print(all(m.startswith("sml_tpu_torch") for m in mods), mods)
print(sys.modules["pyspark.ml.feature"].__name__,
      sys.modules["hyperopt"].__name__,
      sys.modules["pyspark.sql.functions"].__name__)
for name in ("mlflow", "databricks", "databricks.koalas"):
    try:
        __import__(name)
        print(name, "imported")
    except ImportError:
        print(name, "absent")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_course_import_census_resolves_to_the_port():
    proc = _run(CENSUS)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("True "), lines[0]
    assert lines[1] == ("sml_tpu_torch.ml.feature sml_tpu_torch.tune "
                        "sml_tpu_torch.frame.functions")
    assert lines[2:5] == ["mlflow imported", "databricks imported",
                          "databricks.koalas imported"]
    assert "'sml_tpu_torch.pandas_api'" in lines[0]
    assert lines[5] == "[]"


def test_a_real_installation_wins():
    proc = _run("""
import sys, types
real = types.ModuleType("hyperopt")
sys.modules["hyperopt"] = real
from sml_tpu_torch.compat import install_shims
install_shims()
import hyperopt
print(hyperopt is real, "pyspark.ml" in sys.modules)
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "True"]


ML02 = """
import sys
import numpy as np
from sml_tpu_torch.compat import install_shims
install_shims()
from pyspark.sql import SparkSession
from pyspark.ml import Pipeline
from pyspark.ml.feature import StringIndexer, VectorAssembler
from pyspark.ml.regression import LinearRegression
from pyspark.ml.evaluation import RegressionEvaluator
from pyspark.sql.functions import col
from sml_tpu_torch.courseware import make_airbnb_dataset
spark = SparkSession.builder.appName("ml02").getOrCreate()
spark.conf.set("sml.device", "cpu")
airbnb_df = spark.createDataFrame(make_airbnb_dataset(n=2000, seed=42))
train_df, test_df = airbnb_df.withColumn(
    "price", col("price").cast("double")).randomSplit([.8, .2], seed=42)
string_indexer = StringIndexer(inputCols=["room_type"],
                               outputCols=["room_typeIndex"],
                               handleInvalid="skip")
vec_assembler = VectorAssembler(
    inputCols=["room_typeIndex", "accommodates"], outputCol="features")
lr = LinearRegression(labelCol="price", featuresCol="features")
pipeline = Pipeline(stages=[string_indexer, vec_assembler, lr])
pipeline_model = pipeline.fit(train_df)
pred_df = pipeline_model.transform(test_df)
rmse = RegressionEvaluator(predictionCol="prediction", labelCol="price",
                           metricName="rmse").evaluate(pred_df)
counts = airbnb_df.groupBy("room_type").count().orderBy(
    col("count").desc()).collect()
airbnb_df.createOrReplaceTempView("listings")
top = spark.sql("SELECT room_type, count(*) AS n FROM listings "
                "GROUP BY room_type ORDER BY n DESC").collect()
print(np.isfinite(rmse) and rmse > 0,
      [r["count"] for r in counts] == [r["n"] for r in top],
      sum(r["n"] for r in top))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_an_ml02_shaped_flow_runs_on_the_port():
    proc = _run(ML02)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == ["True True 2000", "[]"]


MLFLOW = """
import sys
from sml_tpu_torch.compat import install_shims
install_shims()
import mlflow
import mlflow.spark
import mlflow.pyfunc
import mlflow.sklearn
from mlflow.tracking import MlflowClient
from mlflow.tracking.client import MlflowClient as Client2
from mlflow.models.signature import infer_signature, ModelSignature
from databricks import automl
import databricks.automl
objs = [mlflow, MlflowClient, Client2, infer_signature, ModelSignature,
        automl, mlflow.tracking.MlflowClient, mlflow.spark.load_model,
        mlflow.pyfunc.spark_udf, mlflow.sklearn.log_model]
mods = sorted({getattr(o, "__module__", None) or o.__name__ for o in objs})
print(mods)
print(MlflowClient is Client2 is mlflow.MlflowClient,
      databricks.automl is automl)
for name in ("databricks.feature_store", "databricks.koalas"):
    try:
        __import__(name)
        print(name, "imported")
    except ImportError:
        print(name, "absent")
from databricks.feature_store import FeatureLookup, FeatureStoreClient
print(FeatureStoreClient.__module__, FeatureLookup.__module__)
"""


def test_mlflow_and_automl_names_resolve_to_the_port():
    proc = _run(MLFLOW)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == ("['sml_tpu_torch.automl', "
                        "'sml_tpu_torch.tracking']"), lines[0]
    assert lines[1] == "True True"
    assert lines[2:] == ["databricks.feature_store imported",
                         "databricks.koalas imported",
                         "sml_tpu_torch.feature_store "
                         "sml_tpu_torch.feature_store"]


ML05 = """
import os, sys, tempfile
import numpy as np
from sml_tpu_torch.compat import install_shims
install_shims()
import mlflow
from mlflow.tracking import MlflowClient
from databricks import automl
from pyspark.sql import SparkSession
from pyspark.ml import Pipeline
from pyspark.ml.feature import VectorAssembler
from pyspark.ml.regression import LinearRegression
from sml_tpu_torch.courseware import make_airbnb_dataset, wait_for_model
mlflow.set_tracking_uri(os.path.join(tempfile.mkdtemp(), "mlruns"))
spark = SparkSession.builder.getOrCreate()
spark.conf.set("sml.device", "cpu")
d = make_airbnb_dataset(n=600, seed=42)
df = spark.createDataFrame({c: d[c] for c in (
    "bedrooms", "accommodates", "room_type", "price")}).dropna()
pipe = Pipeline(stages=[VectorAssembler(inputCols=["bedrooms"],
                                        outputCol="features"),
                        LinearRegression(labelCol="price")])
with mlflow.start_run(run_name="LR-Single-Feature") as run:
    model = pipe.fit(df)
    mlflow.log_param("label", "price")
    mlflow.log_metric("rmse", 1.0)
    mlflow.spark.log_model(model, "model", registered_model_name="airbnb")
client = MlflowClient()
mv = wait_for_model("airbnb", 1)
client.transition_model_version_stage("airbnb", 1, "Production")
prod = mlflow.pyfunc.load_model("models:/airbnb/Production")
udf = mlflow.pyfunc.spark_udf(spark, f"runs:/{run.info.run_id}/model")
scored = df.withColumn("prediction", udf("bedrooms"))
runs = mlflow.search_runs(run.info.experiment_id,
                          order_by=["metrics.rmse DESC"])
summary = automl.regress(df, target_col="price", max_trials=2)
print(mv.status, client.get_model_version("airbnb", 1).current_stage,
      len(prod.predict({"bedrooms": np.ones(3)})),
      scored.count() == df.count(), runs.count(), runs.columns[:3],
      len(summary.trials))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu", "pandas",
                                    "pyarrow"))
print(bad)
"""


def test_an_ml04_ml05_ml09_shaped_flow_runs_on_the_port():
    proc = _run(ML05)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines == ["READY Production 3 True 1 ['run_id', 'experiment_id', "
                     "'status'] 2", "[]"], lines

