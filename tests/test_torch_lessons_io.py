"""The course's file-reading lessons replayed on the port, against the
JAX package's replays of the same cells (`tests/test_lessons.py:72-145`,
`:146-156`, `:257-297`, `:399-432`), on the CPU.

Each test runs a lesson's cells in both packages on the same rows, the
port's written as a course user writes them with no pandas (ML 10 takes
its `listing_id` from the frame, `monotonically_increasing_id` over one
partition, where the JAX replay takes pandas' index), and holds:

- ML 00c (Delta review): the table, its history and each version equal;
  the vacuum guard refuses;
- ML 00L (dedup lab): 103,000 rows read from the colon-separated file,
  deduplicated into 8 parquet part files; the part count and the record
  count hash to the lab's 1276280174 and 972882115; the JAX package reads
  the port's files to the frame of its own, partition for partition;
- ML 01 (cleansing): the cleansed Delta table equal to the JAX
  package's, floats bit for bit;
- ML 05L (Delta time travel with the registry): the v0 and merged
  versions equal; LinearRegression on each within the linear rule of
  `tests/test_torch_linear.py` (coefficients and intercept within 2e-5
  of the largest |value|);
- ML 10 (feature store): the training set equal; `score_batch`'s
  predictions within 2e-5 of the largest |prediction| of the JAX
  package's.
"""

import os

import numpy as np
import pandas as pd
import pytest

from sml_tpu_torch import GLOBAL_CONF as PCONF
from sml_tpu_torch import functions as PF
from sml_tpu_torch.frame.session import get_session

from test_torch_frame_sql import assert_same_frame

LINEAR_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


@pytest.fixture()
def stores(tmp_path):
    from sml_tpu import tracking as jt
    from sml_tpu_torch import tracking as pt
    for m in (pt, jt):
        m.set_tracking_uri(str(tmp_path / "mlruns"))
        m._active_experiment["id"] = None
    yield
    for m in (pt, jt):
        while m.active_run():
            m.end_run()
        m._active_experiment["id"] = None


@pytest.fixture(scope="module")
def raw(spark):
    """ML 01's entry: price as '$1,234.00' text, NULLs added to the
    bedrooms and review columns (`tests/test_lessons.py:22-33`)."""
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.column import object_array
    jpdf = jmake(n=4000, seed=42)
    block = make_airbnb_dataset(n=4000, seed=42)
    rng = np.random.default_rng(0)
    jraw = jpdf.copy()
    jraw["price"] = jraw["price"].map(lambda v: f"${v:,.2f}")
    block["price"] = object_array([f"${v:,.2f}" for v in block["price"]])
    m1 = rng.random(len(jraw)) < 0.05
    jraw.loc[m1, "bedrooms"] = np.nan
    block["bedrooms"][m1] = np.nan
    m2 = rng.random(len(jraw)) < 0.05
    jraw.loc[m2, "review_scores_rating"] = np.nan
    block["review_scores_rating"][m2] = np.nan
    return spark.createDataFrame(jraw), get_session().createDataFrame(block)


def _cleanse(df, F, Imputer):
    """ML 01's cells: price to a number, filters, NULL flags, medians."""
    fixed = df.withColumn(
        "price", F.translate(F.col("price"), "$,", "").cast("double"))
    out = fixed.filter(F.col("price") > 0) \
        .filter(F.col("minimum_nights") <= 365)
    cols = ["bedrooms", "bathrooms", "review_scores_rating"]
    for c in cols:
        out = out.withColumn(
            c + "_na", F.when(F.col(c).isNull(), 1.0).otherwise(0.0))
    return Imputer(strategy="median", inputCols=cols,
                   outputCols=cols).fit(out).transform(out)


@pytest.fixture(scope="module")
def clean_dirs(spark, raw, tmp_path_factory):
    """ML 01's Delta table, written by each package."""
    from sml_tpu import functions as JF
    from sml_tpu.ml.feature import Imputer as JImputer
    from sml_tpu_torch.ml.feature import Imputer
    base = tmp_path_factory.mktemp("lessons_io")
    out = {}
    for name, df, F, imp in (("jax", raw[0], JF, JImputer),
                             ("port", raw[1], PF, Imputer)):
        out[name] = str(base / name / "airbnb-clean")
        _cleanse(df, F, imp).write.format("delta").mode("overwrite") \
            .save(out[name])
    return out


def test_ml01_cleansed_delta_table_equals_jax(spark, clean_dirs):
    want = spark.read.format("delta").load(clean_dirs["jax"])
    got = get_session().read.format("delta").load(clean_dirs["port"])
    assert_same_frame(want, got)
    block = got._whole()
    assert (block["price"] > 0).all() and not np.isnan(
        block["bedrooms"]).any() and block["bedrooms_na"].sum() > 0
    # and each package reads the other's table to the same frame
    assert_same_frame(spark.read.format("delta").load(clean_dirs["port"]),
                      get_session().read.format("delta").load(
                          clean_dirs["jax"]))


def test_ml00c_delta_review(spark, tmp_path):
    from sml_tpu.delta.table import DeltaTable as JDeltaTable
    from sml_tpu_torch.delta.table import DeltaTable
    ps = get_session()
    paths = {n: str(tmp_path / n) for n in ("jax", "port")}
    spark.createDataFrame(pd.DataFrame({"id": [1, 2], "v": [1.0, 2.0]})) \
        .write.format("delta").mode("overwrite").save(paths["jax"])
    spark.createDataFrame(pd.DataFrame({"id": [3], "v": [3.0]})) \
        .write.format("delta").mode("append").save(paths["jax"])
    ps.createDataFrame([(1, 1.0), (2, 2.0)], ["id", "v"]) \
        .write.format("delta").mode("overwrite").save(paths["port"])
    ps.createDataFrame([(3, 3.0)], ["id", "v"]) \
        .write.format("delta").mode("append").save(paths["port"])
    jh = JDeltaTable.forPath(spark, paths["jax"]).history().collect()
    ph = DeltaTable.forPath(ps, paths["port"]).history().collect()
    assert [(r["version"], r["operationParameters"]) for r in ph] == \
        [(r["version"], r["operationParameters"]) for r in jh]
    for v in (0, 1):
        assert_same_frame(
            spark.read.format("delta").option("versionAsOf", v)
            .load(paths["jax"]),
            ps.read.format("delta").option("versionAsOf", v)
            .load(paths["port"]))
    assert ps.read.format("delta").load(paths["port"]).count() == 3
    with pytest.raises(ValueError, match="retention"):
        DeltaTable.forPath(ps, paths["port"]).vacuum(0)


def test_ml00l_dedup_lab_writes_the_labs_parquet(spark, tmp_path):
    from sml_tpu import courseware as jcw
    from sml_tpu import functions as JF
    from sml_tpu_torch import courseware as pcw
    from sml_tpu_torch.frame.io import write_csv_file
    ps = get_session()
    src = {"jax": str(tmp_path / "jax.txt"), "port": str(tmp_path / "p.txt")}
    jcw.make_dedup_dataset().to_csv(src["jax"], index=False, sep=":")
    write_csv_file(pcw.make_dedup_dataset()._whole(), src["port"], sep=":")
    with open(src["jax"], "rb") as a, open(src["port"], "rb") as b:
        assert a.read() == b.read()
    dest = {}
    for name, s, F in (("jax", spark, JF), ("port", ps, PF)):
        old = s.conf.get("spark.sql.shuffle.partitions")
        s.conf.set("spark.sql.shuffle.partitions", 8)
        try:
            df = s.read.option("header", "true") \
                .option("inferSchema", "true").option("sep", ":") \
                .csv(src[name])
            deduped = df.select(
                F.col("*"),
                F.lower(F.col("firstName")).alias("lcFirstName"),
                F.lower(F.col("lastName")).alias("lcLastName"),
                F.lower(F.col("middleName")).alias("lcMiddleName"),
                F.translate(F.col("ssn"), "-", "").alias("ssnNums")) \
                .dropDuplicates(["lcFirstName", "lcMiddleName", "lcLastName",
                                 "ssnNums", "gender", "birthDate", "salary"]) \
                .drop("lcFirstName", "lcMiddleName", "lcLastName", "ssnNums")
            dest[name] = str(tmp_path / f"{name}.parquet")
            deduped.write.mode("overwrite").parquet(dest[name])
        finally:
            s.conf.set("spark.sql.shuffle.partitions", old)
    parts = len([f for f in os.listdir(dest["port"])
                 if f.endswith(".parquet")])
    final = ps.read.parquet(dest["port"])
    results = pcw.TestResults()
    assert results.validate_your_answer("01 Parquet File Exists",
                                        1276280174, parts)
    assert results.validate_your_answer("02 Expected 100000 Records",
                                        972882115, final.count())
    assert_same_frame(spark.read.parquet(dest["jax"]), final)
    assert_same_frame(spark.read.parquet(dest["port"]),
                      ps.read.parquet(dest["jax"]))


def _fit_lr(frame, cols, VA, LR):
    fdf = VA(inputCols=cols, outputCol="features").transform(frame)
    return LR(labelCol="price").fit(fdf)


def test_ml05l_delta_versions_and_their_fits(spark, clean_dirs, tmp_path,
                                             stores):
    from sml_tpu import functions as JF
    from sml_tpu import tracking as jmlflow
    from sml_tpu.ml.feature import VectorAssembler as JVA
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu_torch import tracking as pmlflow
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import LinearRegression
    ps = get_session()
    models = {}
    for name, s, F, VA, LR, mlflow in (
            ("jax", spark, JF, JVA, JLR, jmlflow),
            ("port", ps, PF, VectorAssembler, LinearRegression, pmlflow)):
        p = str(tmp_path / name)
        df = s.read.format("delta").load(clean_dirs[name])
        df.select("bedrooms", "accommodates", "price") \
            .write.format("delta").mode("overwrite").save(p)
        with mlflow.start_run() as r1:
            m1 = _fit_lr(s.read.format("delta").load(p), ["bedrooms"], VA, LR)
            mlflow.spark.log_model(m1, "model")
        mlflow.register_model(f"runs:/{r1.info.run_id}/model", f"{name}_lr")
        df.select("bedrooms", "accommodates", "price") \
            .withColumn("log_price", F.log(F.col("price"))) \
            .write.format("delta").mode("overwrite") \
            .option("mergeSchema", "true").save(p)
        with mlflow.start_run() as r2:
            m2 = _fit_lr(s.read.format("delta").load(p),
                         ["bedrooms", "accommodates"], VA, LR)
            mlflow.spark.log_model(m2, "model")
        mv2 = mlflow.register_model(f"runs:/{r2.info.run_id}/model",
                                    f"{name}_lr")
        assert int(mv2.version) == 2
        m0 = _fit_lr(s.read.format("delta").option("versionAsOf", 0).load(p),
                     ["bedrooms"], VA, LR)
        models[name] = (m1, m2, m0, p)
    for v in (0, 1):
        assert_same_frame(
            spark.read.format("delta").option("versionAsOf", v)
            .load(models["jax"][3]),
            ps.read.format("delta").option("versionAsOf", v)
            .load(models["port"][3]))
    assert "log_price" not in ps.read.format("delta").option(
        "versionAsOf", 0).load(models["port"][3]).columns
    for k in range(3):
        j, p = models["jax"][k], models["port"][k]
        want = np.append(np.asarray(j.coefficients.toArray()), j.intercept)
        got = np.append(np.asarray(p.coefficients.toArray()), p.intercept)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LINEAR_TOL * np.abs(want).max())
    # the time-travelled v0 fit is the first run's model
    np.testing.assert_array_equal(models["port"][2].coefficients.toArray(),
                                  models["port"][0].coefficients.toArray())


def test_ml10_feature_store_from_the_delta_table(spark, clean_dirs,
                                                 tmp_path, stores):
    from sml_tpu import tracking as jmlflow
    from sml_tpu.feature_store import FeatureLookup as JLookup
    from sml_tpu.feature_store import FeatureStoreClient as JClient
    from sml_tpu.ml import Pipeline as JPipeline
    from sml_tpu.ml.feature import VectorAssembler as JVA
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu_torch import tracking as pmlflow
    from sml_tpu_torch.feature_store import FeatureLookup, \
        FeatureStoreClient
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import LinearRegression
    ps = get_session()
    # the JAX replay's cells (tests/test_lessons.py:399-432)
    jfs = JClient(str(tmp_path / "fs_jax"))
    jdf = spark.read.format("delta").load(clean_dirs["jax"])
    pdf = jdf.toPandas().reset_index().rename(
        columns={"index": "listing_id"})
    jfeats = spark.createDataFrame(
        pdf[["listing_id", "bedrooms", "accommodates"]])
    jfs.create_table(name="lessons_fs.features", primary_keys=["listing_id"],
                     df=jfeats, description="airbnb features")
    jlabels = spark.createDataFrame(pdf[["listing_id", "price"]])
    jts = jfs.create_training_set(
        jlabels, [JLookup(table_name="lessons_fs.features",
                          lookup_key="listing_id")], label="price")
    with jmlflow.start_run() as jrun:
        jmodel = JPipeline(stages=[
            JVA(inputCols=["bedrooms", "accommodates"],
                outputCol="features"),
            JLR(labelCol="price")]).fit(jts.load_df())
        jfs.log_model(jmodel, "model", training_set=jts,
                      registered_model_name="lessons_fs_model")
    want = jfs.score_batch(f"runs:/{jrun.info.run_id}/model", jlabels) \
        .toPandas()["prediction"].to_numpy()

    # the port's, as a course user writes them without pandas
    fs = FeatureStoreClient(str(tmp_path / "fs_port"))
    df = ps.read.format("delta").load(clean_dirs["port"]).coalesce(1) \
        .withColumn("listing_id", PF.monotonically_increasing_id())
    fs.create_table(name="lessons_fs.features", primary_keys=["listing_id"],
                    df=df.select("listing_id", "bedrooms", "accommodates"),
                    description="airbnb features")
    labels = df.select("listing_id", "price")
    ts = fs.create_training_set(
        labels, [FeatureLookup(table_name="lessons_fs.features",
                               lookup_key="listing_id")], label="price")
    got_ts = ts.load_df()._whole()
    want_ts = jts.load_df().toPandas()
    for c in want_ts.columns:
        np.testing.assert_array_equal(got_ts[c], want_ts[c].to_numpy())
    with pmlflow.start_run() as run:
        model = Pipeline(stages=[
            VectorAssembler(inputCols=["bedrooms", "accommodates"],
                            outputCol="features"),
            LinearRegression(labelCol="price")]).fit(ts.load_df())
        fs.log_model(model, "model", training_set=ts,
                     registered_model_name="lessons_fs_model_port")
    scored = fs.score_batch(f"runs:/{run.info.run_id}/model", labels)
    got = scored._whole()["prediction"]
    assert scored.count() == len(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LINEAR_TOL * np.abs(want).max())
