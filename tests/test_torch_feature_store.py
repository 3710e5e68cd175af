"""The port's feature store (`sml_tpu_torch/feature_store.py`) against
the live JAX package, on the CPU: ML 10's flow (`ML 10 - Feature
Store`) in both packages.

- `create_table` / `create_feature_table`, `read_table`, `get_table`
  and `drop_table`; a table the JAX package's client writes is read by
  the port's, and the reverse (the two share a store layout);
- `write_table` in merge mode: the JAX package's upsert (new rows
  replace old ones of the same primary key, columns united) row for row
  and partition for partition; in overwrite mode, the new frame;
- `create_training_set(...).load_df()`: the same joined frame;
- `log_model` + `score_batch`: a linear pipeline logged with its
  training set scores a batch of keys; the predictions are within the
  linear rule of `tests/test_torch_linear.py` (2e-5 of the largest
  |prediction|) of the JAX package's, for the port's model and for the
  JAX package's model scored by the port.
"""

import numpy as np
import pandas as pd
import pytest

from sml_tpu_torch import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session

from test_torch_frame_sql import assert_same_frame

LINEAR_TOL = 2e-5
FEATS = ["bedrooms", "accommodates", "bathrooms"]


@pytest.fixture(autouse=True)
def stores(tmp_path):
    from sml_tpu import tracking as jt
    from sml_tpu_torch import tracking as pt
    PCONF.set("sml.device", "cpu")
    for m in (pt, jt):
        m.set_tracking_uri(str(tmp_path / "runs"))
        m._active_experiment["id"] = None
    yield
    for m in (pt, jt):
        while m.active_run():
            m.end_run()
        m._active_experiment["id"] = None
    PCONF.unset("sml.device")


def _frames(spark, n=300, seed=4):
    """The same listings in both packages, with a listing_id."""
    d = make_airbnb_dataset(n=n, seed=seed)
    block = {"listing_id": np.arange(n, dtype=np.int64),
             **{c: d[c] for c in FEATS + ["price"]}}
    block["bedrooms"] = np.nan_to_num(block["bedrooms"], nan=1.0)
    block["bathrooms"] = np.nan_to_num(block["bathrooms"], nan=1.0)
    return spark.createDataFrame(pd.DataFrame(block)), \
        get_session().createDataFrame(block)


def _clients(tmp_path):
    from sml_tpu.feature_store import FeatureStoreClient as J
    from sml_tpu_torch.feature_store import FeatureStoreClient as P
    return J(str(tmp_path / "fs_jax")), P(str(tmp_path / "fs_port"))


def test_tables_round_trip_and_cross_read(spark, tmp_path):
    from sml_tpu_torch.feature_store import FeatureStoreClient
    jdf, pdf = _frames(spark)
    jfs, pfs = _clients(tmp_path)
    cols = ["listing_id"] + FEATS
    jt = jfs.create_table("db.feats", "listing_id", df=jdf.select(*cols),
                          description="airbnb")
    pt = pfs.create_feature_table("db.feats", ["listing_id"],
                                  features_df=pdf.select(*cols),
                                  description="airbnb")
    assert (pt.name, pt.keys, pt.features, pt.description) == \
        (jt.name, jt.keys, jt.features, jt.description)
    assert repr(pfs.get_table("db.feats")) == repr(jfs.get_table("db.feats"))
    assert_same_frame(jfs.read_table("db.feats"), pfs.read_table("db.feats"))
    # each client reads the other's store
    cross = FeatureStoreClient(str(tmp_path / "fs_jax"))
    assert_same_frame(jfs.read_table("db.feats"), cross.read_table("db.feats"))
    from sml_tpu.feature_store import FeatureStoreClient as J
    assert_same_frame(J(str(tmp_path / "fs_port")).read_table("db.feats"),
                      pfs.read_table("db.feats"))
    pfs.drop_table("db.feats")
    with pytest.raises(ValueError, match="does not exist"):
        pfs.read_table("db.feats")


@pytest.mark.parametrize("mode", ["merge", "overwrite"])
def test_write_table_modes_equal_jax(spark, tmp_path, mode):
    jdf, pdf = _frames(spark)
    jfs, pfs = _clients(tmp_path)
    jfs.create_table("feats", ["listing_id"],
                     df=jdf.select("listing_id", "bedrooms", "accommodates"))
    pfs.create_table("feats", ["listing_id"],
                     df=pdf.select("listing_id", "bedrooms", "accommodates"))
    # new rows: the keys 250..349 (250..299 replace stored rows),
    # bedrooms changed, a new column; made whole, so that no partition
    # is empty (the JAX package's withColumn types an empty partition's
    # result as object, and its table then reads back as text)
    d = make_airbnb_dataset(n=100, seed=8)
    new = {"listing_id": np.arange(250, 350, dtype=np.int64),
           "bedrooms": np.nan_to_num(d["bedrooms"], nan=2.0) * 10,
           "bathrooms": d["bathrooms"]}
    jnew = spark.createDataFrame(pd.DataFrame(new))
    pnew = get_session().createDataFrame(new)
    jfs.write_table("feats", jnew, mode=mode)
    pfs.write_table("feats", pnew, mode=mode)
    assert_same_frame(jfs.read_table("feats"), pfs.read_table("feats"))
    assert pfs.get_table("feats").features == \
        jfs.get_table("feats").features
    with pytest.raises(ValueError, match="unknown write mode"):
        pfs.write_table("feats", pnew, mode="upsert")


def test_training_set_and_score_batch_equal_jax(spark, tmp_path):
    from sml_tpu import tracking as jmlflow
    from sml_tpu.feature_store import FeatureLookup as JLookup
    from sml_tpu.ml import Pipeline as JPipeline
    from sml_tpu.ml.feature import VectorAssembler as JVA
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu_torch import tracking as pmlflow
    from sml_tpu_torch.feature_store import FeatureLookup
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import LinearRegression
    jdf, pdf = _frames(spark)
    jfs, pfs = _clients(tmp_path)
    jfs.create_table("feats", "listing_id",
                     df=jdf.select("listing_id", *FEATS))
    pfs.create_table("feats", "listing_id",
                     df=pdf.select("listing_id", *FEATS))
    jlabels = jdf.select("listing_id", "price")
    plabels = pdf.select("listing_id", "price")
    jts = jfs.create_training_set(
        jlabels, [JLookup("feats", "listing_id", FEATS[:2])], label="price",
        exclude_columns=["listing_id"])
    pts = pfs.create_training_set(
        plabels, [FeatureLookup("feats", "listing_id", FEATS[:2])],
        label="price", exclude_columns=["listing_id"])
    assert_same_frame(jts.load_df(), pts.load_df())
    jts = jfs.create_training_set(
        jlabels, [JLookup("feats", "listing_id")], label="price")
    pts = pfs.create_training_set(
        plabels, [FeatureLookup("feats", "listing_id")], label="price")
    assert_same_frame(jts.load_df(), pts.load_df())

    with jmlflow.start_run() as jrun:
        jmodel = JPipeline(stages=[
            JVA(inputCols=FEATS, outputCol="features"),
            JLR(labelCol="price")]).fit(jts.load_df())
        jfs.log_model(jmodel, "model", training_set=jts)
    with pmlflow.start_run() as prun:
        pmodel = Pipeline(stages=[
            VectorAssembler(inputCols=FEATS, outputCol="features"),
            LinearRegression(labelCol="price")]).fit(pts.load_df())
        pfs.log_model(pmodel, "model", training_set=pts,
                      registered_model_name="fs_model")
    want = jfs.score_batch(f"runs:/{jrun.info.run_id}/model", jlabels) \
        .toPandas()["prediction"].to_numpy()
    for run in (prun, jrun):  # the port's model, and the JAX package's
        got = pfs.score_batch(f"runs:/{run.info.run_id}/model", plabels)
        pred = got._whole()["prediction"]
        assert got.count() == 300 and "bedrooms" in got.columns
        np.testing.assert_allclose(pred, want, rtol=0,
                                   atol=LINEAR_TOL * np.abs(want).max())


def test_feature_table_marker():
    from sml_tpu.feature_store import feature_table as jfeature_table
    from sml_tpu_torch.feature_store import feature_table

    def compute(x):
        return x + 1

    for marker in (feature_table, jfeature_table):
        marked = marker(compute)
        assert marked(1) == 2 and marked._is_feature_table
        assert marked.__name__ == "compute"
