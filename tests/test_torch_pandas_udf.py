"""The port's pandas function API against the JAX package's live one, on
the CPU: `pandas_udf` (scalar, several columns, scalar iterator), the
row `udf`, `mapInPandas`, `applyInPandas` with its split cache,
`DataFrame.from_pandas`, the pandas / Arrow type surface of
`frame.types`, and the course's ML 12 and ML 13 flows
(`tests/test_lessons.py:460-514`).

Both packages get the same rows (the Airbnb fixture, or numpy-made
frames) and the same user function, which records what it is handed.
Held equal to the JAX package's:

- what user code receives: under `sml.arrow.maxRecordsPerBatch=100`
  the sequence of batch lengths, and each Series or frame's columns,
  dtypes and values; `applyInPandas`' groups in the same order (at
  parallelism 1) or the same set (at 8);
- what comes back: the result frame partition for partition, ints and
  strings exactly and floats bit for bit (`rtol=0`: both run the same
  numpy / sklearn body on the same rows);
- ML 12: a random forest fitted in the JAX package and carried into the
  port through its loader, scored in `mapInPandas` by each package's
  `DeviceScorer` and through each package's pyfunc `spark_udf`, within
  `tests/test_torch_inference.py`'s tolerances (rtol 1e-5, atol 1e-5 of
  the largest |prediction|: the f32 sums over trees run in another
  order); the port's body reaches the traversal's plain version once a
  batch.
"""

from typing import Iterator

import numpy as np
import pandas as pd
import pytest

from sml_tpu_torch import GLOBAL_CONF as PCONF
from sml_tpu_torch.frame import functions as PF
from sml_tpu_torch.frame import types as PT
from sml_tpu_torch.frame.column import block_len
from sml_tpu_torch.frame.dataframe import DataFrame as PDataFrame
from sml_tpu_torch.frame.session import get_session

from test_torch_frame_sql import assert_same_frame

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


@pytest.fixture()
def batch100():
    """`sml.arrow.maxRecordsPerBatch=100` in both packages."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    old = JCONF.get("sml.arrow.maxRecordsPerBatch")
    JCONF.set("sml.arrow.maxRecordsPerBatch", 100)
    PCONF.set("sml.arrow.maxRecordsPerBatch", 100)
    yield
    JCONF.set("sml.arrow.maxRecordsPerBatch", old)
    PCONF.unset("sml.arrow.maxRecordsPerBatch")


@pytest.fixture()
def both(spark, airbnb_pdf):
    """The Airbnb fixture as a JAX frame and a port frame."""
    return spark.createDataFrame(airbnb_pdf), \
        get_session().createDataFrame(airbnb_pdf)


def _values(s) -> list:
    return [None if isinstance(v, float) and v != v else v
            for v in s.tolist()]


def _series(s: pd.Series) -> tuple:
    """What user code saw of a Series."""
    return s.name, str(s.dtype), _values(s)


def _frame(f: pd.DataFrame) -> tuple:
    """What user code saw of a frame."""
    return (list(f.columns), [str(t) for t in f.dtypes],
            [_values(f[c]) for c in f.columns])


def _pair():
    import sml_tpu.frame.functions as JF
    return {"jax": JF, "port": PF}


# --------------------------------------------------------- pandas_udf
def test_scalar_pandas_udf(both):
    seen = {"jax": [], "port": []}
    out = {}
    for (who, F), df in zip(_pair().items(), both):
        @F.pandas_udf("double")
        def double_price(p: pd.Series, who=who) -> pd.Series:
            seen[who].append(_series(p))
            return p * 2.0
        out[who] = df.withColumn("p2", double_price(F.col("price")))
    assert_same_frame(out["jax"], out["port"])
    assert seen["jax"] == seen["port"] and len(seen["port"]) == 8
    got = out["port"]._whole()
    np.testing.assert_array_equal(got["p2"], got["price"] * 2.0)


def test_scalar_udf_multi_column(both):
    seen = {"jax": [], "port": []}
    out = {}
    for (who, F), df in zip(_pair().items(), both):
        @F.pandas_udf("double")
        def total_beds(bed: pd.Series, acc: pd.Series, who=who
                       ) -> pd.Series:
            seen[who].append((_series(bed), _series(acc)))
            return bed + acc
        out[who] = df.withColumn("t", total_beds("bedrooms", "accommodates"))
    assert_same_frame(out["jax"], out["port"])
    assert seen["jax"] == seen["port"]


def test_iterator_pandas_udf_loads_once(both, batch100):
    loads = {"jax": [], "port": []}
    lengths = {"jax": [], "port": []}
    out = {}

    def make(F, who):
        @F.pandas_udf("double")
        def predict(iterator: Iterator[pd.Series]) -> Iterator[pd.Series]:
            loads[who].append(1)  # "model load" once a partition
            for batch in iterator:
                lengths[who].append(len(batch))
                yield batch * 0.5
        return predict

    for (who, F), df in zip(_pair().items(), both):
        out[who] = df.withColumn("h", make(F, who)(F.col("price")))
    assert_same_frame(out["jax"], out["port"])
    assert lengths["jax"] == lengths["port"]
    assert max(lengths["port"]) == 100 and sum(lengths["port"]) == 2000
    assert len(loads["port"]) == len(loads["jax"]) \
        == both[1].rdd.getNumPartitions()


def test_iterator_pandas_udf_of_several_columns_gets_tuples(both, batch100):
    seen = {"jax": [], "port": []}
    out = {}
    def make(F, who):
        @F.pandas_udf("double")
        def ratio(iterator: Iterator[tuple]) -> Iterator[pd.Series]:
            for bed, acc in iterator:
                seen[who].append((_series(bed), _series(acc)))
                yield bed / acc
        return ratio

    for (who, F), df in zip(_pair().items(), both):
        out[who] = df.select("id", make(F, who)("bedrooms", "accommodates")
                             .alias("r"))
    assert_same_frame(out["jax"], out["port"])
    assert seen["jax"] == seen["port"]


def test_row_udf(both):
    out = {}
    for (who, F), df in zip(_pair().items(), both):
        @F.udf
        def room_upper(rt):
            return rt.upper()
        out[who] = df.withColumn("ru", room_upper(F.col("room_type")))
    assert_same_frame(out["jax"].limit(5), out["port"].limit(5))
    assert_same_frame(out["jax"], out["port"])


def test_pandas_udf_decorator_loads_no_pandas_module_state():
    """The decorator only inspects the signature: the column evaluates
    later, through the bridge."""
    @PF.pandas_udf(PT.DoubleType())
    def f(s):
        return s + 1
    col = f("x")
    assert f.__wrapped__.__name__ == "f" and col._name == "f"
    df = get_session().createDataFrame({"x": np.arange(5.0)})
    np.testing.assert_array_equal(df.select(col)._whole()["f"],
                                  np.arange(5.0) + 1)


# -------------------------------------------------------- mapInPandas
def test_map_in_pandas(both, batch100):
    seen = {"jax": [], "port": []}
    out = {}
    for (who, _), df in zip(_pair().items(), both):
        def scale(iterator, who=who):
            for pdf in iterator:
                seen[who].append(_frame(pdf))
                pdf = pdf.copy()
                pdf["price"] = pdf["price"] / 10
                yield pdf[["id", "price"]]
        out[who] = df.mapInPandas(scale, "id bigint, price double")
    assert_same_frame(out["jax"], out["port"])
    assert seen["jax"] == seen["port"]
    assert [len(v[2][0]) for v in seen["port"]] == [100, 100, 50] * 8
    assert out["port"].count() == both[1].count()


@pytest.mark.parametrize("case", ["empty", "cast", "missing", "reorder"])
def test_map_in_pandas_casts_to_the_schema(spark, case):
    """What the function yields is cast to the schema as the JAX package
    casts it: no output at all (one empty partition), numbers and text
    cast, a missing column NULL, columns put in the schema's order."""
    rng = np.random.default_rng(3)
    cols = {"i": rng.integers(0, 9, 300), "x": rng.normal(size=300)}
    bodies = {
        "empty": (lambda it: iter(()), "i bigint, x double"),
        "cast": (lambda it: (pd.DataFrame({"i": b["x"].round(),
                                           "x": b["i"], "s": b["i"] * 2})
                             for b in it), "i bigint, x double, s string"),
        "missing": (lambda it: (b[["x"]] for b in it),
                    "i bigint, x double, b boolean"),
        "reorder": (lambda it: (b[["x", "i"]] for b in it),
                    "i bigint, x double")}
    fn, schema = bodies[case]
    j = spark.createDataFrame(pd.DataFrame(cols)).mapInPandas(fn, schema)
    p = get_session().createDataFrame(cols).mapInPandas(fn, schema)
    assert_same_frame(j, p)
    assert p.columns == [f.name for f in PT.parse_schema(schema).fields]


# ------------------------------------------------------ applyInPandas
def _devices(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    pdf = pd.DataFrame({"device_id": rng.integers(0, 10, n),
                        "feature": rng.random(n)})
    pdf["label"] = pdf["feature"] * (pdf["device_id"] + 1) \
        + rng.normal(0, 0.01, n)
    return pdf


@pytest.mark.parametrize("parallelism", [1, 8])
def test_apply_in_pandas_training(spark, parallelism):
    """ML 13's shape: one sklearn fit a device, groups in order of first
    appearance with the key columns; outputs partition for partition."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    pdf = _devices()
    seen = {"jax": [], "port": []}
    out = {}
    old = JCONF.get("sml.applyInPandas.parallelism")
    JCONF.set("sml.applyInPandas.parallelism", parallelism)
    PCONF.set("sml.applyInPandas.parallelism", parallelism)
    try:
        for who, df in (("jax", spark.createDataFrame(pdf)),
                        ("port", get_session().createDataFrame(pdf))):
            def train_model(g: pd.DataFrame, who=who) -> pd.DataFrame:
                from sklearn.linear_model import LinearRegression
                seen[who].append(_frame(g))
                m = LinearRegression().fit(g[["feature"]], g["label"])
                return pd.DataFrame({"device_id": [g["device_id"].iloc[0]],
                                     "n_used": [len(g)],
                                     "coef": [float(m.coef_[0])]})
            out[who] = df.groupby("device_id").applyInPandas(
                train_model, "device_id bigint, n_used bigint, coef double")
            out[who].count()
    finally:
        JCONF.set("sml.applyInPandas.parallelism", old)
        PCONF.unset("sml.applyInPandas.parallelism")
    assert_same_frame(out["jax"], out["port"])
    if parallelism == 1:
        assert seen["jax"] == seen["port"]
    else:
        assert sorted(seen["jax"], key=lambda f: f[2][0][0]) == \
            sorted(seen["port"], key=lambda f: f[2][0][0])
    got = out["port"]._whole()
    assert block_len(got) == 10 and got["n_used"].sum() == 5000
    np.testing.assert_allclose(got["coef"], got["device_id"] + 1, atol=0.05)


def test_apply_in_pandas_null_keys_and_computed_keys(spark):
    """NULL keys form a group of their own; a computed key is a column of
    the handed-out group; an empty frame gives one empty partition."""
    rng = np.random.default_rng(1)
    k = rng.choice(["b", "a", "c"], 400).astype(object)
    k[rng.random(400) < 0.1] = None
    cols = {"k": k, "x": rng.normal(size=400)}
    jpdf = pd.DataFrame({"k": pd.Series(k, dtype=object), "x": cols["x"]})

    def size(g):
        return pd.DataFrame({"k": [g["k"].iloc[0]], "n": [len(g)],
                             "s": [float(g["x"].sum())]})

    import sml_tpu.frame.functions as JF
    j = spark.createDataFrame(jpdf)
    p = get_session().createDataFrame(cols)
    sch = "k string, n bigint, s double"
    assert_same_frame(j.groupBy("k").applyInPandas(size, sch),
                      p.groupBy("k").applyInPandas(size, sch))
    jk = j.groupBy((JF.col("x") > 0).alias("pos"))
    pk = p.groupBy((PF.col("x") > 0).alias("pos"))

    def pos(g):
        return pd.DataFrame({"pos": [bool(g["pos"].iloc[0])], "n": [len(g)]})

    assert_same_frame(jk.applyInPandas(pos, "pos boolean, n bigint"),
                      pk.applyInPandas(pos, "pos boolean, n bigint"))
    none_j, none_p = j.filter(JF.col("x") > 99), p.filter(PF.col("x") > 99)
    assert_same_frame(none_j.groupBy("k").applyInPandas(size, sch),
                      none_p.groupBy("k").applyInPandas(size, sch))


def test_shuffle_reuse_cache_and_unpersist(spark, monkeypatch):
    """`tests/test_frame.py:264-305` on the port: the split of a cached
    frame is reused (no second split), a mutating fn pollutes neither
    the cache nor the source, `unpersist` drops the entry, and a 0-byte
    budget caches nothing; the results equal the JAX package's."""
    from sml_tpu_torch.frame import grouped as G
    cols = {"k": np.asarray(["a", "b", "c"] * 400, dtype=object),
            "v": np.arange(1200, dtype=float)}
    df = get_session().createDataFrame(cols)
    df.cache()

    def fn(g):
        g["v"] = -1.0  # hostile in-place write
        return pd.DataFrame({"k": [g["k"].iloc[0]], "n": [len(g)],
                             "v": [float(g["v"].sum())]})

    splits = []
    real = G.group_rows
    monkeypatch.setattr(G, "group_rows",
                        lambda *a: splits.append(1) or real(*a))
    sch = "k string, n bigint, v double"
    r1 = df.groupby("k").applyInPandas(fn, sch)
    r1.count()
    token = df._whole()
    with G._split_lock:
        assert any(v[0] is token for v in G._split_cache.values())
    r2 = df.groupby("k").applyInPandas(fn, sch)
    assert [(c, v.tolist()) for c, v in r2._whole().items()] == \
        [(c, v.tolist()) for c, v in r1._whole().items()]
    assert len(splits) == 1  # the second run reused the split
    assert sorted(r2._whole()["n"].tolist()) == [400, 400, 400]
    assert float(df._whole()["v"].min()) >= 0  # source unpolluted
    with G._split_lock:
        cached = [v[1] for v in G._split_cache.values() if v[0] is token]
    assert all((g["v"] >= 0).all() for g in cached[0])
    jdf = spark.createDataFrame(pd.DataFrame(cols))
    assert_same_frame(jdf.groupby("k").applyInPandas(fn, sch), r1)
    df.unpersist()
    with G._split_lock:
        assert not any(v[0] is token for v in G._split_cache.values())

    PCONF.set("sml.shuffle.reuseBytes", 0)
    try:
        df2 = get_session().createDataFrame(cols)
        df2.cache()
        df2.groupby("k").applyInPandas(fn, sch).count()
        tok2 = df2._whole()
        with G._split_lock:
            assert not any(v[0] is tok2 for v in G._split_cache.values())
    finally:
        PCONF.unset("sml.shuffle.reuseBytes")


def test_apply_in_pandas_with_state_and_pivot_still_raise():
    g = get_session().createDataFrame({"k": np.arange(3)}).groupBy("k")
    with pytest.raises(NotImplementedError):
        g.applyInPandasWithState(None)
    with pytest.raises(NotImplementedError):
        g.pivot("k")


# ------------------------------------------------------- from_pandas
@pytest.mark.parametrize("parts", [None, 1, 3, 5000])
def test_from_pandas_partitions(spark, airbnb_pdf, parts):
    from sml_tpu.frame.dataframe import DataFrame as JDataFrame
    j = JDataFrame.from_pandas(airbnb_pdf, session=spark,
                               num_partitions=parts)
    p = PDataFrame.from_pandas(airbnb_pdf, session=get_session(),
                               num_partitions=parts)
    assert_same_frame(j, p)
    assert p.getNumPartitions() == (8 if parts is None
                                    else min(parts, len(airbnb_pdf)))


# -------------------------------------------------------- frame.types
TYPES = ["string", "double", "float", "int", "bigint", "boolean",
         "timestamp", "date", "vector"]


@pytest.mark.parametrize("name", TYPES)
def test_types_name_the_jax_packages_arrow_and_pandas_types(name):
    import sml_tpu.frame.types as JT
    j, p = JT.parse_type(name), PT.parse_type(name)
    assert p.to_pandas_dtype() == j.to_pandas_dtype()
    assert p.to_arrow() == j.to_arrow()
    assert PT.VectorType(4).to_arrow() == JT.VectorType(4).to_arrow()


def test_arrow_to_sml_and_struct_to_arrow():
    import pyarrow as pa
    import sml_tpu.frame.types as JT
    arrow = [pa.string(), pa.large_string(), pa.float64(), pa.float32(),
             pa.int64(), pa.int32(), pa.int16(), pa.uint8(), pa.bool_(),
             pa.timestamp("us"), pa.timestamp("ns"), pa.date32(),
             pa.list_(pa.float32()), pa.list_(pa.float64(), 3),
             pa.binary(), pa.null()]
    assert [PT.arrow_to_sml(t).simpleString() for t in arrow] == \
        [JT.arrow_to_sml(t).simpleString() for t in arrow]
    sch = "a double, b string, c bigint, d vector, e timestamp"
    assert PT.parse_schema(sch).to_arrow() == JT.parse_schema(sch).to_arrow()


def test_infer_schema_from_pandas():
    import sml_tpu.frame.types as JT
    n = 4
    pdf = pd.DataFrame({
        "f64": np.arange(n, dtype=np.float64),
        "f32": np.arange(n, dtype=np.float32),
        "i64": np.arange(n), "i32": np.arange(n, dtype=np.int32),
        "u8": np.arange(n, dtype=np.uint8),
        "b": np.arange(n) > 1, "s": ["a", "b", None, "d"],
        "o": pd.Series([1, "x", 2.5, None], dtype=object),
        "ts": pd.date_range("2020-01-01", periods=n),
        "lst": [[1.0, 2.0]] * n,
        "arr": [np.zeros(3)] * n,
        "lst_null": [[1.0], None, [2.0], [3.0]],
        "Int64": pd.array([1, None, 3, 4], dtype="Int64")})
    got = PT.infer_schema_from_pandas(pdf)
    want = JT.infer_schema_from_pandas(pdf)
    assert [(f.name, f.dataType.simpleString()) for f in got.fields] == \
        [(f.name, f.dataType.simpleString()) for f in want.fields]
    empty = pdf.iloc[:0]
    assert PT.infer_schema_from_pandas(empty).simpleString() == \
        JT.infer_schema_from_pandas(empty).simpleString()


# ------------------------------------------------- the course's flows
@pytest.fixture(scope="module")
def delta_path(spark, tmp_path_factory):
    """The course's clean Airbnb table, written by the JAX package."""
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    path = str(tmp_path_factory.mktemp("pandas_udf") / "airbnb-clean")
    spark.createDataFrame(jmake(n=3000, seed=42).dropna()) \
        .write.format("delta") \
        .mode("overwrite").save(path)
    return path


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


def _close(got, want):
    got, want = np.asarray(got, dtype=np.float64), \
        np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_ml12_pandas_udf_inference(spark, delta_path, stores, tmp_path,
                                   batch100, monkeypatch):
    """ML 12 (`ML 12:101-143`): load-once scoring through mapInPandas,
    and the pyfunc `spark_udf`, on a forest the JAX package fitted."""
    from sml_tpu import tracking as jm
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.ml import DeviceScorer as JScorer
    from sml_tpu.ml import Pipeline as JPipeline
    from sml_tpu.ml.feature import StringIndexer, VectorAssembler
    from sml_tpu.ml.regression import RandomForestRegressor
    from sml_tpu_torch import tracking as pm
    from sml_tpu_torch.ml import DeviceScorer
    from sml_tpu_torch.ml.base import load
    from sml_tpu_torch.native import traverse_kernel as tk
    jdf = spark.read.format("delta").load(delta_path)
    pdf = get_session().read.format("delta").load(delta_path)
    jtrain, jtest = jdf.randomSplit([.8, .2], seed=42)
    _, ptest = pdf.randomSplit([.8, .2], seed=42)
    assert_same_frame(jtest, ptest)
    prev = JCONF.get("sml.tree.kernel")
    JCONF.set("sml.tree.kernel", "xla")
    try:
        jmodel = JPipeline(stages=[
            StringIndexer(inputCols=["room_type"],
                          outputCols=["room_typeIndex"], handleInvalid="skip"),
            VectorAssembler(inputCols=["room_typeIndex", "bedrooms",
                                       "accommodates"], outputCol="features"),
            RandomForestRegressor(labelCol="price", numTrees=5, maxDepth=4,
                                  seed=42)]).fit(jtrain)
    finally:
        JCONF.set("sml.tree.kernel", prev)
    jmodel.save(str(tmp_path / "ml12"))
    pmodel = load(str(tmp_path / "ml12"))
    traversals = []
    plain = tk.forest_margin_plain
    monkeypatch.setattr(tk, "forest_margin_plain",
                        lambda *a, **k: traversals.append(1) or plain(*a, **k))

    def predict_with(scorer):
        def predict(iterator):
            for features in iterator:
                yield pd.DataFrame({"prediction": scorer(features)})
        return predict

    j = jtest.mapInPandas(predict_with(JScorer(jmodel)), "prediction double")
    p = ptest.mapInPandas(predict_with(DeviceScorer(pmodel, device="cpu")),
                          "prediction double")
    assert [len(x) for x in j._materialize()] == \
        [block_len(x) for x in p._materialize()]
    _close(p._whole()["prediction"], j.toPandas()["prediction"])
    n_batches = sum(-(-block_len(b) // 100) for b in ptest._materialize())
    assert len(traversals) == n_batches

    with jm.start_run() as jrun:
        jm.spark.log_model(jmodel, "model")
    with pm.start_run() as prun:
        pm.spark.log_model(pmodel, "model")
    judf = jm.pyfunc.spark_udf(spark, f"runs:/{jrun.info.run_id}/model")
    pudf = pm.pyfunc.spark_udf(get_session(),
                               f"runs:/{prun.info.run_id}/model")
    jout = jtest.withColumn("prediction", judf(*jtest.columns)).toPandas()
    pout = ptest.withColumn("prediction", pudf(*ptest.columns))._whole()
    assert np.isfinite(pout["prediction"]).all()
    _close(pout["prediction"], jout["prediction"])
    # the pyfunc model takes a pandas frame too, as does the scorer
    model = pm.pyfunc.load_model(f"runs:/{prun.info.run_id}/model")
    batch = ptest.toPandas()
    _close(model.predict(batch), jout["prediction"])
    _close(DeviceScorer(pmodel, device="cpu")(batch), jout["prediction"])


def test_scorer_on_a_pandas_batch_missing_a_column_raises_keyerror(
        delta_path, tmp_path):
    from sml_tpu_torch.ml import DeviceScorer, Pipeline
    from sml_tpu_torch.ml.feature import StringIndexer, VectorAssembler
    from sml_tpu_torch.ml.regression import DecisionTreeRegressor
    df = get_session().read.format("delta").load(delta_path)
    model = Pipeline(stages=[
        StringIndexer(inputCols=["room_type"], outputCols=["room_typeIndex"],
                      handleInvalid="skip"),
        VectorAssembler(inputCols=["room_typeIndex", "bedrooms"],
                        outputCol="features"),
        DecisionTreeRegressor(labelCol="price", maxDepth=3)]).fit(df)
    scorer = DeviceScorer(model, device="cpu")
    batch = df.limit(50).toPandas()
    want = scorer(df.limit(50))
    with pytest.raises(KeyError, match="bedrooms"):
        scorer(batch.drop(columns=["bedrooms"]))
    np.testing.assert_array_equal(scorer(batch), want)


def test_ml13_pandas_function_api(spark, delta_path):
    """ML 13 (`ML 13:119-161`): a sklearn model a room type through
    applyInPandas; the outputs partition for partition, bit for bit."""
    outs = {}
    for who, df in (("jax", spark.read.format("delta").load(delta_path)),
                    ("port", get_session().read.format("delta")
                     .load(delta_path))):
        def train_model(pdf):
            from sklearn.linear_model import LinearRegression as SkLR
            g = pdf.dropna(subset=["bedrooms", "accommodates", "price"])
            m = SkLR().fit(g[["bedrooms", "accommodates"]], g["price"])
            mse = float(np.mean(
                (m.predict(g[["bedrooms", "accommodates"]]) - g["price"])
                ** 2))
            return pd.DataFrame({"room_type": [g["room_type"].iloc[0]],
                                 "n_used": [len(g)], "mse": [mse]})
        outs[who] = df.groupby("room_type").applyInPandas(
            train_model, "room_type string, n_used bigint, mse double")
    assert_same_frame(outs["jax"], outs["port"])
    got = outs["port"]._whole()
    assert block_len(got) == 3 and np.isfinite(got["mse"]).all()
