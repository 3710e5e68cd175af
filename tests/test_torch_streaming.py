"""The port's micro-batch streaming (`sml_tpu_torch/streaming`) on the
CPU, held against the live JAX package on the same part files.

- MLE 00's flow (tests/test_lessons.py:535-557): parquet parts written
  by the port's codec, `readStream.format("parquet")` with
  `maxFilesPerTrigger` 1, a VectorAssembler and a fitted
  LinearRegression's `transform`, a memory sink with a checkpoint, and
  `spark.sql` counting the sink. Both packages count the same rows in
  the same number of micro-batches; the port's predictions equal its
  batch `transform` of the same rows bit for bit, and the JAX package's
  within 2e-5 of the largest |prediction| (the rule of
  tests/test_torch_linear.py: the port's Gram sums in float64, the JAX
  package's in f32).
- A restart on the checkpoint skips the files already processed, in
  both packages; `trigger(once=True)` processes what is there and ends;
  `stop()` joins the trigger thread; a failed trigger ends the query
  and surfaces through `exception()`, `awaitTermination()` and
  `processAllAvailable()` (the JAX package keeps it in `exception()`).
- `spark.streams`, a CSV source, a Delta sink, and `writeStream` on a
  static frame (refused, as in Spark).
"""

import json
import os

import numpy as np
import pytest

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.frame import parquet as ppq
from sml_tpu_torch.frame.session import get_session

PRED_TOL = 2e-5
PARTS, ROWS = 3, 100


@pytest.fixture(autouse=True)
def port_cpu():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


def _table(n=PARTS * ROWS, seed=0):
    rng = np.random.default_rng(seed)
    bedrooms = rng.integers(0, 5, n).astype(float)
    accommodates = bedrooms * 2 + rng.integers(1, 3, n)
    return {"id": np.arange(n, dtype=np.int64),
            "room_type": np.array(rng.choice(["Entire home/apt",
                                              "Private room"], n),
                                  dtype=object),
            "bedrooms": bedrooms,
            "accommodates": accommodates.astype(float),
            "price": np.round(np.exp(4.0 + 0.35 * bedrooms
                                     + 0.08 * accommodates
                                     + rng.normal(0, 0.4, n)), 2)}


def _write_parts(directory, table, parts=PARTS, start=0):
    os.makedirs(directory, exist_ok=True)
    for i in range(start, start + parts):
        ppq.write_table({k: v[i * ROWS:(i + 1) * ROWS]
                         for k, v in table.items()},
                        os.path.join(directory, f"part-{i}.parquet"))


def _port_flow(src, ckpt, name="mle00_preds", trigger=None, **opts):
    """(session, model, vec, query) of MLE 00's flow in the port."""
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import LinearRegression
    spark = get_session()
    df = spark.read.parquet(src)
    vec = VectorAssembler(inputCols=["bedrooms", "accommodates"],
                          outputCol="features")
    model = LinearRegression(labelCol="price").fit(vec.transform(df))
    stream = spark.readStream.format("parquet") \
        .option("maxFilesPerTrigger", 1).schema(df.schema).load(src)
    w = model.transform(vec.transform(stream)).writeStream \
        .format("memory").queryName(name) \
        .option("checkpointLocation", ckpt)
    w = w.trigger(**trigger) if trigger else \
        w.trigger(processingTime="0 seconds")
    return spark, model, vec, df, w.start()


def _jax_flow(spark, src, ckpt, name="mle00_preds_jax", trigger=None):
    from sml_tpu.ml.feature import VectorAssembler
    from sml_tpu.ml.regression import LinearRegression
    df = spark.read.parquet(src)
    vec = VectorAssembler(inputCols=["bedrooms", "accommodates"],
                          outputCol="features")
    model = LinearRegression(labelCol="price").fit(vec.transform(df))
    stream = spark.readStream.format("parquet") \
        .option("maxFilesPerTrigger", 1).schema(df.schema).load(src)
    w = model.transform(vec.transform(stream)).writeStream \
        .format("memory").queryName(name) \
        .option("checkpointLocation", ckpt)
    w = w.trigger(**trigger) if trigger else \
        w.trigger(processingTime="0 seconds")
    return w.start()


def test_mle00_streaming_inference_matches_the_jax_package(spark,
                                                            tmp_path):
    src = str(tmp_path / "stream-src")
    _write_parts(src, _table())
    pspark, model, vec, df, q = _port_flow(src, str(tmp_path / "ckpt"))
    jq = _jax_flow(spark, src, str(tmp_path / "jckpt"))
    try:
        q.processAllAvailable()
        jq.processAllAvailable()
        n = pspark.sql("SELECT count(*) AS n FROM mle00_preds").collect()
        jn = spark.sql("SELECT count(*) AS n FROM mle00_preds_jax") \
            .toPandas()
        assert n[0]["n"] == int(jn["n"].iloc[0]) == PARTS * ROWS
        assert len(q.recentProgress) == len(jq.recentProgress) == PARTS
        assert [p["numInputRows"] for p in q.recentProgress] == \
            [p["numInputRows"] for p in jq.recentProgress]
        assert q.lastProgress["files"] == jq.lastProgress["files"]
        got = np.concatenate([b["prediction"] for b in q._mem_parts])
        ids = np.concatenate([b["id"] for b in q._mem_parts])
        batch = model.transform(vec.transform(df))._whole()
        np.testing.assert_array_equal(ids, batch["id"])
        np.testing.assert_array_equal(got, batch["prediction"])
        want = np.concatenate([p["prediction"].to_numpy()
                               for p in jq._mem_parts])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=PRED_TOL * np.abs(want).max())
        # the text column rides through each micro-batch untouched
        assert list(np.concatenate([b["room_type"]
                                    for b in q._mem_parts])) == \
            list(batch["room_type"])
        rows = pspark.sql("SELECT id, prediction FROM mle00_preds "
                          "ORDER BY id LIMIT 3").collect()
        assert [r["prediction"] for r in rows] == list(got[:3])
    finally:
        q.stop()
        jq.stop()


def test_checkpoint_resume_skips_processed_files(spark, tmp_path):
    """A query restarted on its checkpointLocation processes only the
    files that came after: one micro-batch of the new part, in both."""
    table = _table(4 * ROWS)
    counts = {}
    for pkg in ("port", "jax"):
        src = str(tmp_path / f"src-{pkg}")
        _write_parts(src, table, parts=2)
        ckpt = str(tmp_path / f"ckpt-{pkg}")
        runs = []
        for run in range(2):
            if pkg == "port":
                _, _, _, _, q = _port_flow(src, ckpt, name=f"p{run}")
            else:
                q = _jax_flow(spark, src, ckpt, name=f"j{run}")
            q.processAllAvailable()
            q.stop()
            runs.append((len(q.recentProgress),
                         sum(p["numInputRows"] for p in q.recentProgress)))
            if run == 0:
                _write_parts(src, table, parts=1, start=2)
        counts[pkg] = runs
    assert counts["port"] == counts["jax"] == [(2, 200), (1, 100)]
    with open(os.path.join(tmp_path, "ckpt-port", "processed.json")) as f:
        assert len(json.load(f)) == 3


def test_trigger_once_processes_what_is_there_and_ends(spark, tmp_path):
    src = str(tmp_path / "src")
    _write_parts(src, _table())
    _, _, _, _, q = _port_flow(src, str(tmp_path / "c"), name="once",
                               trigger={"once": True})
    jq = _jax_flow(spark, src, str(tmp_path / "jc"), name="jonce",
                   trigger={"once": True})
    assert q.awaitTermination(30) is True
    assert jq.awaitTermination(30) is True
    assert not q.isActive and q.exception() is None
    assert len(q.recentProgress) == len(jq.recentProgress) == PARTS
    assert not q._thread.is_alive()


def test_stop_joins_the_trigger_thread(tmp_path):
    src = str(tmp_path / "src")
    _write_parts(src, _table(), parts=1)
    _, _, _, _, q = _port_flow(src, str(tmp_path / "c"), name="stopper")
    q.processAllAvailable()
    assert q.isActive and q._thread.is_alive()
    q.stop()
    assert not q.isActive and not q._thread.is_alive()
    assert q.awaitTermination(0) is True


def test_a_failed_trigger_surfaces_its_error(spark, tmp_path):
    """A micro-batch op that raises ends the query: `exception()` holds
    the error, and `awaitTermination` and `processAllAvailable` raise it
    (the JAX package keeps it in `exception()` as well)."""
    src = str(tmp_path / "src")
    _write_parts(src, _table(), parts=1)
    pspark = get_session()
    q = pspark.readStream.parquet(src).select("no_such_column") \
        .writeStream.format("memory").queryName("broken").start()
    jq = spark.readStream.parquet(src).select("no_such_column") \
        .writeStream.format("memory").queryName("jbroken").start()
    with pytest.raises(RuntimeError, match="terminated with error") as e:
        q.awaitTermination(30)
    assert e.value.__cause__ is q.exception()
    assert q.exception() is not None and not q.isActive
    with pytest.raises(RuntimeError, match="terminated with error"):
        q.processAllAvailable()
    jq.awaitTermination(30)
    assert jq.exception() is not None
    assert not q._thread.is_alive()
    q.stop()


def test_stream_manager_lists_and_awaits_queries(tmp_path):
    src = str(tmp_path / "src")
    _write_parts(src, _table(), parts=1)
    spark = get_session()
    q = spark.readStream.parquet(src).writeStream.format("memory") \
        .queryName("managed").start()
    try:
        assert q in spark.streams.active
        assert spark.streams.get("managed") is q
        assert spark.streams.get(q.id) is q
        q.processAllAvailable()
    finally:
        q.stop()
    assert q not in spark.streams.active
    assert spark.streams.awaitAnyTermination(1.0) is True


def test_csv_source_matches_the_jax_package(spark, tmp_path):
    src = tmp_path / "csv"
    src.mkdir()
    table = _table(2 * ROWS)
    for i in range(2):
        with open(src / f"part-{i}.csv", "w") as f:
            f.write("id,bedrooms,price\n")
            for j in range(i * ROWS, (i + 1) * ROWS):
                f.write(f"{table['id'][j]},{table['bedrooms'][j]},"
                        f"{table['price'][j]}\n")
    q = get_session().readStream.format("csv").load(str(src)) \
        .writeStream.format("memory").queryName("csvq").start()
    jq = spark.readStream.format("csv").load(str(src)) \
        .writeStream.format("memory").queryName("jcsvq").start()
    try:
        q.processAllAvailable()
        jq.processAllAvailable()
        got = {c: np.concatenate([b[c] for b in q._mem_parts])
               for c in ("id", "bedrooms", "price")}
        for c, v in got.items():
            want = np.concatenate([p[c].to_numpy() for p in jq._mem_parts])
            np.testing.assert_array_equal(v, want)
            assert v.dtype == want.dtype
    finally:
        q.stop()
        jq.stop()


def test_delta_sink_appends_each_micro_batch(spark, tmp_path):
    src = str(tmp_path / "src")
    _write_parts(src, _table())
    out = str(tmp_path / "sink.delta")
    q = get_session().readStream.option("maxFilesPerTrigger", 1) \
        .parquet(src).select("id", "price").writeStream.format("delta") \
        .option("checkpointLocation", str(tmp_path / "c")).start(out)
    q.processAllAvailable()
    q.stop()
    got = get_session().read.format("delta").load(out)
    assert got.count() == PARTS * ROWS
    want = spark.read.format("delta").load(out).toPandas()
    assert sorted(want["id"]) == list(range(PARTS * ROWS))
    from sml_tpu_torch.delta import DeltaTable
    assert len(DeltaTable.forPath(get_session(), out).history()
               .collect()) == PARTS


def test_write_stream_on_a_static_frame_is_refused():
    df = get_session().createDataFrame({"a": np.arange(3.0)})
    with pytest.raises(TypeError, match="streaming DataFrame"):
        df.writeStream
