"""The port's Delta tables (`sml_tpu_torch/delta/table.py`) and the Delta
half of its `spark.sql` against the live JAX package, on the CPU.

Each package reads the table the other writes, latest version, history
and time travel included, to equal frames: rows in the same order and
partitions, floats bit for bit, NULLs in the same places (the frame
comparison of `test_torch_frame_sql.py`). The schema rules
(`mergeSchema` under append and overwrite, `overwriteSchema`, the
errors), partitioned tables (partition values read back as numbers where
they are numbers), `delete`, `vacuum` with its retention guard and the
guard's `spark.databricks.*` alias, and the SQL forms (``delta.`p` ``,
`@vN`, `VERSION AS OF`, `TIMESTAMP AS OF` on a path and on a saved
table, `DESCRIBE HISTORY`) give what the JAX package gives.
"""

import os
import time

import numpy as np
import pandas as pd
import pytest

from sml_tpu_torch import GLOBAL_CONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.delta.table import DeltaTable, timestamp_ms
from sml_tpu_torch.frame.session import get_session

from test_torch_frame_sql import assert_same_frame

COLS = ["room_type", "bedrooms", "accommodates", "price",
        "neighbourhood_cleansed", "host_total_listings_count"]


@pytest.fixture(scope="module")
def psession():
    return get_session()


def _block(n=500, seed=3, cols=COLS):
    d = make_airbnb_dataset(n=n, seed=seed)
    return {c: d[c] for c in cols}


def _both(spark, psession, block, parts=None):
    pdf = pd.DataFrame({c: (pd.Series(v, dtype=object) if v.dtype.kind == "O"
                            else v) for c, v in block.items()})
    return (spark.createDataFrame(pdf, numPartitions=parts),
            psession.createDataFrame(block, numPartitions=parts))


def _history(rows):
    """History rows without their timestamps (each write's own)."""
    return [(r["version"], r["operation"], r["operationParameters"])
            for r in rows]


@pytest.mark.parametrize("partition_by", [[], ["room_type"],
                                          ["room_type", "bedrooms"]])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_table(spark, psession, tmp_path,
                                             writer, partition_by):
    jdf, pdf = _both(spark, psession, _block(), parts=4)
    path = str(tmp_path / "t")
    df = jdf if writer == "jax" else pdf
    w = df.write.format("delta")
    if partition_by:
        w = w.partitionBy(*partition_by)
    w.save(path)
    df.limit(37).write.format("delta").mode("append").save(path)
    for opts in ({}, {"versionAsOf": 0}, {"versionAsOf": 1}):
        jr = spark.read.format("delta").options(**opts).load(path)
        pr = psession.read.format("delta").options(**opts).load(path)
        assert_same_frame(jr, pr)
    # the bedrooms partition reads back as a number, as pandas parses it
    got = psession.read.format("delta").load(path)
    assert dict(got.dtypes)["bedrooms"] == "double"
    jh = spark.sql(f"DESCRIBE HISTORY delta.`{path}`").collect()
    ph = psession.sql(f"DESCRIBE HISTORY delta.`{path}`").collect()
    assert _history(ph) == _history(jh)
    assert [pd.Timestamp(r["timestamp"]) for r in ph] == \
        [pd.Timestamp(r["timestamp"]) for r in jh]


def test_log_entries_have_the_jax_packages_fields(spark, psession,
                                                  tmp_path):
    import json
    jdf, pdf = _both(spark, psession, _block(60))
    for name, df in (("jax", jdf), ("port", pdf)):
        df.write.format("delta").partitionBy("room_type").save(
            str(tmp_path / name))
    logs = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "_delta_log" /
                  "00000000000000000000.json") as fh:
            logs[name] = [json.loads(line) for line in fh]
    for a, b in zip(logs["jax"], logs["port"]):
        assert list(a) == list(b)
        kind = next(iter(a))
        assert sorted(a[kind]) == sorted(b[kind])
        if kind == "metaData":
            assert a[kind]["schemaString"] == b[kind]["schemaString"]
            assert a[kind]["partitionColumns"] == b[kind]["partitionColumns"]
        if kind == "add":
            assert a[kind]["partitionValues"] == b[kind]["partitionValues"]
            assert a[kind]["numRecords"] == b[kind]["numRecords"]


def test_timestamp_as_of_picks_the_same_version(spark, psession, tmp_path):
    path = str(tmp_path / "t")
    jdf, pdf = _both(spark, psession, _block(40))
    pdf.write.format("delta").save(path)
    time.sleep(0.05)
    pdf.limit(5).write.format("delta").mode("overwrite").save(path)
    hist = psession.sql(f"DESCRIBE HISTORY delta.`{path}`").collect()
    first = hist[-1]["timestamp"]
    for ts in (str(pd.Timestamp(first)), first, np.datetime64(first, "ms"),
               str(pd.Timestamp(hist[0]["timestamp"]))):
        got = psession.read.format("delta").option("timestampAsOf", ts) \
            .load(path)
        want = spark.read.format("delta").option(
            "timestampAsOf", str(pd.Timestamp(ts))).load(path)
        assert_same_frame(want, got)
    with pytest.raises(ValueError, match="No version"):
        psession.read.format("delta").option("timestampAsOf",
                                             "2000-01-01").load(path)


@pytest.mark.parametrize("text", [
    "2024-05-01", "2024-05-01 12:30", "2024-05-01T12:30:05",
    "2024-05-01 12:30:05.123456", "2024-05-01 12:30:05.5Z",
    "2024-05-01T12:30:05+02:00", "1969-12-31 23:59:59.999"])
def test_timestamp_text_reads_as_pandas_reads_it(text):
    assert timestamp_ms(text) == pd.Timestamp(text).timestamp() * 1000


@pytest.mark.parametrize("text", ["yesterday", "05/01/2024", "2024-13-01",
                                  "", 17])
def test_timestamp_text_outside_the_formats_raises(text):
    with pytest.raises(ValueError):
        timestamp_ms(text)


def test_merge_and_overwrite_schema_rules(spark, psession, tmp_path):
    """ML 05L's additive overwrite under mergeSchema, an append under
    mergeSchema, a destructive overwrite under overwriteSchema, and the
    errors without them, in both packages."""
    from sml_tpu import functions as JF
    from sml_tpu_torch import functions as PF
    jdf, pdf = _both(spark, psession, _block(80))
    out = {}
    for name, df, F in (("jax", jdf, JF), ("port", pdf, PF)):
        p = str(tmp_path / name)
        df.select("bedrooms", "price").write.format("delta").save(p)
        wide = df.select("bedrooms", "price").withColumn(
            "log_price", F.log(F.col("price")))
        with pytest.raises(ValueError, match="overwriteSchema"):
            wide.write.format("delta").mode("overwrite").save(p)
        with pytest.raises(ValueError, match="mergeSchema"):
            wide.write.format("delta").mode("append").save(p)
        wide.write.format("delta").mode("overwrite") \
            .option("mergeSchema", "true").save(p)
        wide.limit(3).write.format("delta").mode("append") \
            .option("mergeSchema", "true").save(p)
        with pytest.raises(ValueError, match="overwriteSchema"):
            df.select("price").write.format("delta").mode("overwrite") \
                .option("mergeSchema", "true").save(p)
        df.select("room_type").write.format("delta").mode("overwrite") \
            .option("overwriteSchema", "true").save(p)
        out[name] = p
    for v in range(4):
        assert_same_frame(
            spark.read.format("delta").option("versionAsOf", v)
            .load(out["jax"]),
            psession.read.format("delta").option("versionAsOf", v)
            .load(out["port"]))
    assert "log_price" not in psession.read.format("delta").option(
        "versionAsOf", 0).load(out["port"]).columns


def test_delete_and_modes(spark, psession, tmp_path):
    from sml_tpu.delta.table import DeltaTable as JDeltaTable
    jdf, pdf = _both(spark, psession, _block(120))
    for name, df, DT, s in (("jax", jdf, JDeltaTable, spark),
                            ("port", pdf, DeltaTable, psession)):
        p = str(tmp_path / name)
        df.write.format("delta").save(p)
        df.write.format("delta").mode("ignore").save(p)
        with pytest.raises(FileExistsError):
            df.write.format("delta").save(p)
        assert DT.isDeltaTable(s, p) and not DT.isDeltaTable(
            s, str(tmp_path))
        DT.forPath(s, p).delete("bedrooms > 2 AND price < 400")
    assert_same_frame(
        spark.read.format("delta").load(str(tmp_path / "jax")),
        psession.read.format("delta").load(str(tmp_path / "port")))
    # no condition deletes every row and keeps the columns (Spark's rule;
    # the JAX package's write refuses its own empty frame's schema)
    DeltaTable.forPath(psession, str(tmp_path / "port")).delete()
    empty = DeltaTable.forPath(psession, str(tmp_path / "port")).toDF()
    assert empty.count() == 0 and empty.columns == COLS
    with pytest.raises(FileNotFoundError):
        DeltaTable.forPath(psession, str(tmp_path / "nothing"))


@pytest.mark.parametrize("key", [
    "sml.delta.retentionDurationCheck.enabled",
    "spark.databricks.delta.retentionDurationCheck.enabled"])
def test_vacuum_guard_and_what_it_removes(spark, psession, tmp_path, key):
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.delta.table import DeltaTable as JDeltaTable
    jdf, pdf = _both(spark, psession, _block(50), parts=2)
    left = {}
    for name, df, DT, s, conf in (
            ("jax", jdf, JDeltaTable, spark, JCONF),
            ("port", pdf, DeltaTable, psession, GLOBAL_CONF)):
        p = str(tmp_path / name)
        df.write.format("delta").save(p)
        df.limit(10).write.format("delta").mode("overwrite").save(p)
        with pytest.raises(ValueError, match="retention"):
            DT.forPath(s, p).vacuum(0)
        conf.set(key, "false")
        try:
            DT.forPath(s, p).vacuum(0)
        finally:
            conf.set(key, "true")
        left[name] = sorted(f for f in os.listdir(p)
                            if f.endswith(".parquet"))
        DT.forPath(s, p).vacuum()  # the default retention keeps the rest
        assert sorted(f for f in os.listdir(p) if f.endswith(".parquet")) \
            == left[name]
    # each keeps just the files of its latest version (the JAX package's
    # limit keeps an empty partition the port's drops)
    from sml_tpu_torch.delta.table import _snapshot
    for name in ("jax", "port"):
        p = str(tmp_path / name)
        assert left[name] == sorted(f["path"] for f in _snapshot(p, 1)[
            "files"])
    assert GLOBAL_CONF.getBool("sml.delta.retentionDurationCheck.enabled")
    assert_same_frame(spark.read.format("delta").load(str(tmp_path / "jax")),
                      psession.read.format("delta").load(
                          str(tmp_path / "port")))


SQL = [
    "SELECT count(*) AS n, avg(price) AS p FROM delta.`{p}`",
    "SELECT room_type, count(*) AS n FROM delta.`{p}` VERSION AS OF 0 "
    "GROUP BY room_type ORDER BY n DESC",
    "SELECT * FROM delta.`{p}@v1` ORDER BY price DESC LIMIT 7",
    "SELECT bedrooms, max(price) AS m FROM delta.`{p}` VERSION AS OF 1 "
    "GROUP BY bedrooms ORDER BY bedrooms",
]


@pytest.mark.parametrize("query", SQL)
def test_sql_over_delta_paths_equals_jax(spark, psession, tmp_path, query):
    jdf, pdf = _both(spark, psession, _block(300))
    p = str(tmp_path / "t")
    pdf.write.format("delta").save(p)
    pdf.filter("bedrooms > 1").write.format("delta").mode("append").save(p)
    q = query.format(p=p)
    assert_same_frame(spark.sql(q), psession.sql(q))


def test_sql_time_travel_on_a_saved_table_and_after_a_recreate(
        spark, psession, tmp_path):
    jdf, pdf = _both(spark, psession, _block(90))
    name = f"tt_{os.getpid()}"
    for s, df in ((spark, jdf), (psession, pdf)):
        df.write.format("delta").mode("overwrite").saveAsTable(name)
        df.limit(4).write.format("delta").mode("overwrite").saveAsTable(name)
    try:
        for q in (f"SELECT count(*) AS n FROM {name} VERSION AS OF 0",
                  f"SELECT count(*) AS n FROM {name}",
                  f"DESCRIBE HISTORY {name}"):
            got, want = psession.sql(q).collect(), spark.sql(q).collect()
            if q.startswith("DESCRIBE"):
                assert _history(got) == _history(want)
            else:
                assert [r.asDict() for r in got] == \
                    [r.asDict() for r in want]
        hist = psession.sql(f"DESCRIBE HISTORY {name}").collect()
        ts = str(pd.Timestamp(hist[-1]["timestamp"]))
        q = f"SELECT count(*) AS n FROM {name} TIMESTAMP AS OF '{ts}'"
        assert psession.sql(q).collect()[0]["n"] == 90
        # drop and write again at the same path: no stale snapshot
        psession.sql(f"DROP TABLE {name}")
        pdf.limit(11).write.format("delta").saveAsTable(name)
        assert psession.sql(f"SELECT count(*) AS n FROM {name} VERSION AS "
                            f"OF 0").collect()[0]["n"] == 11
        assert psession.table(name).count() == 11
    finally:
        spark.sql(f"DROP TABLE {name}")
        psession.sql(f"DROP TABLE {name}")


@pytest.mark.parametrize("fmt", ["parquet", "delta"])
def test_save_as_table_and_the_warehouse_fallback(spark, psession, fmt):
    """`saveAsTable` in each format; a later session, whose catalog never
    saw the table, reads it from the warehouse directory (Delta where it
    holds a `_delta_log`, else parquet), as the JAX package does."""
    from sml_tpu_torch.frame.session import TpuSession
    jdf, pdf = _both(spark, psession, _block(70), parts=3)
    name = f"wh_{fmt}_{os.getpid()}"
    jdf.write.format(fmt).mode("overwrite").saveAsTable(name)
    pdf.write.format(fmt).mode("overwrite").saveAsTable(name)
    try:
        assert_same_frame(spark.table(name), psession.table(name))
        later = TpuSession(warehouse=psession._warehouse)
        try:
            assert not later.catalog.tableExists(name)
            assert_same_frame(spark.table(name), later.table(name))
        finally:
            TpuSession._instance = psession
    finally:
        spark.sql(f"DROP TABLE {name}")
        psession.sql(f"DROP TABLE {name}")
