"""The port's grouping, joins, SQL, date functions and CSV / JSON IO
against the JAX package's live ones, on the CPU.

Every case runs the same operation on the same rows through both
packages and holds the port's result to the JAX package's row for row,
in its order and in its partitions (groups come in order of first
appearance and are hash-partitioned by their keys; joins follow pandas'
`merge`), with its dtypes: floats bit for bit, NULL where the JAX
package has NaN, None or NaT. `spark.sql` results follow pandas'
`read_sql_query` rules (an integer column holding a NULL is float64,
text is text, `count(*)` int64). The CSV and JSON writers write the JAX
package's bytes; the readers type columns as pandas' `read_csv` and
`json_normalize` do. Last, ML 00L's dedup lab through the port: the
deduplicated count hashes to the course's own constant.
"""

import os
import uuid

import numpy as np
import pandas as pd
import pytest

from sml_tpu_torch.courseware import make_dedup_dataset
from sml_tpu_torch.frame import functions as PF
from sml_tpu_torch.frame.column import block_len, object_array
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.native.hashing import hash_scalar

N = 600


@pytest.fixture(scope="module")
def psession():
    return get_session()


def _norm(v):
    if v is None or v is pd.NaT or (isinstance(v, float) and v != v):
        return None
    if isinstance(v, (pd.Timestamp, np.datetime64)):
        return pd.Timestamp(v).to_pydatetime()
    return v


def assert_same_frame(jdf, pdf):
    """The port's frame holds the JAX package's rows in its order and in
    its partitions, with its dtypes: floats bit for bit, NULLs in the
    same places."""
    jparts = jdf._materialize()
    pparts = pdf._materialize()
    assert [len(p) for p in jparts if len(p.columns)] == \
        [block_len(p) for p in pparts if p], "partition sizes"
    want = jdf.toPandas()
    got = pdf._whole()
    assert list(want.columns) == list(got), (list(want.columns), list(got))
    for c in want.columns:
        w, g = want[c].to_numpy(), got[c]
        assert len(w) == len(g), c
        if want[c].dtype.kind == "f":
            assert g.dtype == want[c].dtype, (c, g.dtype, want[c].dtype)
            np.testing.assert_array_equal(g, w, err_msg=c)
        elif want[c].dtype.kind in "iub":
            assert g.dtype == want[c].dtype, (c, g.dtype, want[c].dtype)
            np.testing.assert_array_equal(g, w, err_msg=c)
        elif want[c].dtype.kind == "M":
            assert g.dtype.kind == "M", c
            assert [_norm(x) for x in w.tolist()] == \
                [_norm(x) for x in g.astype("datetime64[us]").tolist()], c
        else:
            assert g.dtype.kind == "O", (c, g.dtype)
            assert [_norm(x) for x in w.tolist()] == \
                [_norm(x) for x in g.tolist()], c


def _cols(n=N, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.choice(["b", "a", "c", "d"], n).astype(object)
    k[rng.random(n) < 0.1] = None
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    s = rng.choice(["p", "q", "r"], n).astype(object)
    s[rng.random(n) < 0.05] = None
    return {"k": k, "k2": rng.integers(0, 3, n), "x": x,
            "y": 2 * x + rng.normal(size=n), "i": rng.integers(-5, 50, n),
            "s": s, "flag": rng.random(n) < 0.3,
            "xr": np.round(x, 0),
            "s2": rng.choice(["u", "v", "w"], n).astype(object)}


def _both(spark, psession, cols, parts=None):
    pdf = pd.DataFrame({c: (v if v.dtype.kind != "O" else
                            pd.Series(v, dtype=object)) for c, v in
                        cols.items()})
    return (spark.createDataFrame(pdf, numPartitions=parts),
            psession.createDataFrame(cols, numPartitions=parts))


@pytest.fixture(scope="module")
def frames(spark, psession):
    return _both(spark, psession, _cols())


# ------------------------------------------------------------- grouping
GROUPINGS = {
    "count": lambda df, F: df.groupBy("k").count(),
    "count_ordered": lambda df, F: df.groupBy("k").count()
    .orderBy(F.col("count").desc()),
    "agg": lambda df, F: df.groupBy("k").agg(
        F.avg("x"), F.sum("i"), F.sum("x"), F.min("s2"), F.max("x"),
        F.count("x"), F.stddev("x"), F.first("i"), F.last("x"),
        F.countDistinct("s"), F.mean("i"), F.min("i")),
    "agg_dict": lambda df, F: df.groupBy("k", "k2").agg(
        {"x": "avg", "i": "sum", "s2": "max"}),
    "two_keys": lambda df, F: df.groupBy(["k2", "k"]).count(),
    "float_key_nan": lambda df, F: df.groupBy("xr").agg(F.count("*"),
                                                          F.avg("y")),
    "bool_key": lambda df, F: df.groupby("flag").sum("i", "x"),
    "computed_key": lambda df, F: df.groupBy(F.col("i") > 20).count(),
    "avg_all": lambda df, F: df.groupBy("k").avg(),
    "mean_min_max": lambda df, F: df.groupBy("s").mean("x").join(
        df.groupBy("s").min("i"), "s"),
    "max": lambda df, F: df.groupBy("k2").max("y", "i"),
    "global_agg": lambda df, F: df.agg(F.avg("x"), F.count("*"),
                                       F.sum("i"), F.min("s2")),
    "global_select": lambda df, F: df.select(F.sum("i"), F.max("s2")),
    "agg_dict_global": lambda df, F: df.agg({"y": "max"}),
}


@pytest.mark.parametrize("case", list(GROUPINGS))
def test_grouping_equals_jax(frames, case):
    from sml_tpu import functions as JF
    jdf, pdf = frames
    assert_same_frame(GROUPINGS[case](jdf, JF), GROUPINGS[case](pdf, PF))


def test_groups_come_in_order_of_first_appearance(psession):
    df = psession.createDataFrame({"k": object_array(["b", None, "a", "b",
                                                      None, "c"]),
                                   "v": np.arange(6)}, numPartitions=1)
    rows = df.groupBy("k").agg(PF.sum("v"))
    got = sorted(((r["k"], r["sum(v)"]) for r in rows.collect()), key=str)
    assert got == sorted([("b", 3), (None, 5), ("a", 2), ("c", 5)],
                         key=str)
    from sml_tpu_torch.frame.grouped import group_rows
    first, _ = group_rows(df._whole(), ["k"])
    assert first.tolist() == [0, 1, 2, 5]


def test_corr_aggregate_is_the_frames_corr(frames):
    """`F.corr` per group and over the frame is the JAX package's
    `DataFrame.corr` of the same rows. (The JAX package's own `F.corr`
    aggregate gives NaN: its `Column._eval` wraps the two-column frame
    in a Series, so the aggregate never sees the frame.)"""
    from sml_tpu import functions as JF
    jdf, pdf = frames
    whole = pdf.select(PF.corr("x", "y")).collect()[0][0]
    assert whole == jdf.corr("x", "y")
    got = {r["k2"]: r["corr(x, y)"] for r in
           pdf.groupBy("k2").agg(PF.corr("x", "y")).collect()}
    for k2, value in got.items():
        assert value == jdf.filter(JF.col("k2") == k2).corr("x", "y")


# ----------------------------------------------------------------- joins
def _join_frames(spark, psession):
    rng = np.random.default_rng(5)
    lk = rng.choice(["a", "b", "c", "e"], 40).astype(object)
    lk[[3, 17]] = None
    rk = rng.choice(["a", "b", "d", "e"], 25).astype(object)
    rk[[2]] = None
    left = {"k": lk, "k2": rng.integers(0, 2, 40),
            "v": rng.normal(size=40), "n": rng.integers(0, 9, 40),
            "flag": rng.random(40) < 0.5}
    right = {"k": rk, "k2": rng.integers(0, 2, 25),
             "v": rng.normal(size=25), "w": rng.integers(0, 9, 25),
             "t": rng.choice(["x", "y"], 25).astype(object)}
    return _both(spark, psession, left, 3), _both(spark, psession, right, 2)


HOWS = ["inner", "left", "left_outer", "right", "right_outer", "outer",
        "full", "full_outer", "left_semi", "leftsemi", "left_anti",
        "leftanti"]


@pytest.mark.parametrize("on", ["k", ["k", "k2"], "k2"])
@pytest.mark.parametrize("how", HOWS)
def test_join_equals_jax(spark, psession, how, on):
    (jl, pl), (jr, pr) = _join_frames(spark, psession)
    assert_same_frame(jl.join(jr, on, how), pl.join(pr, on, how))


def test_join_on_common_columns_and_cross_join(spark, psession):
    (jl, pl), (jr, pr) = _join_frames(spark, psession)
    jl2, pl2 = jl.select("k", "k2", "n"), pl.select("k", "k2", "n")
    jr2, pr2 = jr.select("k", "k2", "w"), pr.select("k", "k2", "w")
    assert_same_frame(jl2.join(jr2), pl2.join(pr2))
    assert_same_frame(jl.limit(7).crossJoin(jr.limit(5)),
                      pl.limit(7).crossJoin(pr.limit(5)))
    assert_same_frame(jl.join(jr.limit(4), how="cross"),
                      pl.join(pr.limit(4), how="cross"))


# ------------------------------------------------- expressions and stats
def test_select_expr_filter_string_and_stats(frames):
    jdf, pdf = frames
    exprs = ["x * 2 as x2", "log(i + 6) as li", "k", "i"]
    assert_same_frame(jdf.selectExpr(*exprs), pdf.selectExpr(*exprs))
    cond = "i > 10 AND k2 = 1"
    assert_same_frame(jdf.filter(cond), pdf.filter(cond))
    assert_same_frame(jdf.where("s IS NULL OR x > 1"),
                      pdf.where("s IS NULL OR x > 1"))
    for a, b in (("x", "y"), ("i", "y"), ("y", "y")):
        want = jdf.corr(a, b)
        assert pdf.corr(a, b) == want
        assert pdf.stat.corr(a, b) == jdf.stat.corr(a, b) == want
    assert pdf.stat.approxQuantile("x", [0.1, 0.5, 0.9], 0.01) == \
        jdf.stat.approxQuantile("x", [0.1, 0.5, 0.9], 0.01)


DATES = ["2020-01-05", "garbage", None, "2021-03-04 10:11:12",
         "1999-12-31", "2020-02-29", "2020-13-01", "2024-07-04"]


@pytest.mark.parametrize("first", ["2019-06-30", "2019-06-30 08:00:00",
                                   "06/30/2019", "not a date"])
def test_date_functions_equal_jax(spark, psession, first):
    from sml_tpu import functions as JF
    cols = {"d": object_array([first] + DATES), "n": np.arange(9)}
    jdf, pdf = _both(spark, psession, cols, 1)

    def run(df, F):
        return df.select(F.to_date("d").alias("date"),
                         F.to_timestamp("d").alias("ts"),
                         F.year("d").alias("y"), F.month("d").alias("m"),
                         F.dayofmonth("d").alias("dom"))
    assert_same_frame(run(jdf, JF), run(pdf, PF))


def test_date_functions_with_a_format_and_on_timestamps(spark, psession):
    from sml_tpu import functions as JF
    cols = {"d": object_array(["05/01/2020", "31/12/1999", "2020-01-05",
                               None, "29/02/2021"])}
    jdf, pdf = _both(spark, psession, cols, 1)
    for fn in ("to_date", "to_timestamp"):
        assert_same_frame(jdf.select(getattr(JF, fn)("d", "%d/%m/%Y")),
                          pdf.select(getattr(PF, fn)("d", "%d/%m/%Y")))
    jts = jdf.select(JF.to_timestamp("d", "%d/%m/%Y").alias("t"))
    pts = pdf.select(PF.to_timestamp("d", "%d/%m/%Y").alias("t"))
    for fn in ("year", "month", "dayofmonth"):
        assert_same_frame(jts.select(getattr(JF, fn)("t")),
                          pts.select(getattr(PF, fn)("t")))


# --------------------------------------------------------------------- SQL
def _view(name):
    return f"{name}_{uuid.uuid4().hex[:8]}"


def test_sql_over_a_temp_view_equals_jax(spark, psession, frames):
    jdf, pdf = frames
    v = _view("grouped")
    jdf.createOrReplaceTempView(v)
    pdf.createOrReplaceTempView(v)
    queries = [
        f"SELECT k, count(*) AS n FROM {v} GROUP BY k ORDER BY n DESC, k",
        f"SELECT * FROM {v} WHERE i > 40",
        f"SELECT k, avg(x) AS ax, sum(i) AS si, max(s) AS ms FROM {v} "
        f"GROUP BY k ORDER BY k",
        f"SELECT i, CASE WHEN x > 0 THEN i ELSE NULL END AS maybe, s "
        f"FROM {v} LIMIT 50",
        f"SELECT flag, count(*) AS n FROM {v} GROUP BY flag",
        f"SELECT * FROM {v} WHERE 1 = 0",
    ]
    for q in queries:
        assert_same_frame(spark.sql(q), psession.sql(q))
    assert psession.catalog.dropTempView(v) and spark.catalog.dropTempView(v)
    with pytest.raises(Exception):
        psession.sql(f"SELECT * FROM {v}").count()


def test_sql_dtype_rules(spark, psession):
    cols = {"a": np.array([1.0, np.nan, 3.0]), "n": np.array([1, 2, 3]),
            "t": object_array(["x", None, "z"]),
            "when": np.array(["2020-01-01", "2020-01-02T03:04:05",
                              "NaT"], dtype="datetime64[us]"),
            "b": np.array([True, False, True])}
    jdf, pdf = _both(spark, psession, cols, 1)
    v = _view("dtypes")
    jdf.createOrReplaceTempView(v)
    pdf.createOrReplaceTempView(v)
    q = f"SELECT a, n, t, b, \"when\", count(*) AS c FROM {v} GROUP BY n"
    got = psession.sql(q)
    assert_same_frame(spark.sql(q), got)
    kinds = {c: v.dtype.kind for c, v in got._whole().items()}
    assert kinds == {"a": "f", "n": "i", "t": "O", "b": "i", "when": "O",
                     "c": "i"}
    q2 = f"SELECT CASE WHEN n > 1 THEN n END AS m FROM {v}"
    assert psession.sql(q2)._whole()["m"].dtype == np.float64
    assert_same_frame(spark.sql(q2), psession.sql(q2))


def test_catalog_statements_equal_jax(spark, psession, frames):
    jdf, pdf = frames
    v = _view("cat")
    for s, df in ((spark, jdf), (psession, pdf)):
        df.createOrReplaceTempView(v)
    for s in (spark, psession):
        assert s.catalog.tableExists(v)
        assert s.catalog.currentDatabase() == "default"
    jt = {(r.tableName, r.isTemporary) for r in spark.catalog.listTables()}
    pt = {(r.tableName, r.isTemporary) for r in psession.catalog.listTables()}
    assert (v, True) in jt and (v, True) in pt
    assert_same_frame(spark.sql(f"DESCRIBE {v}"),
                      psession.sql(f"DESCRIBE {v}"))
    db = _view("db")
    for s in (spark, psession):
        s.sql(f"CREATE DATABASE IF NOT EXISTS {db}")
        s.sql(f"USE {db}")
        assert s.catalog.currentDatabase() == db
        s.sql("USE default")
        s.sql(f"DROP DATABASE IF EXISTS {db} CASCADE")
        assert s.catalog.dropTempView(v)
        assert not s.catalog.tableExists(v)


def test_sql_over_a_catalog_table_saved_as_csv(spark, psession, frames):
    jdf, pdf = frames
    t = _view("tbl")
    jdf.select("k", "i", "x").write.format("csv").mode(
        "overwrite").saveAsTable(t)
    pdf.select("k", "i", "x").write.format("csv").mode(
        "overwrite").saveAsTable(t)
    try:
        q = f"SELECT _c0, sum(_c1) AS s, count(*) AS n FROM {t} " \
            f"GROUP BY _c0 ORDER BY n DESC"
        assert_same_frame(spark.sql(q), psession.sql(q))
        assert_same_frame(spark.table(t), psession.table(t))
        assert psession.catalog.tableExists(t)
    finally:
        spark.sql(f"DROP TABLE {t}")
        psession.sql(f"DROP TABLE {t}")
    assert not psession.catalog.tableExists(t)


def test_delta_and_parquet_name_their_roadmap_item(spark, psession, frames,
                                                   tmp_path):
    """Parquet and Delta (ROADMAP item 9a) once raised naming the item;
    now each package reads what the other writes, and `spark.sql` over a
    Delta path gives the JAX package's result
    (`tests/test_torch_parquet.py` and `tests/test_torch_delta.py` hold
    the rest)."""
    jdf, pdf = frames
    pdf.write.parquet(str(tmp_path / "p"))
    jdf.write.parquet(str(tmp_path / "j"))
    assert_same_frame(spark.read.parquet(str(tmp_path / "p")),
                      psession.read.parquet(str(tmp_path / "j")))
    pdf.write.format("delta").save(str(tmp_path / "d"))
    assert_same_frame(spark.read.format("delta").load(str(tmp_path / "d")),
                      psession.read.format("delta").load(
                          str(tmp_path / "d")))
    q = (f"SELECT k, count(*) AS n, avg(x) AS ax FROM "
         f"delta.`{tmp_path / 'd'}` GROUP BY k ORDER BY n DESC, k")
    assert_same_frame(spark.sql(q), psession.sql(q))


def test_session_surface(spark, psession):
    assert psession.version == spark.version
    sc = psession.sparkContext
    assert sc.defaultParallelism == spark.sparkContext.defaultParallelism
    sc.setLogLevel("ERROR")
    assert_same_frame(spark.sparkContext.parallelize(range(17), 3),
                      sc.parallelize(range(17), 3))


# ---------------------------------------------------------------- CSV/JSON
def _io_cols():
    rng = np.random.default_rng(9)
    n = 40
    f = rng.normal(size=n) * 10.0 ** rng.integers(-6, 17, n)
    f[[1, 5]] = np.nan
    f[2], f[3], f[4] = 0.1 + 0.2, 1e16, 1e-5
    s = rng.choice(["plain", "with,comma", 'with "quote"', "two\nlines",
                    "NA", "", "ünï/cödé"], n).astype(object)
    s[[0, 7]] = None
    return {"f": f, "i": rng.integers(-10**6, 10**6, n),
            "b": rng.random(n) < 0.5, "s": s,
            "t": (np.datetime64("2020-01-01", "us")
                  + rng.integers(0, 10**4, n) * np.timedelta64(1, "D")),
            "ts": (np.datetime64("2020-01-01", "us")
                   + rng.integers(0, 10**9, n) * np.timedelta64(1, "s")),
            "tms": (np.datetime64("2020-01-01", "us")
                    + rng.integers(0, 10**9, n) * np.timedelta64(1, "ms")),
            "tus": (np.datetime64("2020-01-01", "us")
                    + rng.integers(0, 10**9, n) * np.timedelta64(1, "us")),
            "u": rng.integers(0, 5, n).astype(np.float64)}


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.startswith("part-")}


@pytest.mark.parametrize("header", [True, False])
def test_csv_write_bytes_and_read_back_equal_jax(spark, psession, tmp_path,
                                                 header):
    jdf, pdf = _both(spark, psession, _io_cols(), 3)
    jp, pp = str(tmp_path / "j"), str(tmp_path / "p")
    jdf.write.csv(jp, header=header)
    pdf.write.csv(pp, header=header)
    assert _files(jp) == _files(pp)
    for infer in (True, False):
        def read(s):
            return s.read.option("header", header).option(
                "inferSchema", infer).csv(jp)
        assert_same_frame(read(spark), read(psession))


def test_csv_inference_edge_cases_equal_jax(spark, psession, tmp_path):
    text = ('a,b,c,d,e,f,g,h,a\n'
            '1,1.5,x,True,,1e3,"q,1",NA,7\n'
            '2,,y,false,,2,"he said ""hi""",3,8\n'
            '-3,0.30000000000000004,,TRUE,,inf, spaced ,nan,9\n'
            ' 4,123456789012345678901,z,False,,-Infinity,1_0,-0.0,10\n'
            '\n'
            '+5,.5,w,true,,5.,NULL,1e-320,11\n')
    p = tmp_path / "edge.csv"
    p.write_text(text)
    for header in (True, False):
        for infer in (True, False):
            def read(s):
                return s.read.csv(str(p), header=header, inferSchema=infer)
            assert_same_frame(read(spark), read(psession))
    q = tmp_path / "colon.txt"
    pd.DataFrame(_io_cols()).to_csv(q, index=False, sep=":")
    assert_same_frame(
        spark.read.options(header="true", inferSchema="true", sep=":")
        .csv(str(q)),
        psession.read.options(header="true", inferSchema="true", sep=":")
        .csv(str(q)))


def test_csv_read_with_a_schema_equals_jax(spark, psession, tmp_path):
    p = tmp_path / "schema.csv"
    p.write_text("1,2.5,x\n,oops,y\n3,4,\n")
    schema = "a INT, b DOUBLE, c STRING"
    assert_same_frame(spark.read.schema(schema).csv(str(p)),
                      psession.read.schema(schema).csv(str(p)))


def test_json_write_bytes_and_read_back_equal_jax(spark, psession,
                                                  tmp_path):
    jdf, pdf = _both(spark, psession, _io_cols(), 2)
    jp, pp = str(tmp_path / "j"), str(tmp_path / "p")
    jdf.write.json(jp)
    pdf.write.json(pp)
    assert _files(jp) == _files(pp)
    assert_same_frame(spark.read.json(jp), psession.read.json(pp))
    q = tmp_path / "rows.json"
    q.write_text('[{"a": 1, "b": "x"}, {"a": null, "c": 2.5}, '
                 '{"b": null, "d": true}, {"a": 4, "d": false}]')
    assert_same_frame(spark.read.json(str(q)), psession.read.json(str(q)))


def test_writer_modes(psession, tmp_path):
    pdf = psession.createDataFrame({"a": np.arange(5)}, numPartitions=2)
    p = str(tmp_path / "m")
    pdf.write.csv(p)
    with pytest.raises(FileExistsError):
        pdf.write.csv(p)
    pdf.write.mode("ignore").csv(p)
    pdf.write.mode("append").csv(p)
    assert len(_files(p)) == 4
    pdf.write.mode("overwrite").json(p)
    assert sorted(_files(p)) == ["part-00000.json", "part-00001.json"]
    assert psession.read.json(p).count() == 5


# ------------------------------------------------------------------ ML 00L
def test_ml00L_dedup_lab_through_the_port(spark, psession, tmp_path):
    """`Labs/ML 00L:30-91` up to the parquet write: the colon-separated
    file written by the port's writer (the bytes pandas' `to_csv` writes),
    read back with header, inferSchema and sep=":" (the JAX package's
    rows), lower-cased, translated and deduplicated; the count hashes to
    the course's own constant ("02 Expected 100000 Records")."""
    from sml_tpu import courseware as jcw
    from sml_tpu import functions as JF
    src = str(tmp_path / "people-with-dups")
    people = make_dedup_dataset().coalesce(1)
    people.write.option("sep", ":").option("header", True).csv(src)
    pandas_file = tmp_path / "pandas.txt"
    jcw.make_dedup_dataset().to_csv(pandas_file, index=False, sep=":")
    assert _files(src)["part-00000.csv"] == pandas_file.read_bytes()

    def dedup(s, F, path):
        df = (s.read.option("header", "true").option("inferSchema", "true")
              .option("sep", ":").csv(path))
        return (df.select(F.col("*"),
                          F.lower(F.col("firstName")).alias("lcFirstName"),
                          F.lower(F.col("lastName")).alias("lcLastName"),
                          F.lower(F.col("middleName")).alias("lcMiddleName"),
                          F.translate(F.col("ssn"), "-", "").alias("ssnNums"))
                .dropDuplicates(["lcFirstName", "lcMiddleName", "lcLastName",
                                 "ssnNums", "gender", "birthDate", "salary"])
                .drop("lcFirstName", "lcMiddleName", "lcLastName",
                      "ssnNums"))
    got = dedup(psession, PF, src)
    assert_same_frame(dedup(spark, JF, str(pandas_file)), got)
    count = got.count()
    h = hash_scalar(str(count))
    assert (h if h == -(1 << 31) else abs(h)) == 972882115
    assert count == 100_000


# -------------------------------------- frame operations, NULLs and text
def _text_cols(n=300, seed=3):
    rng = np.random.default_rng(seed)
    name = rng.choice(["ann", "Bob", "cy", "dee", "ann"], n).astype(object)
    name[rng.random(n) < 0.1] = None
    num = rng.choice(["1", "2.5", "x", " 3", "-4", "true"], n).astype(object)
    num[rng.random(n) < 0.1] = None
    v = np.round(rng.normal(size=n), 1)
    v[rng.random(n) < 0.15] = np.nan
    w = rng.normal(size=n)
    w[rng.random(n) < 0.3] = np.nan
    return {"name": name, "num": num, "v": v, "w": w,
            "i": rng.integers(0, 4, n), "b": rng.random(n) < 0.5}


FRAME_OPS = {
    "dropDuplicates": lambda df, F: df.dropDuplicates(),
    "dropDuplicates_subset": lambda df, F: df.dropDuplicates(["name", "i"]),
    "distinct": lambda df, F: df.select("name", "v").distinct(),
    "orderBy_nulls": lambda df, F: df.orderBy("name", "v"),
    "orderBy_desc": lambda df, F: df.orderBy(F.col("v").desc(),
                                             F.col("name").asc()),
    "orderBy_ascending": lambda df, F: df.orderBy(["name", "w"],
                                                  ascending=[False, True]),
    "fillna_number": lambda df, F: df.fillna(0.5),
    "fillna_text": lambda df, F: df.fillna("?"),
    "fillna_dict": lambda df, F: df.fillna({"name": "none", "v": -1.0}),
    "fillna_subset": lambda df, F: df.na.fill(9.0, subset=["w"]),
    "dropna": lambda df, F: df.dropna(),
    "dropna_all": lambda df, F: df.dropna(how="all", subset=["v", "w"]),
    "dropna_thresh": lambda df, F: df.dropna(thresh=5),
    "dropna_subset": lambda df, F: df.na.drop(subset=["name"]),
    "sample": lambda df, F: df.sample(fraction=0.3, seed=7),
    "sample_replacement": lambda df, F: df.sample(True, 0.5, seed=3),
    "filter": lambda df, F: df.filter((F.col("v") > 0) | F.col("name")
                                      .isNull()),
    "when": lambda df, F: df.select(F.when(F.col("v") > 0, "pos")
                                    .when(F.col("v") < 0, F.col("name"))
                                    .otherwise(None).alias("sign"),
                                    F.when(F.col("w").isNull(), 1.0)
                                    .otherwise(0.0).alias("w_na")),
    "cast": lambda df, F: df.select(
        F.col("num").cast("double").alias("d"),
        F.col("num").cast("int").alias("n"),
        F.col("num").cast("boolean").alias("t"),
        F.col("v").cast("string").alias("s"),
        F.col("v").cast("int").alias("vi"),
        F.col("i").cast("double").alias("id")),
    "union": lambda df, F: df.select("name", "v").union(
        df.select("num", "w")),
    "unionByName": lambda df, F: df.select("name", "v").unionByName(
        df.select("v", "i"), allowMissingColumns=True),
    "global_aggregates": lambda df, F: df.select(
        F.avg("v"), F.min("v"), F.max("w"), F.count("name"), F.count("*"),
        F.stddev("v"), F.sum("i"), F.sum("w"), F.countDistinct("name")),
}


@pytest.mark.parametrize("case", list(FRAME_OPS))
def test_frame_operations_with_nulls_and_text_equal_jax(spark, psession,
                                                        case):
    from sml_tpu import functions as JF
    jdf, pdf = _both(spark, psession, _text_cols(), 4)
    assert_same_frame(FRAME_OPS[case](jdf, JF), FRAME_OPS[case](pdf, PF))


@pytest.mark.parametrize("how", ["describe", "describe_cols", "summary"])
def test_describe_with_nulls_and_text_equals_jax(spark, psession, how):
    """`describe` / `summary` equal the JAX package's cell for cell, but
    for min and max of a text column holding NULLs: there the JAX
    package's pandas `min` raises on the NULL and it writes NULL, where
    the port (as Spark) gives the least and greatest text
    (`ROADMAP.md` §3)."""
    jdf, pdf = _both(spark, psession, _text_cols(), 4)
    run = {"describe": lambda df: df.describe(),
           "describe_cols": lambda df: df.describe("v", "name"),
           "summary": lambda df: df.summary()}[how]
    want, got = run(jdf).toPandas(), run(pdf)._whole()
    assert list(want.columns) == list(got)
    stats = want["summary"].tolist()
    for c in want.columns:
        w = [_norm(x) for x in want[c].tolist()]
        g = got[c].tolist()
        if c in ("name", "num"):
            text = [x for x in _text_cols()[c] if x is not None]
            for st, pick in (("min", min), ("max", max)):
                if st in stats:
                    k = stats.index(st)
                    assert w[k] is None and g[k] == pick(text)
                    w[k] = g[k]
        assert g == w, c


def test_approx_quantile_with_nulls_equals_jax(spark, psession):
    jdf, pdf = _both(spark, psession, _text_cols(), 4)
    probs = [0.0, 0.1, 0.5, 0.75, 1.0]
    for col in ("v", "w", ["v", "w", "i"]):
        assert pdf.approxQuantile(col, probs, 0.0) == \
            jdf.approxQuantile(col, probs, 0.0)
