"""The port's DataFrame layer against the JAX package's, on the CPU.

Spark's split sampler (`hash_seed`, `XORShiftRandom`,
`partition_uniforms`) and the murmur3 hashing are held to the JAX
package's live output and to the Spark pins of
`tests/test_random_split.py` and `tests/test_hashing.py`; the host C++
libraries (`csrc/murmur3.cc`, `csrc/xorshift.cc`) to their plain
versions. `randomSplit` must give the JAX package's rows in the JAX
package's order under every partition layout: the random-forest
bootstrap draws its weights by row index, so a row in another place
changes every tree. Frames are compared column by column, NaN and None
included.
"""

import numpy as np
import pytest

from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame import functions as PF
from sml_tpu_torch.frame.column import object_array
from sml_tpu_torch.frame.sampling import (XORShiftRandom, hash_seed,
                                          partition_uniforms,
                                          partition_uniforms_plain,
                                          presplit_sort)
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.native import hashing as phash

# Spark's XORShiftRandom.hashSeed and nextDouble, pinned in
# tests/test_random_split.py
HASH_SEED_VECTORS = {0: 0x427B0291EEA8D4AE, 1: 0xEB35A34DF420ED6F,
                     42: 0xCEA176B6C35E99CF, 12345: 0x1A5B3ACFF3616EB8}
NEXT_DOUBLE_VECTORS = {
    0: [0.8446490682263027, 0.4048454303385226,
        0.5871875724155838, 0.8865128837019473],
    42: [0.6661236774413726, 0.8583151351252906,
         0.9139963682495181, 0.8664942556157945],
    12345: [0.3217855146445381, 0.5926558057691951,
            0.3530876039804548, 0.18715752944048802],
}


def assert_same_block(jax_pdf, block):
    """A JAX package frame's pandas rows equal a port block, column by
    column, in order: floats bit for bit with NaN in the same places,
    text with its NULLs in the same places."""
    assert list(jax_pdf.columns) == list(block)
    for c in jax_pdf.columns:
        want, got = jax_pdf[c].to_numpy(), block[c]
        assert len(want) == len(got), c
        if want.dtype.kind == "f":
            np.testing.assert_array_equal(got, want, err_msg=c)
            assert got.dtype == want.dtype, c
        else:
            w = [None if (isinstance(v, float) and v != v) or v is None
                 else v for v in want.tolist()]
            assert got.tolist() == w, c


@pytest.fixture(scope="module")
def psession():
    return get_session()


# ------------------------------------------------------- the split sampler
@pytest.mark.parametrize("seed", sorted(HASH_SEED_VECTORS))
def test_hash_seed_matches_spark_and_jax(seed):
    from sml_tpu.frame import sampling as js
    assert hash_seed(seed) == HASH_SEED_VECTORS[seed] == js.hash_seed(seed)


@pytest.mark.parametrize("seed", sorted(NEXT_DOUBLE_VECTORS))
def test_xorshift_draws_match_spark_and_jax(seed):
    from sml_tpu.frame import sampling as js
    rng = XORShiftRandom(seed)
    got = [rng.next_double() for _ in range(4)]
    assert got == NEXT_DOUBLE_VECTORS[seed]
    jrng = js.XORShiftRandom(seed)
    assert got == [jrng.next_double() for _ in range(4)]


@pytest.mark.parametrize("seed, part, n", [(42, 0, 1), (42, 3, 1000),
                                           (7, 11, 257), (2**31 - 1, 2, 64)])
def test_partition_uniforms_library_matches_plain_and_jax(seed, part, n):
    from sml_tpu.frame import sampling as js
    got = partition_uniforms(seed, part, n)
    np.testing.assert_array_equal(got, partition_uniforms_plain(seed, part,
                                                                n))
    np.testing.assert_array_equal(got, js.partition_uniforms(seed, part, n))
    assert partition_uniforms(seed, part, 0).shape == (0,)


# ------------------------------------------------------------- hashing
def _hash_columns():
    rng = np.random.default_rng(3)
    floats = rng.normal(size=50)
    floats[[3, 9]] = np.nan
    floats[4] = -0.0
    return {
        "int64": rng.integers(-2**40, 2**40, 50),
        "int32": rng.integers(-1000, 1000, 50).astype(np.int32),
        "float64": floats,
        "float32": floats.astype(np.float32),
        "bool": rng.random(50) < 0.5,
        "string": object_array([None if i % 7 == 0 else f"s{i}ü" * (i % 5)
                                for i in range(50)]),
    }


@pytest.mark.parametrize("kind", list(_hash_columns()))
def test_murmur3_library_matches_plain_and_jax(kind):
    import pandas as pd
    from sml_tpu.native import hashing as jhash
    col = _hash_columns()[kind]
    seeds = np.random.default_rng(5).integers(-2**31, 2**31, 50) \
        .astype(np.int32)
    got = phash.hash_column(col, seeds)
    np.testing.assert_array_equal(got, phash.hash_column_plain(col, seeds))
    np.testing.assert_array_equal(got, jhash.hash_column(pd.Series(col),
                                                         seeds))


def test_murmur3_matches_the_course_constants_and_chains_columns():
    import pandas as pd
    from sml_tpu.native import hashing as jhash
    col = object_array(["8", "100000"])
    assert phash.hash_columns([col]).tolist() == [-1276280174, -972882115]
    assert phash.hash_scalar("8") == -1276280174
    cols = _hash_columns()
    got = phash.hash_columns(cols.values())
    want = jhash.hash_columns([pd.Series(v) for v in cols.values()])
    np.testing.assert_array_equal(got, want)
    assert (phash.hash_partition_ids(got, 8) >= 0).all()


def test_host_libraries_build_from_the_checkout():
    from sml_tpu_torch.native import build
    assert {"murmur3", "xorshift"} <= set(build.host_sources())
    for name in ("murmur3", "xorshift"):
        assert build.load(name) is not None


# ------------------------------------------------------ the pre-split sort
def test_presplit_sort_orders_nan_first_and_strings_by_code_point():
    import pandas as pd
    from sml_tpu.frame.sampling import presplit_sort as jsort
    block = {
        "a": np.array([2.0, np.nan, 1.0, 2.0, 1.0, np.nan, 0.5, 2.0]),
        "s": object_array(["b", None, "a", "a", "Z", "é", "a", None]),
        "i": np.array([3, 1, 2, 3, 1, 0, 2, 3]),
        "v": np.arange(16.0).reshape(8, 2),
    }
    got = presplit_sort(block)
    pdf = pd.DataFrame({"a": block["a"],
                        "s": pd.Series(block["s"], dtype="str"),
                        "i": block["i"]})
    want = jsort(pdf)
    assert_same_block(want, {c: got[c] for c in "asi"})
    # the vector column is carried along, not sorted by
    order = [int(r) for r in got["v"][:, 0] // 2]
    np.testing.assert_array_equal(got["i"], block["i"][order])


# ---------------------------------------------------------------- frames
@pytest.fixture(scope="module")
def airbnb(psession):
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    return jmake(n=5_000, seed=42), make_airbnb_dataset(n=5_000, seed=42)


def test_dataset_matches_jax_column_for_column(airbnb):
    jpdf, cols = airbnb
    assert_same_block(jpdf, cols)
    assert len(cols) == 23
    for c in ("bedrooms", "bathrooms", "review_scores_rating"):
        assert np.isnan(cols[c]).any()


@pytest.mark.parametrize("layout", ["8 partitions", "3 partitions",
                                    "repartition(24)"])
def test_random_split_gives_jax_rows_in_jax_order(spark, psession, airbnb,
                                                  layout):
    jpdf, cols = airbnb
    if layout == "3 partitions":
        jdf = spark.createDataFrame(jpdf, numPartitions=3)
        pdf = psession.createDataFrame(cols, numPartitions=3)
    else:
        jdf, pdf = spark.createDataFrame(jpdf), psession.createDataFrame(cols)
        if layout == "repartition(24)":
            jdf, pdf = jdf.repartition(24), pdf.repartition(24)
    assert pdf.getNumPartitions() == len(jdf._materialize())
    jsplits = jdf.randomSplit([0.8, 0.2], seed=42)
    psplits = pdf.randomSplit([0.8, 0.2], seed=42)
    for j, p in zip(jsplits, psplits):
        assert_same_block(j.toPandas(), p._whole())
    assert sum(p.count() for p in psplits) == 5_000
    # the same split again is the same frames (the 2-deep memo)
    assert pdf.randomSplit([0.8, 0.2], seed=42)[0] is psplits[0]


def test_random_split_legacy_sampler_matches_jax(spark, psession, airbnb):
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
    jpdf, cols = airbnb
    JCONF.set("sml.split.sampler", "legacy")
    PCONF.set("sml.split.sampler", "legacy")
    try:
        j = spark.createDataFrame(jpdf).randomSplit([0.7, 0.3], seed=3)
        p = psession.createDataFrame(cols).randomSplit([0.7, 0.3], seed=3)
        for a, b in zip(j, p):
            assert_same_block(a.toPandas(), b._whole())
    finally:
        JCONF.set("sml.split.sampler", "spark")
        PCONF.unset("sml.split.sampler")


def test_column_expressions_match_jax(spark, psession, airbnb):
    from sml_tpu import functions as F
    jpdf, cols = airbnb

    def chain(df, f):
        return (df.withColumn("log_price", f.log(f.col("price")))
                .withColumn("back", f.exp(f.col("log_price")))
                .withColumn("ratio", f.col("price") / f.col("accommodates")
                            + 1 - f.col("beds") * 2)
                .withColumn("big", f.col("price") >= 200)
                .withColumn("tier", f.when(f.col("price") > 300, "high")
                            .when(f.col("price") > 100, "mid")
                            .otherwise("low"))
                .withColumn("beds_or_null", f.when(f.col("bedrooms") > 1,
                                                   f.col("bedrooms")))
                .withColumn("no_bath", f.col("bathrooms").isNull())
                .withColumn("rooms", f.col("bedrooms").cast("int"))
                .withColumn("sq", f.sqrt(f.abs(f.col("longitude"))))
                .withColumn("r", f.round(f.col("latitude"), 2))
                .withColumn("h", f.hash(f.col("room_type"), f.col("price")))
                .filter((f.col("room_type") == "Private room")
                        | ~(f.col("price") < 150) & f.col("bedrooms")
                        .isNotNull())
                .drop("bed_type")
                .withColumnRenamed("beds", "n_beds"))

    want = chain(spark.createDataFrame(jpdf), F).toPandas()
    got = chain(psession.createDataFrame(cols), PF)._whole()
    assert_same_block(want, got)
    assert got["rooms"].dtype.kind == "f"  # NULLs keep a cast int float


def test_describe_summary_and_quantiles_match_jax(spark, psession, airbnb):
    jpdf, cols = airbnb
    names = ["price", "bedrooms", "room_type", "review_scores_rating"]
    j = spark.createDataFrame(jpdf)
    p = psession.createDataFrame(cols)
    assert_same_block(j.describe(*names).toPandas(),
                      p.describe(*names)._whole())
    assert_same_block(j.select(*names).summary().toPandas(),
                      p.select(*names).summary()._whole())
    assert p.approxQuantile("price", [0.1, 0.5, 0.9]) == \
        j.approxQuantile("price", [0.1, 0.5, 0.9])


def test_frame_actions_and_wide_ops(psession):
    df = psession.createDataFrame(
        [(1, "a", 2.0), (2, "b", None), (1, "a", 2.0), (3, None, 5.0)],
        ["k", "s", "x"])
    assert df.columns == ["k", "s", "x"]
    assert df.dtypes == [("k", "bigint"), ("s", "string"), ("x", "double")]
    assert df.count() == 4 and df.first().k == 1
    rows = df.collect()
    assert rows[1].x is None and rows[3].s is None
    assert df.distinct().count() == 3
    assert df.dropna().count() == 2
    assert df.dropna(subset=["x"]).count() == 3
    assert df.fillna(0.0).collect()[1].x == 0.0
    assert df.fillna("z").collect()[3].s == "z"
    ordered = df.orderBy(PF.col("x").desc()).collect()
    assert [r.x for r in ordered] == [5.0, 2.0, 2.0, None]
    assert [r.k for r in df.orderBy("k", "x").collect()] == [1, 1, 2, 3]
    assert df.union(df).count() == 8
    assert df.unionByName(df.select("x", "s", "k")).count() == 8
    assert df.repartition(3).getNumPartitions() == 3
    assert df.repartition(4, "k").getNumPartitions() == 4
    assert df.coalesce(1).getNumPartitions() == 1
    assert df.limit(2).count() == 2 and len(df.take(3)) == 3
    agg = df.select(PF.avg("x"), PF.max("s"), PF.count("*")).collect()[0]
    assert agg["avg(x)"] == 3.0 and agg["max(s)"] == "b"
    assert agg["count(1)"] == 4
    assert df.toDF("a", "b", "c").columns == ["a", "b", "c"]
    assert psession.range(5).count() == 5
