"""The port's Koalas layer (`sml_tpu_torch.pandas_api`) against the JAX
package's (`sml_tpu.pandas_api`), on the CPU: the six Koalas cases of
`tests/test_pandas_api_timeseries.py:12-69, 243-259` and ML 14's flow
(`tests/test_lessons.py:517-531`), each run through both packages on
the same rows.

What returns a pandas object (`to_pandas`, `value_counts`, `describe`,
`dtypes`, the `GroupBy` aggregates) is held equal to the JAX package's
with pandas' own assertions, exactly; the port-backed frames
(`to_spark`, `head`, `filter`, `sort_values`, `__getitem__`, `ks.sql`,
the readers) partition for partition (`assert_same_frame`); scalars
(`len`, `shape`, `mean`, `count`) equal. `columns` is a list with
`tolist()` where the JAX package's is a pandas Index.
"""

import numpy as np
import pandas as pd
import pytest

import sml_tpu_torch.pandas_api as pks
from sml_tpu_torch.frame.session import get_session

from test_torch_frame_sql import assert_same_frame


@pytest.fixture()
def both(spark, airbnb_pdf):
    """(JAX Koalas module, its frame) and (the port's, its frame)."""
    import sml_tpu.pandas_api as jks
    return ((jks, jks.DataFrame(spark.createDataFrame(airbnb_pdf))),
            (pks, pks.DataFrame(get_session().createDataFrame(airbnb_pdf))))


def test_kdf_roundtrip(spark, airbnb_pdf):
    j = spark.createDataFrame(airbnb_pdf).to_koalas()
    p = get_session().createDataFrame(airbnb_pdf).to_koalas()
    assert isinstance(p, pks.DataFrame)
    assert_same_frame(j.to_spark(), p.to_spark())
    assert p.to_spark().count() == len(airbnb_pdf)
    pd.testing.assert_frame_equal(p.to_pandas(), j.to_pandas())
    assert set(p.to_pandas().columns) == set(airbnb_pdf.columns)
    assert list(p.columns) == list(j.columns)
    indexed = get_session().createDataFrame(airbnb_pdf).to_koalas(
        index_col="id")
    pd.testing.assert_frame_equal(
        indexed.to_pandas(),
        spark.createDataFrame(airbnb_pdf).to_koalas(index_col="id")
        .to_pandas())


def test_kdf_value_counts_and_ops(both, airbnb_pdf):
    (jks, jkdf), (_, kdf) = both
    vc = kdf["room_type"].value_counts()
    pd.testing.assert_series_equal(vc, jkdf["room_type"].value_counts())
    assert vc.sum() == len(airbnb_pdf)
    assert vc.index[0] == airbnb_pdf["room_type"].value_counts().index[0]
    pd.testing.assert_series_equal(
        kdf["room_type"].value_counts(normalize=True, ascending=True),
        jkdf["room_type"].value_counts(normalize=True, ascending=True))
    for k in (kdf, jkdf):
        k["total"] = k["bedrooms"] + k["accommodates"]
    pd.testing.assert_frame_equal(kdf.to_pandas(), jkdf.to_pandas())
    assert np.allclose(kdf.to_pandas()["total"],
                       airbnb_pdf["bedrooms"] + airbnb_pdf["accommodates"])
    cheap, jcheap = kdf[kdf["price"] < 100], jkdf[jkdf["price"] < 100]
    assert_same_frame(jcheap.to_spark(), cheap.to_spark())
    assert cheap.to_pandas()["price"].max() < 100
    for name in ("mean", "sum", "max", "min", "count"):
        assert getattr(kdf["price"], name)() == \
            getattr(jkdf["price"], name)(), name
    assert kdf["price"].mean() == pytest.approx(airbnb_pdf["price"].mean(),
                                                rel=1e-9)


def test_kdf_groupby_sort(both, airbnb_pdf):
    (_, jkdf), (_, kdf) = both
    # the JAX package's grouped frame grows its columns one by one, so
    # its column Index is object-typed; the port's is built at once (str)
    g = kdf.groupby("room_type").count()
    pd.testing.assert_frame_equal(g, jkdf.groupby("room_type").count(),
                                  check_column_type=False)
    assert len(g) == airbnb_pdf["room_type"].nunique()
    for how in ("mean", "sum", "max", "min"):
        pd.testing.assert_frame_equal(
            getattr(kdf.groupby("room_type"), how)(),
            getattr(jkdf.groupby("room_type"), how)(),
            check_column_type=False)
    pd.testing.assert_frame_equal(
        kdf.groupby("room_type").agg({"price": "max"}),
        jkdf.groupby("room_type").agg({"price": "max"}),
        check_column_type=False)
    top = kdf.sort_values("price", ascending=False).head(3)
    assert_same_frame(
        jkdf.sort_values("price", ascending=False).head(3).to_spark(),
        top.to_spark())
    assert list(top.to_pandas()["price"]) == \
        sorted(airbnb_pdf["price"], reverse=True)[:3]


def test_ks_sql(both, airbnb_pdf):
    (jks, jkdf), (_, kdf) = both
    q = "SELECT room_type, COUNT(*) AS n FROM {kdf} GROUP BY room_type"
    out = pks.sql(q, kdf=kdf)
    pd.testing.assert_frame_equal(
        out.to_pandas().sort_values("room_type").reset_index(drop=True),
        jks.sql(q, kdf=jkdf).to_pandas().sort_values("room_type")
        .reset_index(drop=True))
    assert out.to_pandas()["n"].sum() == len(airbnb_pdf)
    # a frame found among the caller's locals, as ML 14 writes it
    assert pks.sql("select distinct(room_type) from {kdf}").to_spark() \
        .count() == 3


def test_ks_read_delta(spark, airbnb_pdf, tmp_path):
    import sml_tpu.pandas_api as jks
    path = str(tmp_path / "tbl")
    spark.createDataFrame(airbnb_pdf).write.format("delta").save(path)
    kdf, jkdf = pks.read_delta(path), jks.read_delta(path)
    assert len(kdf) == len(jkdf) == len(airbnb_pdf)
    assert kdf.shape == jkdf.shape
    assert_same_frame(jkdf.to_spark(), kdf.to_spark())
    assert_same_frame(jks.read_delta(path, version=0).to_spark(),
                      pks.read_delta(path, version=0).to_spark())
    pks.set_option("compute.shortcut_limit", 10)
    assert pks.get_option("compute.shortcut_limit") == 10
    pks.reset_option("compute.shortcut_limit")
    assert pks.get_option("compute.shortcut_limit") == \
        jks.get_option("compute.shortcut_limit") == 1000


def test_kdf_filter_plot_and_options(both):
    """The ML 14 cells `ML 14:180-186`: options.plotting.backend,
    filter(items=), and the kdf.plot.hist accessor."""
    import matplotlib
    matplotlib.use("Agg")
    (jks, jkdf), (_, kdf) = both
    pks.options.plotting.backend = "matplotlib"
    assert pks.get_option("plotting.backend") == "matplotlib"
    assert pks.options.compute.shortcut_limit == 1000
    graph_kdf = kdf.filter(items=["bedrooms", "price"])
    assert sorted(graph_kdf.columns.tolist()) == ["bedrooms", "price"]
    assert_same_frame(jkdf.filter(items=["bedrooms", "price"]).to_spark(),
                      graph_kdf.to_spark())
    assert_same_frame(jkdf.filter(like="bed").to_spark(),
                      kdf.filter(like="bed").to_spark())
    assert_same_frame(jkdf.filter(regex="^n").to_spark(),
                      kdf.filter(regex="^n").to_spark())
    ax = graph_kdf.plot.hist(x="bedrooms", y="price", bins=20)
    assert ax is not None
    assert kdf[["bedrooms", "price"]].plot.hist(bins=20) is not None
    assert kdf["price"].plot.hist(bins=10) is not None
    import matplotlib.pyplot as plt
    plt.close("all")


def test_kdf_verbs_and_metadata(both):
    (jks, jkdf), (_, kdf) = both
    pd.testing.assert_series_equal(kdf.dtypes, jkdf.dtypes)
    pd.testing.assert_frame_equal(kdf.describe(), jkdf.describe())
    for verb in (lambda k: k.drop(columns=["id", "price"]),
                 lambda k: k.rename({"price": "cost"}),
                 lambda k: k.dropna(), lambda k: k.fillna(0),
                 lambda k: k[["room_type", "price"]],
                 lambda k: k.sort_values(["bedrooms", "price"])):
        assert_same_frame(verb(jkdf).to_spark(), verb(kdf).to_spark())
    assert kdf.price.count() == jkdf.price.count()
    assert_same_frame(jks.range(7).to_spark(), pks.range(7).to_spark())
    assert pks.from_pandas(jkdf.to_pandas()).shape == jkdf.shape
    assert pks.DataFrame({"a": [1, 2]}).shape == (2, 1)
    with pytest.raises(TypeError):
        pks.DataFrame(3)


# ---------------------------------------------------------------- ML 14
def test_ml14_koalas(spark, tmp_path):
    """ML 14 on a Delta table: value_counts, the plotting backend and
    filter(items=) into a histogram, `ks.sql` over a local frame."""
    import matplotlib
    matplotlib.use("Agg")
    import sml_tpu.pandas_api as jks
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    path = str(tmp_path / "clean")
    spark.createDataFrame(jmake(n=2000, seed=42).dropna()) \
        .write.format("delta").save(path)
    jdf = spark.read.format("delta").load(path)
    df = get_session().read.format("delta").load(path)
    assert_same_frame(jdf, df)
    kdf, jkdf = pks.DataFrame(df), jks.DataFrame(jdf)
    vc = kdf["room_type"].value_counts()
    pd.testing.assert_series_equal(vc, jkdf["room_type"].value_counts())
    assert vc.sum() == df.count()
    pks.options.plotting.backend = "matplotlib"
    assert kdf.filter(items=["bedrooms", "price"]) \
        .plot.hist(x="bedrooms", y="price", bins=20) is not None
    distinct = pks.sql("select distinct(room_type) from {kdf}")
    kdf = jkdf
    jdistinct = jks.sql("select distinct(room_type) from {kdf}")
    assert sorted(distinct.to_pandas()["room_type"]) == \
        sorted(jdistinct.to_pandas()["room_type"])
    assert len(distinct.to_pandas()) == df.toPandas()["room_type"].nunique()
    import matplotlib.pyplot as plt
    plt.close("all")
