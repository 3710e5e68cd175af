"""Three faults of the port, repaired and held against the live JAX
package on the CPU.

1. The profiler: `PROFILER.enabled` reads the `sml.profiler.enabled`
   key (assigning it sets the key); spans nest, each keeping its self
   time (`Span.self_s`); `report()` is the JAX package's table
   (`tests/test_engine_report.py:17-70`'s cases: the route and skew
   columns, a skewed shuffle's skew factor, the engine counters, bytes
   in MB), and `reset` clears it. The port's counters keep counting
   while the profiler is off (the batcher's `serve.*` counters are its
   record of requests), where the JAX package counts only while on.
2. `df.rdd.getNumPartitions()` (`ML 00b:84`), `df.rdd.glom()` and
   `df.checkpoint()`.
3. `F.concat` gives NULL where any input is NULL, as Spark and the JAX
   package do; `F.concat_ws` skips NULL inputs, as Spark does (the JAX
   package gives NULL there, through pandas' NaN: a recorded deviation).
"""

import numpy as np
import pandas as pd
import pytest

from sml_tpu_torch import GLOBAL_CONF as PCONF
from sml_tpu_torch import functions as PF
from sml_tpu_torch.frame.column import object_array
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.utils.profiler import PROFILER


def _unstage(kept):
    """Drop what the JAX package's staging cache took in since it held
    the keys `kept`: the cache lives as long as the process, and a later
    test in it that stages the same rows expects a miss."""
    from sml_tpu.ml import _staging
    from sml_tpu.obs import LEDGER
    freed = 0
    with _staging._stage_lock:
        for entry in list(_staging._stage_cache_order):
            key, cost = entry
            if key not in kept:
                _staging._stage_cache_order.remove(entry)
                _staging._stage_cache.pop(key, None)
                _staging._stage_cache_bytes[0] -= cost
                freed += cost
    if freed:
        LEDGER.free("stage_cache", freed)


@pytest.fixture()
def profiling():
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.ml import _staging
    from sml_tpu.utils.profiler import PROFILER as JPROF
    kept = set(_staging._stage_cache)
    for conf in (PCONF, JCONF):
        conf.set("sml.profiler.enabled", True)
    PROFILER.reset()
    JPROF.reset()
    yield JPROF
    for conf in (PCONF, JCONF):
        conf.set("sml.profiler.enabled", False)
    PROFILER.reset()
    JPROF.reset()
    _unstage(kept)


def _skewed(n=4000):
    # tests/test_engine_report.py's rows
    rng = np.random.default_rng(0)
    block = {"k": object_array(rng.choice(["a", "b", "c"], n,
                                          p=[0.8, 0.1, 0.1]).tolist()),
             "x1": rng.normal(size=n), "x2": rng.normal(size=n)}
    block["label"] = block["x1"] * 2 + rng.normal(size=n)
    return block


def test_enabled_is_the_conf_key():
    assert PROFILER.enabled is False
    PCONF.set("sml.profiler.enabled", "true")
    try:
        assert PROFILER.enabled is True
        PROFILER.enabled = False
        assert PCONF.get("sml.profiler.enabled") is False
        PROFILER.enabled = True
        assert PCONF.getBool("sml.profiler.enabled")
    finally:
        PCONF.set("sml.profiler.enabled", False)
        PROFILER.reset()
    with PROFILER.span("off"):
        pass
    assert PROFILER.spans() == []


def test_report_has_route_skew_and_counters_as_the_jax_report(spark,
                                                              profiling):
    from sml_tpu.ml.feature import VectorAssembler as JVA
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import LinearRegression
    jprof = profiling
    block = _skewed()
    pdf = get_session().createDataFrame(block)
    jdf = spark.createDataFrame(pd.DataFrame(
        {c: (pd.Series(v, dtype=object) if v.dtype.kind == "O" else v)
         for c, v in block.items()}))
    pdf.groupBy("k").count().collect()
    jdf.groupBy("k").count().toPandas()
    PCONF.set("sml.device", "cpu")
    try:
        for df, VA, LR in ((pdf, VectorAssembler, LinearRegression),
                           (jdf, JVA, JLR)):
            fdf = VA(inputCols=["x1", "x2"],
                     outputCol="features").transform(df)
            for _ in range(2):
                LR(labelCol="label").fit(fdf)
    finally:
        PCONF.unset("sml.device")
    PROFILER.count("test.read_bytes", 2.5e6)
    report, jreport = PROFILER.report(), jprof.report()
    assert report.splitlines()[0] == jreport.splitlines()[0]
    assert "route" in report.splitlines()[0]
    assert "skew" in report.splitlines()[0]

    def skew(text):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("shuffle.partition")]
        assert lines, text
        return float(lines[0].split()[-1])

    assert skew(report) == skew(jreport) > 1.0
    assert "---- engine counters ----" in report
    assert any(ln.startswith("test.read_bytes") and ln.endswith(
        "2.5 MB") for ln in report.splitlines()), report
    routed = [ln for ln in report.splitlines()
              if ln.startswith("program.gram")]
    assert routed and routed[0].split()[-2] == "cpu", report
    spans = {s.name: s for s in PROFILER.spans()}
    assert spans["shuffle.partition"].meta["skew"] > 1.0


def test_self_time_nets_out_nested_spans(profiling):
    import time
    with PROFILER.span("outer"):
        time.sleep(0.02)
        with PROFILER.span("inner"):
            time.sleep(0.03)
    spans = {s.name: s for s in PROFILER.spans()}
    outer, inner = spans["outer"], spans["inner"]
    assert inner.self_s == pytest.approx(inner.wall_s)
    assert outer.self_s == pytest.approx(outer.wall_s - inner.wall_s)
    lines = PROFILER.report().splitlines()
    assert lines[1].startswith("inner") and lines[2].startswith("outer")


def test_reset_clears_and_counters_count_while_off(profiling):
    PROFILER.count("staging.h2d_bytes", 123.0)
    assert PROFILER.counters()["staging.h2d_bytes"] == 123.0
    PROFILER.reset()
    assert PROFILER.counters() == {} and PROFILER.spans() == []
    PCONF.set("sml.profiler.enabled", False)
    PROFILER.count("serve.requests")
    assert PROFILER.counters() == {"serve.requests": 1.0}


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_rdd_and_checkpoint_equal_jax(spark, parts):
    block = {"a": np.arange(20.0), "s": object_array(
        [None if i % 7 == 0 else f"s{i}" for i in range(20)])}
    pdf = get_session().createDataFrame(block, numPartitions=parts)
    jdf = spark.createDataFrame(pd.DataFrame(
        {"a": block["a"], "s": pd.Series(block["s"], dtype=object)}),
        numPartitions=parts)
    assert pdf.rdd.getNumPartitions() == jdf.rdd.getNumPartitions() == parts
    got = pdf.rdd.glom()
    want = jdf.rdd.glom()
    assert [len(p) for p in got] == [len(p) for p in want]
    for gp, wp in zip(got, want):
        for g, w in zip(gp, wp):
            assert g["a"] == w["a"]
            assert g["s"] == (None if w["s"] is None or w["s"] != w["s"]
                              else w["s"])
    assert pdf.checkpoint() is pdf and pdf._parts is not None
    assert pdf.repartition(4).rdd.getNumPartitions() == \
        jdf.repartition(4).rdd.getNumPartitions()


def _concat_frames(spark):
    block = {"a": object_array(["x", None, "z", "w"]),
             "b": object_array(["1", "2", None, "4"]),
             "f": np.array([1.5, 2.0, 3.0, np.nan])}
    jdf = spark.createDataFrame(pd.DataFrame(
        {"a": pd.Series(block["a"], dtype=object),
         "b": pd.Series(block["b"], dtype=object), "f": block["f"]}))
    return jdf, get_session().createDataFrame(block)


@pytest.mark.parametrize("cols", [("a", "b"), ("a", "f"), ("b", "a", "f")])
def test_concat_is_null_where_an_input_is_null_as_in_jax(spark, cols):
    from sml_tpu import functions as JF
    jdf, pdf = _concat_frames(spark)
    want = [r[0] for r in jdf.select(JF.concat(*cols)).collect()]
    got = [r[0] for r in pdf.select(PF.concat(*cols)).collect()]
    want = [None if w is None or w != w else w for w in want]
    assert got == want
    assert got[0] == "".join({"a": "x", "b": "1", "f": "1.5"}[c]
                             for c in cols)


def test_concat_ws_skips_nulls_as_spark_does(spark):
    from sml_tpu import functions as JF
    jdf, pdf = _concat_frames(spark)
    got = [r[0] for r in pdf.select(PF.concat_ws("-", "a", "b")).collect()]
    assert got == ["x-1", "2", "z", "w-4"]
    three = [r[0] for r in pdf.select(PF.concat_ws("-", "a", "b", "f"))
             .collect()]
    assert three == ["x-1-1.5", "2-2.0", "z-3.0", "w-4"]
    # the JAX package agrees where no input is NULL, and gives NULL
    # (pandas' NaN) where one is: the recorded deviation
    want = [r[0] for r in jdf.select(JF.concat_ws("-", "a", "b")).collect()]
    assert want[0] == got[0] == "x-1"
    assert all(w is None or w != w for w in want[1:3])
