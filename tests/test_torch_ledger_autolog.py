"""The port's memory ledger (`sml_tpu_torch/obs/_ledger.py`) and fit
autologging (`obs.autolog_fit`), on the CPU.

- The ledger's live bytes per pool equal the bytes of the tensors the
  port's caches hold (the bin cache's matrices in `bin_cache`, its fold
  and element stacks in `stage_cache`), through stores, evictions and a
  clear; a boosted fit charges n f32 of margin to `boost_margin` for its
  duration; the chunked ingest charges its assembling matrix to
  `chunk_stage` and hands it to the bin cache; `memory_report()` lists
  the pools in the JAX package's table.
- `engine_metrics()["engine.hbm_peak_bytes"]` is the ledger's peak.
- With the recorder on and a tracking run active, only the outermost
  fit of a Pipeline or a CrossValidator logs its `engine.*` metrics, one
  entry a key, and the keys are those the JAX package's same flow logs.
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch import obs as pobs
from sml_tpu_torch import tracking as pt
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.ml import _staging

torch.set_num_threads(2)


def _cache_bytes_by_pool():
    out = {}
    with _staging._stage_lock:
        for key, t in _staging._bin_stage_cache.items():
            pool = _staging._bin_stage_pool[key]
            out[pool] = out.get(pool, 0) + t.numel() * t.element_size()
    return out


def _live(pool):
    return int(pobs.LEDGER.snapshot().get(pool, {}).get("live", 0))


def _assert_ledger_matches_caches():
    held = _cache_bytes_by_pool()
    for pool in ("bin_cache", "stage_cache"):
        assert _live(pool) == held.get(pool, 0), pool


@pytest.fixture()
def clean_cache():
    _staging.clear_bin_cache()
    yield
    _staging.clear_bin_cache()
    PCONF.unset("sml.tree.binCacheBytes")


def test_ledger_live_bytes_equal_the_caches_tensors(clean_cache):
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    a = rng.integers(0, 255, (1000, 7)).astype(np.uint8)
    b = rng.integers(0, 60000, (300, 5)).astype(np.uint16)
    st = rng.integers(0, 255, (3, 400, 7)).astype(np.uint8)
    _staging.stage_bins_cached(a, cpu)
    _staging.stage_bins_cached(b, cpu)
    _staging.stage_stacked_cached(st, cpu)
    assert _live("bin_cache") == a.nbytes + b.nbytes
    assert _live("stage_cache") == st.nbytes
    _assert_ledger_matches_caches()
    # a hit stores nothing
    _staging.stage_bins_cached(a, cpu)
    assert _live("bin_cache") == a.nbytes + b.nbytes
    # eviction past the budget frees the oldest entries' pools
    PCONF.set("sml.tree.binCacheBytes", st.nbytes + 1)
    c = rng.integers(0, 255, (10, 7)).astype(np.uint8)
    _staging.stage_bins_cached(c, cpu)
    _assert_ledger_matches_caches()
    assert _live("bin_cache") + _live("stage_cache") <= st.nbytes + 1
    _staging.clear_bin_cache()
    assert _live("bin_cache") == 0 and _live("stage_cache") == 0
    assert "bin_cache" in pobs.memory_report()


def test_boosted_fit_charges_its_margin(clean_cache):
    from sml_tpu_torch.ml._tree_models import _fit_ensemble
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1500, 4))
    y = (X[:, 0] + X[:, 1]).astype(np.float32)
    pobs.LEDGER.reset_peaks()
    kw = dict(categorical={}, max_depth=3, max_bins=16, min_instances=1,
              min_info_gain=0.0, n_trees=3, feature_k=None, bootstrap=False,
              subsample=1.0, seed=1, loss="squared", device="cpu")
    _fit_ensemble(X, y, boosting=True, **kw)
    snap = pobs.LEDGER.snapshot()["boost_margin"]
    assert snap["peak"] == 4 * 1500 and snap["live"] == 0
    pobs.LEDGER.reset_peaks()
    _fit_ensemble(X, y, boosting=False, **kw)  # a forest carries none
    assert pobs.LEDGER.snapshot()["boost_margin"]["peak"] == 0
    _assert_ledger_matches_caches()


def test_chunked_ingest_charges_chunk_stage(clean_cache):
    from sml_tpu_torch.frame._chunks import ArrayChunkSource
    from sml_tpu_torch.ml._chunked import ingest_source
    rng = np.random.default_rng(2)
    X = rng.normal(size=(3000, 6))
    pobs.LEDGER.reset_peaks()
    ing = ingest_source(ArrayChunkSource(X, None, chunk_rows=700), 32,
                        device="cpu")
    snap = pobs.LEDGER.snapshot()
    assert snap["chunk_stage"]["peak"] == ing.binned.nbytes
    assert snap["chunk_stage"]["live"] == 0
    assert _live("bin_cache") == ing.binned.nbytes
    _assert_ledger_matches_caches()


def test_hbm_peak_bytes_reads_the_ledger(clean_cache):
    pobs.LEDGER.reset_peaks()
    _staging.stage_bins_cached(np.ones((512, 8), np.uint8),
                               torch.device("cpu"))
    peak = pobs.engine_metrics()["engine.hbm_peak_bytes"]
    assert peak == float(pobs.LEDGER.peak_total()) >= 4096.0


# ------------------------------------------------------------- autologging
@pytest.fixture()
def runs(tmp_path):
    from sml_tpu import obs as jobs
    from sml_tpu import tracking as jt
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    root = str(tmp_path / "runs")
    prev = {c: c.get("sml.obs.enabled") for c in (PCONF, JCONF)}
    for m in (pt, jt):
        m.set_tracking_uri(root)
        m._active_experiment["id"] = None
    for c in prev:
        c.set("sml.obs.enabled", True)
    PCONF.set("sml.device", "cpu")
    pobs.reset()
    jobs.reset()
    yield jt
    for m in (pt, jt):
        while m.active_run():
            m.end_run()
        m._active_experiment["id"] = None
    for c, v in prev.items():
        c.set("sml.obs.enabled", bool(v))
    PCONF.unset("sml.device")
    pobs.reset()
    jobs.reset()


def _cols(n=600, seed=0):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=n), rng.normal(size=n)
    return {"a": a, "b": b, "y": 2.0 * a - b + rng.normal(0, 0.1, n)}


def _history(tracking, run_id):
    from importlib import import_module
    store = import_module(tracking.__name__ + "._store")
    return store.read_run(store.find_run(run_id))["metrics_history"]


def _flow(kind, jax: bool, spark=None):
    """Fit a Pipeline (assembler + DT), or a CrossValidator over one,
    inside a run of the package; returns the run's metric history."""
    if jax:
        import pandas as pd

        from sml_tpu import tracking as tr
        from sml_tpu.ml import Pipeline, evaluation, feature, regression, \
            tuning
        df = spark.createDataFrame(pd.DataFrame(_cols()))
    else:
        from sml_tpu_torch import tracking as tr
        from sml_tpu_torch.frame.session import get_session
        from sml_tpu_torch.ml import evaluation, feature, regression, tuning
        from sml_tpu_torch.ml.base import Pipeline
        df = get_session().createDataFrame(_cols())
    va = feature.VectorAssembler(inputCols=["a", "b"], outputCol="features")
    dt = regression.DecisionTreeRegressor(labelCol="y", maxDepth=3,
                                          maxBins=16)
    est = Pipeline(stages=[va, dt])
    if kind == "cv":
        grid = tuning.ParamGridBuilder().addGrid(
            dt.getParam("maxDepth"), [2, 3]).build()
        est = tuning.CrossValidator(
            estimator=est, estimatorParamMaps=grid,
            evaluator=evaluation.RegressionEvaluator(labelCol="y"),
            numFolds=2, seed=7)
    with tr.start_run() as run:
        est.fit(df)
    return _history(tr, run.info.run_id)


@pytest.mark.parametrize("kind", ["pipeline", "cv"])
def test_only_the_outermost_fit_logs(runs, spark, kind):
    hist = _flow(kind, jax=False)
    keys = {k for k in hist if k.startswith("engine.")}
    assert keys, hist
    assert all(len(hist[k]) == 1 for k in keys), \
        {k: len(hist[k]) for k in keys}
    jhist = _flow(kind, jax=True, spark=spark)
    assert keys == {k for k in jhist if k.startswith("engine.")}
    assert hist["engine.hbm_peak_bytes"][0]["value"] >= 0.0


def test_autolog_off_logs_nothing(runs):
    PCONF.set("sml.obs.autoLogRunMetrics", False)
    try:
        hist = _flow("pipeline", jax=False)
    finally:
        PCONF.unset("sml.obs.autoLogRunMetrics")
    assert not [k for k in hist if k.startswith("engine.")]
