"""The port's chunked data plane against the live JAX package, on the CPU.

The same seeded numpy inputs go through `sml_tpu` (its 8-device CPU
mesh, `sml.tree.kernel=xla`) and through `sml_tpu_torch` with
device="cpu", where the kernels' plain versions run.

- Sources, splits and folds: `row_uniforms`, `split_assignments`,
  `chunk_random_split` (nested too) and `FoldChunkSource` keep the same
  rows as the JAX package's, bit for bit, for chunkings of 64, 1,000 and
  all rows.
- Sketches: `FeatureSketch` and `DatasetSketch` hold the same values and
  weights and give the same quantiles as the JAX package's, in exact mode
  and compressed (a small `exact_cap` and `buckets`), through `merge` and
  a `to_dict` / `from_dict` round trip.
- Ingest: `binned`, `binning` and `y` equal the port's `make_bins` and
  the JAX package's `ingest_source`; the pipeline dispatches chunk i+1
  before chunk i drains; a second ingest of the same source hits the memo
  and the fit hits the assembled device matrix in the bin cache.
- Fits: `fit_ensemble_chunked` (an RF bootstrap, a GBT at subsample 0.7,
  an XGBoost-shaped fit) equals the port's `_fit_ensemble` bit for bit;
  against the JAX package's `fit_ensemble_chunked` on dyadic labels the
  split tables are equal and the values within rtol 1e-6 plus 1e-6 of the
  tree's largest value (boosted gradients are not dyadic, and the port
  sums in float64 where the JAX package sums in f32).
- `predict_chunked` equals `predict_margin`; `cross_validate_chunked`'s
  fold RMSEs agree across chunkings (rtol 1e-12: the streamed sums run
  per chunk) and with the JAX package (rtol 1e-6).
- Estimators: `fit_chunked` of DT, RF and GBT equals `fit(df)`.
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.frame import _chunks as pc
from sml_tpu_torch.frame.sampling import row_uniforms
from sml_tpu_torch.ml import _chunked as pch
from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import tree_impl as pti
from sml_tpu_torch.utils.profiler import PROFILER

torch.set_num_threads(2)

CHUNKINGS = [64, 1000, None]


@pytest.fixture()
def confs(spark):
    """The JAX fits on the XLA path with histogram subtraction, as the
    port builds; both keys restored after each test."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    prev = {k: JCONF.get(k) for k in ("sml.tree.kernel",
                                      "sml.tree.histSubtraction")}
    JCONF.set("sml.tree.kernel", "xla")
    JCONF.set("sml.tree.histSubtraction", True)
    yield JCONF
    for k, v in prev.items():
        JCONF.set(k, v)


def _data(n=3000, f=6, seed=3, dyadic=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = X[:, 0] * 2 - X[:, 1] ** 2 + rng.normal(0, 0.2, n)
    if dyadic:
        y = np.round(y * 8) / 8
    return X, y


def _rows(source):
    parts = list(source.chunks())
    if not parts:
        return np.zeros((0, source.n_features)), np.zeros(0)
    return (np.concatenate([x for x, _ in parts]),
            np.concatenate([y for _, y in parts]))


def _trees_equal(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for fld in ("split_feature", "split_bin", "leaf_value", "gain",
                    "cover"):
            np.testing.assert_array_equal(getattr(ta, fld), getattr(tb, fld),
                                          err_msg=fld)
    assert a.base == b.base


# ------------------------------------------------ sources, splits, folds
def test_row_uniforms_match_jax_and_are_random_access():
    from sml_tpu.frame.sampling import row_uniforms as jrow
    for seed in (0, 9, 42, -3, 2 ** 40):
        np.testing.assert_array_equal(row_uniforms(seed, 17, 5000),
                                      jrow(seed, 17, 5000))
    a = row_uniforms(9, 0, 10_000)
    b = np.concatenate([row_uniforms(9, s, 1000)
                        for s in range(0, 10_000, 1000)])
    np.testing.assert_array_equal(a, b)
    assert 0.0 <= a.min() and a.max() < 1.0 and abs(a.mean() - 0.5) < 0.02


@pytest.mark.parametrize("chunk_rows", CHUNKINGS)
def test_splits_and_folds_keep_the_jax_rows(chunk_rows):
    """split_assignments, chunk_random_split (and a split of a split) and
    FoldChunkSource keep the JAX package's rows for this chunking, and the
    same rows as one chunk."""
    from sml_tpu.frame import _chunks as jc
    X, y = _data()
    np.testing.assert_array_equal(
        pc.split_assignments(42, 5, len(X), [0.7, 0.2, 0.1]),
        jc.split_assignments(42, 5, len(X), [0.7, 0.2, 0.1]))
    src = pc.ArrayChunkSource(X, y, chunk_rows=chunk_rows)
    jsrc = jc.ArrayChunkSource(X, y, chunk_rows=chunk_rows)
    cells = pc.split_assignments(42, 0, len(X), [0.7, 0.3])
    tr, te = pc.chunk_random_split(src, [0.7, 0.3], 42)
    jtr, jte = jc.chunk_random_split(jsrc, [0.7, 0.3], 42)
    for part, jpart, cell in ((tr, jtr, 0), (te, jte, 1)):
        got, want = _rows(part), _rows(jpart)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], X[cells == cell])
        assert part.n_rows == jpart.n_rows == (cells == cell).sum()
    sub, _ = pc.chunk_random_split(tr, [0.5, 0.5], 2)
    jsub, _ = jc.chunk_random_split(jtr, [0.5, 0.5], 2)
    whole, _ = pc.chunk_random_split(
        pc.chunk_random_split(pc.ArrayChunkSource(X, y), [0.7, 0.3], 42)[0],
        [0.5, 0.5], 2)
    np.testing.assert_array_equal(_rows(sub)[0], _rows(jsub)[0])
    np.testing.assert_array_equal(_rows(sub)[0], _rows(whole)[0])
    np.testing.assert_array_equal(_rows(src.sample(0.3, 7))[0],
                                  _rows(jsrc.sample(0.3, 7))[0])
    folds = pc.split_assignments(11, 0, len(X), [1.0] * 3)
    for j in range(3):
        for invert in (False, True):
            got = _rows(pc.FoldChunkSource(src, 11, 3, j, invert))[0]
            want = _rows(jc.FoldChunkSource(jsrc, 11, 3, j, invert))[0]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, X[(folds != j) if invert else (folds == j)])


def test_generator_source_and_fingerprints():
    calls = []

    def make(start, stop):
        calls.append((start, stop))
        r = np.random.default_rng(start)
        return r.normal(size=(stop - start, 3)), np.zeros(stop - start)

    src = pc.GeneratorChunkSource(1000, 3, make, chunk_rows=300,
                                  fingerprint=("gen", 1000))
    X, _ = _rows(src)
    assert X.shape == (1000, 3) and calls == [(0, 300), (300, 600),
                                              (600, 900), (900, 1000)]
    np.testing.assert_array_equal(_rows(src)[0], X)   # re-iterable
    tr, _ = src.randomSplit([0.5, 0.5], 3)
    assert tr.fingerprint() == ("filter", ("gen", 1000), 0.0, 0.5, 3)
    assert pc.FoldChunkSource(src, 1, 3, 0).fingerprint()[0] == "fold"
    anon = pc.GeneratorChunkSource(10, 3, make)
    assert anon.fingerprint() is None and anon.sample(0.5, 1) \
        .fingerprint() is None


# -------------------------------------------------------------- sketches
def _sketch_values(sk):
    v, w = sk.values_weights()
    return np.asarray(v), np.asarray(w)


@pytest.mark.parametrize("mode", ["exact", "compressed"])
def test_feature_sketch_matches_jax(mode):
    """Values, weights, quantiles and cdf equal the JAX package's, chunk by
    chunk and merged, and survive a to_dict / from_dict round trip; a
    compressed sketch's quantiles lie within one bin width of the exact."""
    from sml_tpu.frame import _chunks as jc
    rng = np.random.default_rng(5)
    vals = rng.normal(size=20_000)
    vals[::97] = np.nan
    kw = dict(buckets=256, exact_cap=4_000) if mode == "compressed" \
        else dict(buckets=256)
    probs = np.linspace(0, 1, 33)[1:-1]
    sk, jsk = pc.FeatureSketch(**kw), jc.FeatureSketch(**kw)
    parts, jparts = [], []
    for i in range(0, vals.size, 1000):
        sk.update(vals[i:i + 1000])
        jsk.update(vals[i:i + 1000])
        p, jp = pc.FeatureSketch(**kw), jc.FeatureSketch(**kw)
        p.update(vals[i:i + 1000])
        jp.update(vals[i:i + 1000])
        parts.append(p)
        jparts.append(jp)
    merged, jmerged = parts[0], jparts[0]
    for p, jp in zip(parts[1:], jparts[1:]):
        merged.merge(p)
        jmerged.merge(jp)
    xs = np.linspace(-3, 3, 41)
    for a, b in ((sk, jsk), (merged, jmerged)):
        assert a.exact == b.exact == (mode == "exact")
        assert (a.n_seen, a.compressions) == (b.n_seen, b.compressions)
        for x, z in zip(_sketch_values(a), _sketch_values(b)):
            np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(a.quantiles(probs), b.quantiles(probs))
        np.testing.assert_array_equal(a.cdf(xs), b.cdf(xs))
        back = pc.FeatureSketch.from_dict(a.to_dict())
        assert a.to_dict() == b.to_dict()
        np.testing.assert_array_equal(back.quantiles(probs),
                                      a.quantiles(probs))
        np.testing.assert_array_equal(back.cdf(xs), a.cdf(xs))
    exact = np.quantile(vals[np.isfinite(vals)], probs)
    if mode == "exact":
        np.testing.assert_array_equal(sk.quantiles(probs), exact)
    else:
        assert np.abs(sk.quantiles(probs) - exact).max() \
            < np.diff(exact).max()
    f32 = pc.FeatureSketch()
    f32.update(vals[:500].astype(np.float32))
    back = pc.FeatureSketch.from_dict(f32.to_dict())
    assert _sketch_values(back)[0].dtype == np.float32
    np.testing.assert_array_equal(back.quantiles(probs), f32.quantiles(probs))


@pytest.mark.parametrize("mode", ["exact", "compressed"])
def test_dataset_sketch_matches_jax(mode):
    """Per-feature sketches, streamed category sums, cat_means and the
    finalized binning equal the JAX package's; in exact mode the binning
    equals the port's make_bins; the to_dict round trip keeps it."""
    from sml_tpu.frame import _chunks as jc
    rng = np.random.default_rng(8)
    n = 6000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[:, 2] = rng.integers(0, 7, n)
    y = (X[:, 0] + 0.3 * X[:, 2] + rng.normal(0, 0.1, n)).astype(np.float32)
    kw = dict(buckets=128, exact_cap=2_500) if mode == "compressed" else {}
    cat = {2: 7}
    sk, jsk = pc.DatasetSketch(4, cat, **kw), jc.DatasetSketch(4, cat, **kw)
    for i in range(0, n, 700):
        part, jpart = pc.DatasetSketch(4, cat, **kw), \
            jc.DatasetSketch(4, cat, **kw)
        part.update(X[i:i + 700], y[i:i + 700])
        jpart.update(X[i:i + 700], y[i:i + 700])
        sk.merge(part)
        jsk.merge(jpart)
    assert sk.exact == jsk.exact == (mode == "exact") and sk.n_rows == n
    assert sk.to_dict() == jsk.to_dict()
    for with_labels in (True, False):
        a, b = sk.cat_means(with_labels), jsk.cat_means(with_labels)
        np.testing.assert_array_equal(a[2], b[2])
    binning, edge_list, dtype = sk.to_binning(20)
    jbinning, jedge_list, jdtype = jsk.to_binning(20)
    np.testing.assert_array_equal(binning.edges, jbinning.edges)
    np.testing.assert_array_equal(binning.cat_remap[2], jbinning.cat_remap[2])
    assert dtype == jdtype
    for e, je in zip(edge_list, jedge_list):
        np.testing.assert_array_equal(e, je)
    back = pc.DatasetSketch.from_dict(sk.to_dict()).to_binning(20)[0]
    np.testing.assert_array_equal(back.edges, binning.edges)
    if mode == "exact":
        _, mb = pti.make_bins(X, y, 20, cat)
        np.testing.assert_array_equal(binning.edges, mb.edges)
        np.testing.assert_array_equal(binning.cat_remap[2], mb.cat_remap[2])


# ---------------------------------------------------------------- ingest
@pytest.mark.parametrize("chunk_rows", CHUNKINGS)
def test_ingest_equals_make_bins_and_jax(spark, chunk_rows):
    from sml_tpu.frame import _chunks as jc
    from sml_tpu.ml import _chunked as jch
    X, y = _data()
    X[:, 5] = np.random.default_rng(1).integers(0, 4, len(X))
    cat = {5: 4}
    ing = pch.ingest_source(pc.ArrayChunkSource(X, y, chunk_rows), 32, cat,
                            device="cpu")
    jing = jch.ingest_source(jc.ArrayChunkSource(X, y, chunk_rows), 32, cat)
    binned, binning = pti.make_bins(X, np.asarray(y, np.float32), 32, cat)
    assert ing.stats["sketch_exact"] and ing.n_rows == len(X)
    for got in (binned, jing.binned):
        np.testing.assert_array_equal(ing.binned, got)
    for b in (binning, jing.binning):
        np.testing.assert_array_equal(ing.binning.edges, b.edges)
        np.testing.assert_array_equal(ing.binning.cat_remap[5],
                                      b.cat_remap[5])
    np.testing.assert_array_equal(ing.y, np.asarray(y, np.float32))
    np.testing.assert_array_equal(ing.y, jing.y)
    assert ing.stats["compact_bytes"] == ing.binned.nbytes
    assert ing.stats["chunk_stage_peak_bytes"] is None   # no card here
    unlabeled = pch.ingest_source(pc.ArrayChunkSource(X, None, chunk_rows),
                                  32, device="cpu")
    assert unlabeled.y is None


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_ingest_pipeline_overlaps_in_order(depth):
    """At prefetch depth d, chunks 0..d-1 dispatch before chunk 0 drains,
    every chunk drains in order, and the counters count each once."""
    X, y = _data(n=2000)
    PCONF.set("sml.data.prefetchChunks", depth)
    before = PROFILER.counters()
    try:
        ing = pch.ingest_source(pc.ArrayChunkSource(X, y, 256), 16,
                                device="cpu")
    finally:
        PCONF.unset("sml.data.prefetchChunks")
    order = ing.stats["order"]
    n_chunks = ing.stats["n_chunks"]
    assert n_chunks == 8 and ing.stats["prefetch_depth"] == depth
    first_drain = order.index(("drain", 0))
    assert [c for k, c in order[:first_drain] if k == "dispatch"] \
        == list(range(depth))
    assert [c for k, c in order if k == "drain"] == list(range(n_chunks))
    for i in range(n_chunks - 1):
        assert order.index(("dispatch", i + 1)) < order.index(("drain", i)) \
            or depth == 1
    after = PROFILER.counters()
    for name, inc in (("ingest.dispatch", 8), ("ingest.drain", 8),
                      ("ingest.chunks", 8), ("ingest.rows", 2000),
                      ("ingest.h2d_bytes", ing.binned.nbytes)):
        assert after.get(name, 0) - before.get(name, 0) == inc, name


def test_ingest_memo_and_bin_cache_reuse():
    """A second fit on the same source skips both passes (memo) and the
    fit stages nothing: the assembled matrix is in the bin cache."""
    X, y = _data(n=1500, seed=11)
    src = pc.ArrayChunkSource(X, y, chunk_rows=512)
    kw = dict(max_depth=3, max_bins=16, n_trees=2, bootstrap=True, seed=3,
              device="cpu")
    c0 = PROFILER.counters()
    pch.fit_ensemble_chunked(src, **kw)
    c1 = PROFILER.counters()
    pch.fit_ensemble_chunked(src, **kw)
    c2 = PROFILER.counters()
    assert c1.get("staging.bin_cache_miss", 0) \
        == c0.get("staging.bin_cache_miss", 0)
    assert c2.get("ingest.memo_hit", 0) == c1.get("ingest.memo_hit", 0) + 1
    assert c2.get("ingest.h2d_bytes", 0) == c1.get("ingest.h2d_bytes", 0)
    assert c2.get("staging.bin_cache_hit", 0) \
        > c1.get("staging.bin_cache_hit", 0)


def test_unlabeled_source_is_refused_for_a_fit():
    X, _ = _data(n=600)
    with pytest.raises(ValueError, match="labeled"):
        pch.fit_ensemble_chunked(pc.ArrayChunkSource(X, chunk_rows=500),
                                 max_depth=2, max_bins=8, device="cpu")


# ------------------------------------------------------------------ fits
CHUNKED_FITS = {
    "rf_bootstrap": dict(max_depth=4, max_bins=32, n_trees=4,
                         bootstrap=True, feature_k=3, seed=7),
    "gbt_subsample": dict(max_depth=3, max_bins=24, n_trees=4,
                          subsample=0.7, boosting=True, step_size=0.5,
                          seed=5),
    "xgb": dict(max_depth=4, max_bins=32, n_trees=4, boosting=True,
                step_size=0.3, reg_lambda=1.0, gamma=0.1, seed=42),
}


def _matrix_kw(kw):
    out = dict(categorical={}, min_instances=1, min_info_gain=0.0,
               feature_k=None, bootstrap=False, subsample=1.0,
               loss="squared")
    out.update(kw)
    return out


@pytest.mark.parametrize("kind", sorted(CHUNKED_FITS))
def test_chunked_fits_equal_the_matrix_fit(kind):
    X, y = _data(seed=4)
    kw = CHUNKED_FITS[kind]
    want = ptm._fit_ensemble(X, y, device="cpu", **_matrix_kw(kw))
    for chunk_rows in (257, None):
        got = pch.fit_ensemble_chunked(pc.ArrayChunkSource(X, y, chunk_rows),
                                       device="cpu", **kw)
        _trees_equal(got, want)


@pytest.mark.parametrize("kind", sorted(CHUNKED_FITS))
def test_chunked_fits_give_the_jax_split_tables(confs, kind):
    from sml_tpu.frame import _chunks as jc
    from sml_tpu.ml import _chunked as jch
    X, y = _data(seed=4, dyadic=True)
    kw = CHUNKED_FITS[kind]
    sp = pch.fit_ensemble_chunked(pc.ArrayChunkSource(X, y, 500),
                                  device="cpu", **kw)
    sj = jch.fit_ensemble_chunked(jc.ArrayChunkSource(X, y, 500), **kw)
    assert len(sp.trees) == len(sj.trees) == kw["n_trees"]
    for tj, tp in zip(sj.trees, sp.trees):
        np.testing.assert_array_equal(tp.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tp.split_bin, tj.split_bin)
        for fld in ("leaf_value", "gain", "cover"):
            want = getattr(tj, fld)
            np.testing.assert_allclose(getattr(tp, fld), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=fld)


@pytest.mark.parametrize("chunk_rows", CHUNKINGS)
def test_predict_chunked_equals_predict_margin(chunk_rows):
    X, y = _data(seed=2)
    spec = ptm._fit_ensemble(X, y, device="cpu", **_matrix_kw(
        CHUNKED_FITS["xgb"]))
    want = spec.predict_margin(X[:700], "cpu")
    got = pch.predict_chunked(spec, pc.ArrayChunkSource(X[:700],
                                                        chunk_rows=chunk_rows),
                              device="cpu")
    np.testing.assert_array_equal(got, want)


def test_cross_validate_chunked_across_chunkings_and_jax(confs):
    from sml_tpu.frame import _chunks as jc
    from sml_tpu.ml import _chunked as jch
    X, y = _data(seed=6, dyadic=True)
    kw = dict(max_depth=3, max_bins=16, n_trees=2, bootstrap=True, seed=5)
    cvs = [pch.cross_validate_chunked(pc.ArrayChunkSource(X, y, cr), 3, 11,
                                      device="cpu", **kw)
           for cr in (500, None)]
    np.testing.assert_allclose(cvs[0]["fold_rmse"], cvs[1]["fold_rmse"],
                               rtol=1e-12)
    jcv = jch.cross_validate_chunked(jc.ArrayChunkSource(X, y, 500), 3, 11,
                                     **kw)
    np.testing.assert_allclose(cvs[0]["fold_rmse"], jcv["fold_rmse"],
                               rtol=1e-6)
    assert cvs[0]["k"] == 3 and len(cvs[0]["fold_rmse"]) == 3


# ------------------------------------------------------------ estimators
@pytest.fixture()
def cpu_session():
    prev = PCONF.get("sml.device")
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.set("sml.device", prev)


@pytest.mark.parametrize("name", ["DecisionTreeRegressor",
                                  "RandomForestRegressor", "GBTRegressor",
                                  "GBTClassifier"])
def test_estimator_fit_chunked_equals_fit(cpu_session, name):
    from sml_tpu_torch import get_session
    from sml_tpu_torch.ml.feature import VectorAssembler
    X, y = _data(n=2000, seed=9)
    X = X.astype(np.float32)
    if name.endswith("Classifier"):
        y = (y > np.median(y)).astype(np.float64)
    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    cols["label"] = y
    df = VectorAssembler(inputCols=[f"f{i}" for i in range(X.shape[1])],
                         outputCol="features").transform(
        get_session().createDataFrame(cols))
    params = dict(maxDepth=3, maxBins=16, seed=9)
    if name.startswith("Random"):
        params["numTrees"] = 3
    if name.startswith("GBT"):
        params.update(maxIter=3, subsamplingRate=0.8)
    est = getattr(ptm, name)(**params)
    m_frame = est.fit(df)
    m_chunk = est.fit_chunked(pc.ArrayChunkSource(X, y, chunk_rows=700),
                              device="cpu")
    assert type(m_frame) is type(m_chunk)
    _trees_equal(m_frame._spec, m_chunk._spec)
    assert m_chunk.getOrDefault("maxDepth") == 3


def test_xgboost_fit_chunked_raises_as_in_jax():
    from sml_tpu.frame import _chunks as jc
    from sml_tpu.xgboost import XgboostRegressor as JX
    from sml_tpu_torch.xgboost import XgboostRegressor
    X, y = _data(n=200)
    with pytest.raises(AttributeError, match="maxDepth") as got:
        XgboostRegressor().fit_chunked(pc.ArrayChunkSource(X, y),
                                       device="cpu")
    with pytest.raises(AttributeError, match="maxDepth") as want:
        JX().fit_chunked(jc.ArrayChunkSource(X, y))
    assert str(got.value) == str(want.value)
