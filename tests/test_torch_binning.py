"""The port's host binning (`sml_tpu_torch.native.binning`, the C++
kernel of `csrc/binning.cc`) against its NumPy version
(`tree_impl._bin_columns_plain`) and against the JAX package's live
`_bin_columns` and `bin_with`, on the CPU. Bins are integers: every case
is held exactly. Inputs come from numpy with a seed: NaN and +-inf,
values on the edges, categorical slots (remapped, ids past the known
categories clipped), f32 and f64 matrices, uint8, uint16 and int32 bin
matrices. A build that fails raises (the port has no NumPy fallback), and
builds that race write whole libraries.
"""

import os
import threading

import numpy as np
import pytest

from sml_tpu_torch.ml import tree_impl as pti
from sml_tpu_torch.native import binning, build


def _matrix(rng, n, F, dtype):
    X = rng.normal(size=(n, F))
    X[rng.random((n, F)) < 0.03] = np.nan
    X[rng.random((n, F)) < 0.01] = np.inf
    X[rng.random((n, F)) < 0.01] = -np.inf
    X[:, 1] = rng.integers(0, 7, n)          # categorical, 5 known + 2 past
    X[:, 3] = rng.integers(0, 4, n) * 0.5    # few values: many on an edge
    return X.astype(dtype)


CATS = {1: 5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("max_bins", [16, 300, 70_000])  # uint8/16, int32
def test_bin_columns_match_plain_and_jax(dtype, max_bins):
    from sml_tpu.ml import tree_impl as jti
    rng = np.random.default_rng([max_bins, np.dtype(dtype).itemsize])
    X = _matrix(rng, 2_000, 6, dtype)
    y = rng.normal(size=X.shape[0])
    _, binning = jti.make_bins(X, y, max_bins, CATS)
    edge_list, out_dtype = pti.binning_edges_and_dtype(
        pti.Binning(binning.edges, binning.cat_remap))
    assert out_dtype == {16: np.uint8, 300: np.uint16,
                         70_000: np.int32}[max_bins]
    got = pti._bin_columns(X, edge_list, binning.cat_remap, out_dtype)
    plain = pti._bin_columns_plain(X, edge_list, binning.cat_remap,
                                   out_dtype)
    want = jti._bin_columns(X, edge_list, binning.cat_remap, out_dtype)
    assert got.dtype == plain.dtype == want.dtype == out_dtype
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert (got[~np.isfinite(X[:, 0]), 0] == 0).all()
    assert got[:, 0].max() > 0
    # ids past the known categories clip to the last one's rank
    rank = binning.cat_remap[1]
    np.testing.assert_array_equal(
        got[:, 1], rank[np.clip(X[:, 1].astype(np.int64), 0, 4)])


@pytest.mark.parametrize("max_bins", [16, 300])
def test_make_bins_and_bin_with_match_jax(max_bins):
    from sml_tpu.ml import tree_impl as jti
    rng = np.random.default_rng(max_bins)
    X = _matrix(rng, 3_000, 6, np.float64)
    y = rng.normal(size=X.shape[0]).astype(np.float32)
    bj, binning_j = jti.make_bins(X, y, max_bins, CATS)
    bp, binning_p = pti.make_bins(X, y, max_bins, CATS)
    np.testing.assert_array_equal(bp, bj)
    np.testing.assert_array_equal(binning_p.edges, binning_j.edges)
    fresh = _matrix(rng, 1_000, 6, np.float64)
    np.testing.assert_array_equal(pti.bin_with(fresh, binning_p),
                                  jti.bin_with(fresh, binning_j))


def test_values_on_and_between_edges():
    """searchsorted 'left': a value on an edge counts the edges below it
    only; a value above every edge gets the edge count."""
    edges = [np.asarray([-1.0, 0.0, 0.5, 2.0], np.float32)]
    X = np.asarray([[-5.0], [-1.0], [-0.999], [0.0], [0.5], [0.75], [2.0],
                    [2.5], [np.nan], [np.inf], [-np.inf]])
    want = [0, 0, 1, 1, 2, 3, 3, 4, 0, 0, 0]
    for dtype in (np.float64, np.float32):
        got = binning.bin_continuous(X.astype(dtype), edges, {})
        assert got.dtype == np.int32
        assert got[:, 0].tolist() == want
        np.testing.assert_array_equal(
            got, pti._bin_columns_plain(X.astype(dtype), edges, {}))


def test_empty_shapes_and_edgeless_features():
    assert binning.bin_continuous(np.zeros((0, 3)), [np.zeros(2)] * 3,
                                  {}).shape == (0, 3)
    X = np.random.default_rng(0).normal(size=(50, 2))
    none = [np.zeros(0, np.float32)] * 2
    assert (binning.bin_continuous(X, none, {}) == 0).all()
    one = [np.zeros(0, np.float32), np.asarray([0.0], np.float32)]
    np.testing.assert_array_equal(binning.bin_continuous(X, one, {}),
                                  pti._bin_columns_plain(X, one, {}))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No g++: the port raises where the JAX package falls back."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(binning, "_fns", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ not found"):
        pti._bin_columns(np.zeros((4, 2)), [np.zeros(1, np.float32)] * 2, {})


def test_a_refused_source_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ failed"):
        build.load("broken")
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


def test_racing_builds_each_load_a_whole_library(tmp_path, monkeypatch):
    """Builders that race (threads here; the test workers are processes)
    write under their own temporary names and rename into place."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    path = build._lib_path("binning")
    errors = []

    def run():
        try:
            build._compile("binning", path)
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    monkeypatch.setattr(build, "_libs", {})
    assert build.load("binning").sml_bin_matrix is not None
