"""The port's server: `MicroBatcher` over `DeviceScorer.score_block`, and
the `ModelCache` of warm scorers, on the CPU (modelled on the JAX
package's tests/test_serving.py).

Concurrent requests coalesce into few batches whose results equal
unbatched scoring exactly (each row's traversal is independent of its
batch mates); a lone request is served at its flush deadline; an
over-capacity burst with no host scorer sheds without deadlock, and the
dispatcher's queue (`DEVICE_QUEUE`) is empty again after it; stale
requests shed at flush; the model cache evicts by bytes.
"""

import threading
import time
import types

import numpy as np
import pytest

from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.parallel.dispatch import DEVICE_QUEUE
from sml_tpu_torch.serving import (MicroBatcher, ModelCache, RequestShed,
                                   RequestTimeout)
from sml_tpu_torch.utils.profiler import PROFILER


def _counter(name):
    return PROFILER.counters().get(name, 0.0)


@pytest.fixture(scope="module")
def scorers(spark):
    """Two port scorers over JAX-package fits carried across."""
    from sml_tpu.ml._tree_models import _fit_ensemble
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 3))
    out = []
    for seed, slope in ((1, 2.0), (2, -3.0)):
        y = (slope * X[:, 0] - X[:, 1] + rng.normal(0, 0.1, 1500)
             ).astype(np.float32)
        spec = _fit_ensemble(X, y, categorical={}, max_depth=3,
                             max_bins=32, min_instances=1, min_info_gain=0.0,
                             n_trees=4, feature_k=2, bootstrap=True,
                             subsample=1.0, seed=seed, loss="squared")
        d = tmp_save(spec)
        out.append(DeviceScorer(
            types.SimpleNamespace(_spec=ptm.spec_from_arrays(d)),
            device="cpu"))
    return out


def tmp_save(spec):
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as path:
        spec.save(path)
        with np.load(os.path.join(path, "data.npz")) as z:
            return {k: z[k] for k in z.files}


def _rows(n, seed=7):
    return np.random.default_rng(seed).normal(size=(n, 3))


def test_concurrent_requests_coalesce_and_match_unbatched(scorers):
    scorer = scorers[0]
    n, max_rows = 48, 16
    X = _rows(n)
    rows = [X[i][None, :] for i in range(n)]
    expected = scorer.score_block(X)
    b = MicroBatcher(scorer.score_block, max_batch_rows=max_rows,
                     flush_micros=5000, start=False)
    futs = [None] * n
    barrier = threading.Barrier(8)

    def client(lo):
        barrier.wait()
        for i in range(lo, n, 8):
            futs[i] = b.submit(rows[i])

    threads = [threading.Thread(target=client, args=(lo,))
               for lo in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    batches0 = _counter("serve.batches")
    b.start()
    got = np.concatenate([futs[i].result(30) for i in range(n)])
    b.close()
    assert _counter("serve.batches") - batches0 <= int(np.ceil(n / max_rows))
    np.testing.assert_array_equal(got, expected)


def test_mixed_sizes_and_widths_split_back_per_request(scorers):
    scorer = scorers[1]
    blocks = [_rows(r, seed=r) for r in (3, 5, 7, 1)]
    b = MicroBatcher(scorer.score_block, max_batch_rows=64,
                     flush_micros=5000, start=False)
    futs = [b.submit(blk) for blk in blocks]
    odd = b.submit(np.zeros((2, 4)))  # another width: its own batch
    b.start()
    outs = [f.result(30) for f in futs]
    with pytest.raises(ValueError):
        odd.result(30)  # a 4-feature row does not fit a 3-feature model
    b.close()
    for blk, out in zip(blocks, outs):
        np.testing.assert_array_equal(out, scorer.score_block(blk))


def test_deadline_flush_serves_a_lone_request(scorers):
    scorer = scorers[0]
    X = _rows(1)
    with MicroBatcher(scorer.score_block, max_batch_rows=4096,
                      flush_micros=10_000) as b:
        batches0 = _counter("serve.batches")
        t0 = time.perf_counter()
        out = b.submit(X).result(30)
        waited = time.perf_counter() - t0
        assert _counter("serve.batches") == batches0 + 1
    assert waited >= 0.009  # held for its flush window, then served
    np.testing.assert_array_equal(out, scorer.score_block(X))


def test_over_capacity_burst_sheds_without_deadlock(scorers):
    scorer = scorers[0]
    X = _rows(1)
    shed0 = _counter("serve.shed")
    over0 = _counter("serve.shed.overflow")
    # no host scorer: the overflow sheds whatever sml.serve.hostFallback
    # says; the bound reads the dispatcher's queue, empty between tests
    assert DEVICE_QUEUE.rows() == 0
    b = MicroBatcher(scorer.score_block, max_batch_rows=16, queue_rows=8,
                     start=False)
    futs = [b.submit(X) for _ in range(20)]
    # overflow futures are resolved with RequestShed at once: no worker
    # is needed and nothing blocks
    shed = [f for f in futs if f.done()]
    assert len(shed) == 12 and _counter("serve.shed") - shed0 == 12
    assert _counter("serve.shed.overflow") - over0 == 12
    for f in shed:
        with pytest.raises(RequestShed):
            f.result(1)
    b.start()
    for f in futs:
        if f not in shed:
            np.testing.assert_array_equal(f.result(30),
                                          scorer.score_block(X))
    b.close()
    assert b.queued_rows() == 0 and DEVICE_QUEUE.rows() == 0


def test_deadline_shed_of_stale_requests(scorers):
    scorer = scorers[0]
    b = MicroBatcher(scorer.score_block, max_batch_rows=16,
                     timeout_millis=30, flush_micros=1000, start=False)
    futs = [b.submit(_rows(1)) for _ in range(4)]
    time.sleep(0.1)  # everything queued is now past its deadline
    expired0 = _counter("serve.expired")
    b.start()
    for f in futs:
        with pytest.raises(RequestShed):
            f.result(30)
    b.close()
    assert _counter("serve.expired") - expired0 == 4
    assert b.queued_rows() == 0 and DEVICE_QUEUE.rows() == 0


def test_bounded_wait_times_out_and_future_stays_resolvable(scorers):
    scorer = scorers[0]
    b = MicroBatcher(scorer.score_block, flush_micros=0, start=False)
    fut = b.submit(_rows(2))
    with pytest.raises(RequestTimeout):
        fut.result(0.01)
    b.start()
    np.testing.assert_array_equal(fut.result(30), scorer.score_block(_rows(2)))
    b.close()


def test_closed_batcher_sheds_new_requests(scorers):
    b = MicroBatcher(scorers[0].score_block)
    b.close()
    closed0 = _counter("serve.shed.closed")
    with pytest.raises(RequestShed, match="closed"):
        b.submit(_rows(1)).result(1)
    assert _counter("serve.shed.closed") == closed0 + 1


def test_model_cache_lru_byte_eviction(scorers):
    s1, s2 = scorers
    cache = ModelCache(max_bytes=2 * s1.resident_bytes() + 8)
    assert cache.get("m", 1, lambda: s1) is s1
    hits0 = _counter("serve.model_cache_hit")
    assert cache.get("m", 1, lambda: pytest.fail("reloaded")) is s1
    assert _counter("serve.model_cache_hit") == hits0 + 1
    cache.get("m", 2, lambda: s2)
    assert cache.stats()["entries"] == 2
    cache.get("m", 1, lambda: s1)       # touch v1: v2 is now eldest
    third = DeviceScorer(types.SimpleNamespace(_spec=s1._spec), device="cpu")
    cache.get("other", 1, lambda: third)  # over budget: evicts v2
    assert cache.stats()["entries"] == 2
    assert cache.get("m", 1, lambda: pytest.fail("evicted")) is s1
    reloaded = []
    cache.get("m", 2, lambda: reloaded.append(1) or s2)
    assert reloaded == [1]
    cache.invalidate("m")
    assert all(k[0] != "m" for k in cache._entries)
    assert cache.stats()["bytes"] == sum(c for _, c in cache._entries.values())
