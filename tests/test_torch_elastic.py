"""Per-rank chunk ingest, warm start over ranks and elastic resume, on the
CPU.

- `ChunkSource.host_view` gives the JAX package's row ranges and rows on
  `tests/test_hierarchical.py:397-430`'s cases, and `moved_rows` its
  counts (`:515-522`).
- Each rank count (2 and 4) is one launch of gloo ranks (subprocesses,
  each with its own timeout; `initialize_multihost` on a `file://`
  store, `device="cpu"`), both launched at once by a module-scoped
  fixture. On a chunked XGBoost (`subsample` 0.8) each rank's ingest
  reads only its `host_view`, and the fresh fit, and a 2-round fit
  warm-started by 4 more (`warm_start_ensemble_chunked`), give the
  one-rank 6-round model bit for bit on every rank.
- On 4 ranks in 4 host groups, `elastic_fit` (`:432-513`'s fit: 960 x
  6, 6 rounds of depth 3, 2 rounds a segment) killed after its first
  checkpoint resumes on the 3 surviving ranks and gives the
  uninterrupted model bit for bit, with `elastic.resume` and
  `elastic.repartition` counted once and the checkpoint directory
  cleared; the dead rank raises `HostPreempted`. A preemption that
  only one rank's hook sees (a rank of another group) reaches every rank
  through the boundary flag. With `sml.ct.elasticResume` off, or a
  restart budget of 0, the preemption raises on every rank.
- The one-rank elastic reference agrees with the JAX package's
  `checkpointed_fit` within 1e-4, and a checkpoint whose writer raises a
  ValueError raises on every rank of 2 and 4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240
FIELDS = ("split_feature", "split_bin", "leaf_value", "gain", "cover")
#: the chunked XGBoost of the warm-start checks
XGB = dict(max_depth=3, max_bins=32, seed=7, step_size=0.3, subsample=0.8)
#: the elastic fit of `tests/test_hierarchical.py:432-474`
ELASTIC = dict(n_trees=6, max_depth=3, max_bins=32, seed=7, step_size=0.3,
               rounds_per_dispatch=2)


def _data(n: int = 960, seed: int = 11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X @ rng.normal(size=6) + 0.1 * rng.normal(size=n)) \
        .astype(np.float32)
    return X, y


def _source(chunk_rows: int = 128):
    from sml_tpu_torch.frame._chunks import ArrayChunkSource
    return ArrayChunkSource(*_data(), chunk_rows=chunk_rows)


def _trees(spec) -> dict:
    out = {f: np.stack([getattr(t, f) for t in spec.trees]) for f in FIELDS}
    out["base"] = np.asarray([spec.base], np.float32)
    return out


def _xgb(n_trees: int):
    from sml_tpu_torch.ml._chunked import fit_ensemble_chunked
    return fit_ensemble_chunked(_source(), n_trees=n_trees, boosting=True,
                                device="cpu", **XGB)


def _warm(spec, n_new: int):
    from sml_tpu_torch.ml._chunked import warm_start_ensemble_chunked
    return warm_start_ensemble_chunked(
        spec, _source(), n_new_trees=n_new, seed=XGB["seed"],
        subsample=XGB["subsample"], device="cpu")


WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import test_torch_elastic as T
from sml_tpu_torch import GLOBAL_CONF, obs
from sml_tpu_torch.ct import BoostCheckpoint, HostPreempted, elastic_fit
from sml_tpu_torch.ml._chunked import ingest_source
from sml_tpu_torch.parallel import collectives as coll

rank, store, out, n, tmp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            int(sys.argv[4]), sys.argv[5])
assert coll.initialize_multihost("file://" + store, n, rank,
                                 backend="gloo", device="cpu",
                                 timeout_s=120)
GLOBAL_CONF.set("sml.device", "cpu")
res = {{}}


class Refused:
    def save(self, path):
        raise ValueError("spec refused")


try:    # the writer (rank 0) raises a ValueError
    BoostCheckpoint(os.path.join(tmp, "refused")).save(Refused(), 1, {{}})
    res["refused"] = np.asarray(["none"])
except (ValueError, OSError) as e:
    res["refused"] = np.asarray([type(e).__name__])
ing = ingest_source(T._source(), 32, device="cpu")
res["block"] = np.asarray(ing.block)
res["ingested"] = np.asarray([ing.binned.shape[0], ing.stats["n_chunks"]])
for k, v in T._trees(T._xgb(6)).items():
    res["fresh_" + k] = v
for k, v in T._trees(T._warm(T._xgb(2), 4)).items():
    res["warm_" + k] = v
if n == 4:
    GLOBAL_CONF.set("sml.obs.enabled", True)

    def run(tag, chaos=None):
        obs.reset()
        d = os.path.join(tmp, tag)
        try:
            spec = elastic_fit(T._source(), d, hosts=4, on_checkpoint=chaos,
                               device="cpu", **T.ELASTIC)
            for k, v in T._trees(spec).items():
                res[tag + "_" + k] = v
            res[tag + "_outcome"] = np.asarray(["model"])
        except HostPreempted as e:
            res[tag + "_outcome"] = np.asarray([f"preempted {{e.group}}"])
        c = obs.RECORDER.counters()
        res[tag + "_counts"] = np.asarray(
            [c.get("elastic.resume", 0), c.get("elastic.repartition", 0)])
        res[tag + "_left"] = np.asarray([os.path.exists(d)])

    def kill_on(ranks):
        fired = []

        def chaos(t_done):
            if rank in ranks and not fired and t_done >= 2:
                fired.append(t_done)
                raise HostPreempted(group=1)
        return chaos

    run("ref")
    run("every", kill_on((0, 1, 2, 3)))
    run("one", kill_on((3,)))

    def always_die(t_done):
        raise HostPreempted(group=0)
    GLOBAL_CONF.set("sml.ct.elasticResume", "false")
    run("gate_off", always_die)
    GLOBAL_CONF.unset("sml.ct.elasticResume")
    GLOBAL_CONF.set("sml.ct.elasticMaxRestarts", 0)
    run("budget", always_die)
    GLOBAL_CONF.unset("sml.ct.elasticMaxRestarts")
np.savez(out, **res)
print("rank", rank, "ok")
"""


def _start(tmp, n: int):
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    script = WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    outs = [str(tmp / f"rank{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(tmp / "store"), outs[r],
         str(n), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return procs, outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank count's ranks' results: {n: [rank 0's, rank 1's, ...]};
    the two launches run at once, each rank under its own timeout."""
    launches, logs = {}, {}
    try:
        for n in (2, 4):
            launches[n] = _start(tmp_path_factory.mktemp(f"elastic{n}"), n)
        for n, (procs, _) in launches.items():
            logs[n] = [p.communicate(timeout=RANK_TIMEOUT)[0]
                       for p in procs]
    finally:
        for procs, _ in launches.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for n, (procs, outs) in launches.items():
        for r, (p, log) in enumerate(zip(procs, logs[n])):
            assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
    return {n: [dict(np.load(o)) for o in outs]
            for n, (_, outs) in launches.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The one-rank models, on the CPU outside any mesh, and the elastic
    one's margins on the fit's rows."""
    from sml_tpu_torch.ct import checkpointed_fit
    spec = checkpointed_fit(_source(), str(tmp_path_factory.mktemp("ck") /
                                           "ref"), device="cpu", **ELASTIC)
    return {"xgb": _trees(_xgb(6)), "elastic": _trees(spec),
            "elastic_margin": spec.predict_margin(_data()[0], device="cpu")}


def _same(got: dict, prefix: str, want: dict, what: str) -> None:
    for k, v in want.items():
        np.testing.assert_array_equal(got[f"{prefix}_{k}"], v,
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("chunk_rows", [7, 33, 100])
def test_host_view_is_the_jax_host_view(chunk_rows):
    from sml_tpu.frame._chunks import ArrayChunkSource as JSource
    from sml_tpu_torch.frame._chunks import ArrayChunkSource as PSource
    rng = np.random.default_rng(7)
    X = rng.normal(size=(100, 4)).astype(np.float32)
    y = rng.normal(size=100).astype(np.float32)
    for hosts in (1, 3, 4):
        for g in range(hosts):
            jv = JSource(X, y, chunk_rows=chunk_rows).host_view(g, hosts)
            pv = PSource(X, y, chunk_rows=chunk_rows).host_view(g, hosts)
            assert (pv.start, pv.stop, pv.n_rows) == \
                (jv.start, jv.stop, jv.n_rows)
            jc, pc = list(jv.chunks()), list(pv.chunks())
            assert [c[0].shape for c in pc] == [c[0].shape for c in jc]
            for (xa, ya), (xb, yb) in zip(pc, jc):
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)
            assert pv.fingerprint()[0] == "host"
            assert pv.fingerprint()[2:] == jv.fingerprint()[2:]


def test_host_view_refuses_an_uncounted_source_and_a_bad_group():
    from sml_tpu_torch.frame._chunks import ArrayChunkSource
    X = np.zeros((100, 4), np.float32)
    src = ArrayChunkSource(X, X[:, 0], chunk_rows=10)
    src.n_rows = None
    with pytest.raises(ValueError, match="counted"):
        src.host_view(0, 2)
    with pytest.raises(ValueError):
        ArrayChunkSource(X, X[:, 0], chunk_rows=10).host_view(5, 3)


@pytest.mark.parametrize("n,old,new", [(960, 4, 3), (100, 2, 2), (0, 4, 2),
                                       (1000, 3, 2), (7, 4, 1)])
def test_moved_rows_is_the_jax_count(n, old, new):
    from sml_tpu.ct._elastic import moved_rows as jmoved
    from sml_tpu_torch.ct._elastic import moved_rows
    assert moved_rows(n, old, new) == jmoved(n, old, new)


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_ingests_only_its_host_view(runs, n):
    from sml_tpu_torch.parallel.mesh import host_partition
    for rank, res in enumerate(runs[n]):
        start, stop = host_partition(960, n)[rank]
        assert res["block"].tolist() == [start, 960]
        assert int(res["ingested"][0]) == stop - start


@pytest.mark.parametrize("kind", ["fresh", "warm"])
@pytest.mark.parametrize("n", [2, 4])
def test_chunked_fits_over_ranks_are_the_one_rank_model(runs, reference, n,
                                                        kind):
    for rank, res in enumerate(runs[n]):
        _same(res, kind, reference["xgb"], f"{kind}, rank {rank} of {n}")


def test_the_one_rank_reference_is_the_jax_checkpointed_fit(spark, reference,
                                                           tmp_path):
    """The one-rank fit every layout is held to, against the JAX
    package's `checkpointed_fit` on the same source, within
    `tests/test_hierarchical.py:469`'s tolerance."""
    from sml_tpu.ct import checkpointed_fit as jcheckpointed_fit
    from sml_tpu.frame._chunks import ArrayChunkSource as JSource
    X, y = _data()
    jspec = jcheckpointed_fit(JSource(X, y, chunk_rows=128),
                              str(tmp_path / "ck"), **ELASTIC)
    np.testing.assert_allclose(reference["elastic_margin"],
                               jspec.predict_margin(X), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_a_failed_checkpoint_write_raises_on_every_rank(runs, n):
    """A writer that raises other than OSError still joins the failure
    flag's all-reduce: it raises its own error and every other rank an
    OSError, with no rank left waiting."""
    got = [str(res["refused"][0]) for res in runs[n]]
    assert got == ["ValueError"] + ["OSError"] * (n - 1)


def test_the_uninterrupted_elastic_fit_is_the_one_rank_fit(runs, reference):
    for res in runs[4]:
        _same(res, "ref", reference["elastic"], "uninterrupted")
        assert res["ref_counts"].tolist() == [0, 0]
        assert not res["ref_left"][0]


@pytest.mark.parametrize("tag", ["every", "one"])
def test_a_killed_group_resumes_on_the_survivors_bit_for_bit(runs, reference,
                                                             tag):
    for rank, res in enumerate(runs[4]):
        if rank == 1:    # the dead group's rank returns no model
            assert str(res[f"{tag}_outcome"][0]) == "preempted 1"
            continue
        assert str(res[f"{tag}_outcome"][0]) == "model"
        _same(res, tag, reference["elastic"], f"{tag}, rank {rank}")
        assert res[f"{tag}_counts"].tolist() == [1, 1]
        assert not res[f"{tag}_left"][0]


@pytest.mark.parametrize("tag", ["gate_off", "budget"])
def test_gate_off_and_an_exhausted_budget_raise_on_every_rank(runs, tag):
    for res in runs[4]:
        assert str(res[f"{tag}_outcome"][0]) == "preempted 0"
        assert res[f"{tag}_counts"].tolist() == [0, 0]
