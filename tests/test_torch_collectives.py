"""The port's mesh of ranks and its collectives against the JAX package's,
on the CPU.

The port's side runs in gloo ranks, each a subprocess with its own
timeout (`_launch`), brought up through `initialize_multihost` on a
`file://` store in `tmp_path` (no port to race for under xdist's
workers). One launch of 4 ranks (a module-scoped fixture) runs every
case and writes each rank's results to an .npz that the tests read. The
JAX side runs the same numpy inputs through the JAX wrappers inside
`shard_map` on a 4-device `build_mesh(4)` of the 8-device CPU mesh,
rank r of the port holding the rows device r holds.

- Every collective of the table (`psum`, `psum_scalars`, `pmean`,
  `pmax`, `pmin`, `all_gather` tiled and stacked, `reduce_scatter`,
  `all_to_all` on one axis and across two, `ppermute` with a rank that
  receives nothing, `axis_index`, `masked_count`) equals the JAX
  wrapper's output, in f32 and (under `jax.enable_x64()`) f64. The
  payloads are integer-valued, so every sum is exact in any order and
  the comparison is bit for bit; a real-valued psum agrees within 1 ulp
  of the largest value (the order of 4 float adds).
- `psum_hierarchical` at 1, 2 and 4 host groups equals the flat psum and
  the JAX package's two-level psum bit for bit, pads a payload that does
  not divide the group, and counts the full payload on the "ici" hop and
  payload / group size on the "dcn" hop (as `tests/test_hierarchical.py`
  does for the JAX package).
- `host_partition`, `row_range`, the host-group shapes and
  `host_group_of` (explicit groups and `sml.mesh.hostGroups`) equal the
  JAX package's.
- `initialize_multihost` takes its single-process fast path without
  touching `init_process_group`, and wraps a failed bring-up in a typed
  `MultihostInitError` carrying the peer config; a two-process psum over
  a real gloo group gives 1 + 2.
"""

import os
import subprocess
import sys
from datetime import timedelta

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from sml_tpu.conf import GLOBAL_CONF as JCONF
from sml_tpu.parallel import collectives as jcoll
from sml_tpu.parallel import mesh as jmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a launch of ranks may take before the test fails
RANK_TIMEOUT = 240

RANKS = 4
BLOCK = (8, 7)          # one rank's (rows, columns) of the payloads

#: the inputs, made from a seed: integer-valued, so every sum is exact
_RNG = np.random.default_rng(3)
PAYLOAD = _RNG.integers(-50, 50, size=(RANKS * BLOCK[0], BLOCK[1]))
SQUARE = _RNG.integers(-50, 50, size=(RANKS * 8, 8))
REAL = _RNG.normal(size=(RANKS * BLOCK[0], BLOCK[1]))
MASK = (_RNG.random(RANKS * BLOCK[0]) > 0.3).astype(np.float32)
ODD = _RNG.integers(0, 50, size=(RANKS, 3, 5))
PERM = [(0, 1), (1, 2), (2, 3)]     # rank 0 receives nothing


WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from sml_tpu_torch import GLOBAL_CONF
from sml_tpu_torch.parallel import collectives as coll, mesh as M

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert coll.initialize_multihost("file://" + store, {ranks}, rank,
                                 backend="gloo", device="cpu",
                                 timeout_s=120)
mesh = M.get_mesh()
r = mesh.rank
res = {{}}
inputs = dict(np.load(sys.argv[4]))

def block(a):
    return torch.from_numpy(np.ascontiguousarray(M.shard_rows(a)))

for dt in ("float32", "float64"):
    x = block(inputs["payload"].astype(dt))
    sq = block(inputs["square"].astype(dt))
    res[dt + "_psum"] = coll.psum(x).numpy()
    res[dt + "_pmean"] = coll.pmean(x).numpy()
    res[dt + "_pmax"] = coll.pmax(x).numpy()
    res[dt + "_pmin"] = coll.pmin(x).numpy()
    res[dt + "_gather"] = coll.all_gather(x).numpy()
    res[dt + "_gather_tiled"] = coll.all_gather(x, tiled=True).numpy()
    res[dt + "_scatter"] = coll.reduce_scatter(x).numpy()
    res[dt + "_a2a"] = coll.all_to_all(x).numpy()
    res[dt + "_a2a_cols"] = coll.all_to_all(sq, split_axis=1,
                                            concat_axis=0).numpy()
    res[dt + "_ppermute"] = coll.ppermute(x, {perm!r}).numpy()
    s = coll.psum_scalars(x.sum(), x.max(), x[0, 0])
    res[dt + "_scalars"] = torch.stack(s).numpy()
res["real"] = coll.psum(block(inputs["real"].astype("float32"))).numpy()
res["axis_index"] = np.asarray([coll.axis_index()])
res["masked_count"] = coll.masked_count(block(inputs["mask"])).numpy()
res["row_range"] = np.asarray(M.row_range(len(inputs["payload"])))

x = block(inputs["payload"].astype("float32"))
for h in (1, 2, 4):
    hm = M.host_mesh(h)
    coll.reset_counts()
    res[f"hier{{h}}"] = coll.psum_hierarchical(x, mesh=hm).numpy()
    res[f"hier{{h}}_counts"] = np.asarray(
        [coll.COUNTS.get(k, -1.0) for k in (
            "collective.psum_bytes.ici", "collective.psum_bytes.dcn",
            "collective.all_gather_bytes.ici", "collective.psum.ici",
            "collective.psum.dcn")])
    res[f"hier{{h}}_flat"] = coll.psum(x, ("dcn", "ici"), mesh=hm).numpy()
    res[f"hier{{h}}_shape"] = np.asarray([hm.shape["dcn"], hm.shape["ici"]])
    res[f"hier{{h}}_groups"] = np.asarray(
        [M.host_group_of(hm)[g] for g in hm.ranks])
    res[f"hier{{h}}_index"] = np.asarray([coll.axis_index("ici", hm),
                                         coll.axis_index("dcn", hm),
                                         coll.axis_index(("dcn", "ici"),
                                                         hm)])
res["odd"] = coll.psum_hierarchical(
    torch.from_numpy(inputs["odd"][r].astype("float32")),
    mesh=M.host_mesh(2)).numpy()
GLOBAL_CONF.set("sml.mesh.hostGroups", 2)
res["conf_shape"] = np.asarray([M.host_mesh().shape["dcn"],
                                M.host_mesh().shape["ici"]])
try:
    M.host_mesh(3)
    res["three_groups_raise"] = np.asarray([0])
except ValueError:
    res["three_groups_raise"] = np.asarray([1])
np.savez(out, **res)
print("rank", r, "ok")
"""


def _launch(tmp_path, script: str, n: int, *args) -> list:
    """Run `script` as `n` ranks (argv: rank, store, output path, args),
    each with its own timeout; returns each rank's output path."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), store, outs[r]]
        + [str(a) for a in args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, payload=PAYLOAD, square=SQUARE, real=REAL, mask=MASK,
             odd=ODD)
    script = WORKER.format(repo=REPO, ranks=RANKS, perm=PERM)
    outs = _launch(tmp, script, RANKS, inputs)
    return [dict(np.load(o)) for o in outs]


def _jax(fn, x, out_spec, mesh=None):
    """`fn` over the rows of `x` split across a 4-device mesh."""
    mesh = mesh or jmesh.build_mesh(RANKS)
    f = jmesh.shard_map_compat(fn, mesh=mesh,
                               in_specs=(P(jmesh.row_spec_entry(mesh)),),
                               out_specs=out_spec)
    with jmesh.use_mesh(mesh):
        return np.asarray(jax.jit(f)(x))


def _joined(ranks, key):
    return np.concatenate([r[key] for r in ranks])


CASES = {
    # name: (the JAX wrapper's call, its out spec, whether each rank holds
    # the whole result (True) or its block of it)
    "psum": (lambda b: jcoll.psum(b), P(), True),
    "pmean": (lambda b: jcoll.pmean(b), P(), True),
    "pmax": (lambda b: jcoll.pmax(b), P(), True),
    "pmin": (lambda b: jcoll.pmin(b), P(), True),
    "gather": (lambda b: jcoll.all_gather(b), P(), True),
    "gather_tiled": (lambda b: jcoll.all_gather(b, tiled=True), P(), True),
    "scatter": (lambda b: jcoll.reduce_scatter(b), P("data"), False),
    "a2a": (lambda b: jcoll.all_to_all(b), P("data"), False),
    "ppermute": (lambda b: jcoll.ppermute(b, PERM), P("data"), False),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_equals_the_jax_wrapper(ranks, name, dtype):
    fn, spec, whole = CASES[name]
    with jax.enable_x64(dtype == "float64"):
        want = _jax(fn, PAYLOAD.astype(dtype), spec)
    assert want.dtype == np.dtype(dtype)
    key = f"{dtype}_{name}"
    if whole:
        for r in ranks:
            assert r[key].dtype == want.dtype
            np.testing.assert_array_equal(r[key], want)
    else:
        np.testing.assert_array_equal(_joined(ranks, key), want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_all_to_all_across_two_axes_and_scalars(ranks, dtype):
    with jax.enable_x64(dtype == "float64"):
        want = _jax(lambda b: jcoll.all_to_all(b, split_axis=1,
                                               concat_axis=0),
                    SQUARE.astype(dtype), P("data"))
        scal = _jax(lambda b: jax.numpy.stack(jcoll.psum_scalars(
            b.sum(), b.max(), b[0, 0]))[None], PAYLOAD.astype(dtype), P())
    np.testing.assert_array_equal(_joined(ranks, f"{dtype}_a2a_cols"), want)
    for r in ranks:
        # the port stacks float64; the JAX package stacks f32
        np.testing.assert_array_equal(r[f"{dtype}_scalars"],
                                      scal[0].astype(np.float64))


def test_real_valued_psum_axis_index_and_masked_count(ranks):
    want = _jax(lambda b: jcoll.psum(b), REAL.astype(np.float32), P())
    for r in ranks:
        np.testing.assert_allclose(r["real"], want, rtol=0,
                                   atol=np.spacing(np.abs(want).max()))
    idx = _jax(lambda b: jcoll.axis_index()[None], PAYLOAD, P("data"))
    np.testing.assert_array_equal(_joined(ranks, "axis_index"), idx)
    assert list(idx) == list(range(RANKS))
    count = _jax(lambda b: jcoll.masked_count(b)[None], MASK, P())
    for r in ranks:
        assert float(r["masked_count"]) == float(count[0]) == MASK.sum()


@pytest.mark.parametrize("h", [1, 2, 4])
def test_psum_hierarchical_bit_parity_and_hop_bytes(ranks, h):
    per = RANKS // h
    x = PAYLOAD.astype(np.float32)
    expect = x.reshape(RANKS, *BLOCK).sum(axis=0)
    hm = jmesh.host_mesh(h, mesh=jmesh.build_mesh(RANKS))
    want = _jax(lambda b: jcoll.psum_hierarchical(b, ici_size=per), x, P(),
                mesh=hm)
    block_bytes = BLOCK[0] * BLOCK[1] * 4
    for r in ranks:
        np.testing.assert_array_equal(r[f"hier{h}"], expect)
        np.testing.assert_array_equal(r[f"hier{h}"], r[f"hier{h}_flat"])
        np.testing.assert_array_equal(r[f"hier{h}"], want)
        ici, dcn, gather, n_ici, n_dcn = r[f"hier{h}_counts"]
        if per > 1:
            assert (ici, dcn, gather) == (block_bytes, block_bytes / per,
                                          block_bytes / per)
            assert (n_ici, n_dcn) == (1, 1)
        else:   # one rank a group: the flat psum over the dcn hop
            assert (ici, dcn, n_dcn) == (-1, block_bytes, 1)


def test_psum_hierarchical_pads_a_payload_that_does_not_divide(ranks):
    x = ODD.astype(np.float32)      # 3 * 5 = 15 pads to 16 over 2 a group
    hm = jmesh.host_mesh(2, mesh=jmesh.build_mesh(RANKS))
    want = _jax(lambda b: jcoll.psum_hierarchical(b[0], ici_size=2)[None],
                x, P(), mesh=hm)
    for r in ranks:
        np.testing.assert_array_equal(r["odd"], x.sum(axis=0))
        np.testing.assert_array_equal(r["odd"], want[0])


def test_host_shapes_groups_and_partition_equal_the_jax_package(ranks):
    flat = jmesh.build_mesh(RANKS)
    ids = [d.id for d in flat.devices.flat]
    for h in (1, 2, 4):
        jm = jmesh.host_mesh(h, mesh=flat)
        groups = jmesh.host_group_of(jm)
        for r in ranks:
            assert tuple(r[f"hier{h}_shape"]) == (jm.shape["dcn"],
                                                  jm.shape["ici"])
            assert list(r[f"hier{h}_groups"]) == [groups[i] for i in ids]
        # ici index, dcn index and the flat position of each rank
        idx = [tuple(r[f"hier{h}_index"]) for r in ranks]
        per = RANKS // h
        assert idx == [(i % per, i // per, i) for i in range(RANKS)]
    prev = JCONF.get("sml.mesh.hostGroups")
    JCONF.set("sml.mesh.hostGroups", 2)
    try:
        want = jmesh.host_mesh(mesh=flat).shape
    finally:
        JCONF.set("sml.mesh.hostGroups", prev)
    for r in ranks:
        assert tuple(r["conf_shape"]) == (want["dcn"], want["ici"])
        assert int(r["three_groups_raise"][0]) == 1
    parts = jmesh.host_partition(len(PAYLOAD), RANKS)
    assert [tuple(r["row_range"]) for r in ranks] == parts


@pytest.mark.parametrize("n,hosts", [(100, 3), (8, 8), (0, 2), (5, 4),
                                     (4097, 4)])
def test_host_partition_equals_the_jax_package(n, hosts):
    from sml_tpu_torch.parallel import mesh as pmesh
    assert pmesh.host_partition(n, hosts) == jmesh.host_partition(n, hosts)
    sizes = [len(b) for b in np.array_split(np.arange(n), hosts)]
    assert [b - a for a, b in pmesh.host_partition(n, hosts)] == sizes


def test_initialize_multihost_single_process_fast_path(monkeypatch):
    """One process or none: returns False without touching
    torch.distributed (the fast path a one-device fit rides)."""
    import torch.distributed as dist

    from sml_tpu_torch.parallel import collectives

    def boom(**kw):
        raise AssertionError("init_process_group must not be called on "
                             "the single-process fast path")

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "init_process_group", boom)
    assert collectives.initialize_multihost() is False
    assert collectives.initialize_multihost(num_processes=1) is False
    assert collectives.initialize_multihost("127.0.0.1:1",
                                            num_processes=0) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert collectives.initialize_multihost() is False
    assert not dist.is_initialized()


def test_initialize_multihost_wraps_failure_typed(monkeypatch):
    """A failed bring-up raises `MultihostInitError` with the peer config
    (coordinator, process count and slot, backend), chained to the
    original error, with the timeout passed through and the coordinator
    turned into a tcp:// address."""
    import torch.distributed as dist

    from sml_tpu_torch.parallel import collectives

    seen = {}

    def dying(**kw):
        seen.update(kw)
        raise RuntimeError("coordination service unreachable")

    monkeypatch.setattr(dist, "init_process_group", dying)
    with pytest.raises(collectives.MultihostInitError) as ei:
        collectives.initialize_multihost("10.0.0.1:8476", num_processes=2,
                                         process_id=1, timeout_s=7,
                                         device="cpu")
    err = ei.value
    assert err.coordinator == "10.0.0.1:8476"
    assert err.num_processes == 2 and err.process_id == 1
    assert err.backend == "gloo"
    assert isinstance(err.__cause__, RuntimeError)
    assert seen["timeout"] == timedelta(seconds=7)
    assert seen["init_method"] == "tcp://10.0.0.1:8476"
    assert seen["world_size"] == 2 and seen["rank"] == 1
    assert "10.0.0.1:8476" in str(err)
    assert not dist.is_initialized()


TWO = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
from sml_tpu_torch.parallel import collectives as coll
pid = int(sys.argv[1])
assert coll.initialize_multihost("file://" + sys.argv[2], 2, pid,
                                 backend="gloo", device="cpu",
                                 timeout_s=60)
total = float(coll.psum(torch.tensor([float(pid + 1)]))[0])
assert total == 3.0, total
print(f"proc {{pid}} psum-over-processes ok: {{total}}")
"""


def test_two_process_psum(tmp_path):
    _launch(tmp_path, TWO.format(repo=REPO), 2)
