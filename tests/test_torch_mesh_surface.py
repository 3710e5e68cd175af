"""The rest of the mesh's surface and the package root, against the JAX
package, on the CPU in one process.

- The package root exports the JAX package's names (`__all__` equal),
  `__version__` from `version.py` and `install_shims()`, which imports
  `compat` inside the call.
- `SkewTracker.note(hosts=...)` rolls per-rank timings up to host groups
  as the JAX package's does (`tests/test_hierarchical.py:573-601`): the
  entry's host ids, per-host compute and slowest host, the straggler
  report's slowest host, host count, per-host wait and `host_skew_ratio`,
  the `skew.host.compute` / `skew.host.wait` spans, and a host-free note
  whose report has no host block, equal in both packages.
- Outside a mesh `addressable_row_blocks` / `host_row_blocks` give one
  block, the whole array, in group 0.
- A prewarm manifest whose entries were recorded over another mesh (its
  signature's width or host groups) is skipped, the doctored-manifest
  case of `tests/test_multichip.py:354-382`.
- The evaluators' ordered block reduction: a block's sum is its runs of
  64 rows, each summed in row order, summed in run order; splitting the
  blocks over ranks (`eval_blocks`) covers every row once.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch


def test_root_all_is_the_jax_package_s():
    import sml_tpu
    import sml_tpu_torch
    assert sorted(sml_tpu_torch.__all__) == sorted(sml_tpu.__all__)
    for name in sml_tpu_torch.__all__:
        assert hasattr(sml_tpu_torch, name), name
    from sml_tpu_torch import version
    assert sml_tpu_torch.__version__ == version.__version__


def test_install_shims_imports_compat_inside_the_call():
    """A fresh interpreter: importing the root loads no `compat`; the
    call installs the course's import names."""
    code = ("import sys; import sml_tpu_torch as p; "
            "a = 'sml_tpu_torch.compat' in sys.modules; "
            "p.install_shims(); import pyspark.ml.feature as f; "
            "print(a, 'sml_tpu_torch.compat' in sys.modules, "
            "f.__name__)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "True",
                                   "sml_tpu_torch.ml.feature"]


@pytest.fixture()
def both_recording():
    from sml_tpu import obs as jobs
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu_torch import obs as pobs
    from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
    for conf in (JCONF, PCONF):
        conf.set("sml.obs.enabled", True)
    jobs.reset()
    pobs.reset()
    try:
        yield jobs, pobs
    finally:
        for conf in (JCONF, PCONF):
            conf.unset("sml.obs.enabled")
        jobs.RECORDER.reconfigure()
        pobs.RECORDER.reconfigure()
        jobs.reset()
        pobs.reset()


def test_skew_tracker_host_lanes_and_report(both_recording):
    out = {}
    for pkg, obs in zip(("jax", "port"), both_recording):
        tracker = obs.SKEW
        tracker.reset()
        e = tracker.note("hier_probe", [1.0, 2.0, 1.5, 0.5],
                         devices=[0, 1, 2, 3], hosts=[0, 0, 1, 1])
        rep = tracker.straggler_report()
        names = [ev.name for ev in obs.RECORDER.events()]
        tracker.reset()
        tracker.note("flat_probe", [1.0, 1.2])
        flat = tracker.straggler_report()
        with pytest.raises(ValueError):
            tracker.note("bad", [1.0, 2.0], hosts=[0])
        out[pkg] = (e, rep, names, flat)
    e, rep, names, flat = out["port"]
    assert e["host_ids"] == [0, 1]
    assert e["per_host_compute_s"] == [2.0, 1.5]
    assert e["slowest_host"] == 0
    assert rep["slowest_host"] == 0 and rep["n_hosts"] == 2
    assert rep["per_host"][1]["wait_s"] == pytest.approx(0.5)
    assert rep["host_skew_ratio"] == pytest.approx(2.0 / 1.75, rel=1e-3)
    assert "skew.host.compute" in names and "skew.host.wait" in names
    assert "slowest_host" not in flat
    je, jrep, jnames, jflat = out["jax"]
    for k in ("host_ids", "per_host_compute_s", "slowest_host"):
        assert e[k] == je[k], k
    for k in ("slowest_host", "n_hosts", "host_skew_ratio", "per_host"):
        assert rep[k] == jrep[k], k
    assert sorted(n for n in names if n.startswith("skew.host")) == \
        sorted(n for n in jnames if n.startswith("skew.host"))
    assert set(flat) == set(jflat)


def test_row_blocks_outside_a_mesh_are_the_whole_array():
    from sml_tpu_torch.parallel import mesh as M
    arr = np.arange(12).reshape(4, 3)
    [(dev, blk)] = M.addressable_row_blocks(arr)
    assert dev == torch.device("cpu") and blk is arr
    t = torch.zeros(5, 2)
    assert M.host_row_blocks(t) == [(0, [(t.device, t)])]


@pytest.mark.parametrize("mesh_sig", [[4, 1], [4, 2], [2, 1]])
def test_prewarm_skips_a_manifest_recorded_over_another_mesh(tmp_path,
                                                             mesh_sig):
    from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
    from sml_tpu_torch.parallel import prewarm as pw
    prev = PCONF.get("sml.compile.cacheDir")
    PCONF.set("sml.compile.cacheDir", str(tmp_path))
    pw.reset()
    try:
        pw.record_stage(torch.device("cpu"), (37, 10), np.uint8)
        pw.record_stage(torch.device("cpu"), (500, 10), np.uint8)
        pw.flush()
        path = tmp_path / "prewarm_manifest.json"
        doc = json.loads(path.read_text())
        assert [e["device"] for e in doc["entries"].values()] == \
            [["cpu", 1, 1, 1]] * 2
        for e in doc["entries"].values():
            e["device"] = ["cpu", 1] + mesh_sig   # doctored: another mesh
        path.write_text(json.dumps(doc))
        pw.reset()
        stats = pw.prewarm(device="cpu")
    finally:
        PCONF.set("sml.compile.cacheDir", prev)
        pw.reset()
    assert stats["programs"] == 0 and stats["skipped"] == 2


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 20_000])
def test_block_partials_sum_each_block_in_a_fixed_order(n):
    from sml_tpu_torch.ml import evaluation as pev
    rng = np.random.default_rng(n)
    cols = torch.from_numpy(rng.normal(size=(n, 3)))
    got = pev.block_partials(cols).numpy()
    B, run = pev.EVAL_BLOCK_ROWS, pev._SCAN
    assert got.shape == (-(-n // B), 3)
    rows = cols.numpy()
    for b in range(got.shape[0]):
        want = np.zeros(3)
        for r0 in range(b * B, (b + 1) * B, run):
            part = np.zeros(3)
            for row in rows[r0:min(r0 + run, n)]:
                part = part + row     # one add after another
            want = want + part
        np.testing.assert_array_equal(got[b], want)
    total = pev.reduce_blocks(pev.block_partials(cols), 0, got.shape[0])
    assert total.shape == (3,)


class _FakeMesh:
    def __init__(self, size, rank):
        self.size, self.rank = size, rank


@pytest.mark.parametrize("size", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("n", [0, 100, 4096, 26_667, 100_000])
def test_eval_blocks_cover_every_row_once(n, size):
    from sml_tpu_torch.ml import evaluation as pev
    seen = []
    firsts = []
    for rank in range(size):
        first, total, rows = pev.eval_blocks(n, _FakeMesh(size, rank))
        assert total == -(-n // pev.EVAL_BLOCK_ROWS)
        assert rows.start == min(first * pev.EVAL_BLOCK_ROWS, n)
        seen.extend(range(n)[rows])
        firsts.append(first)
    assert seen == list(range(n))
    assert firsts == sorted(firsts)
