"""The port's black-box bundles (`sml_tpu_torch/obs/blackbox.py`) and
wall-clock anchors, on the CPU; the blackbox and anchor cases of
tests/test_obs_forensics.py.

- A forced stall dumps a bundle with every section of the JAX package's
  layout (MANIFEST.json, events.jsonl, metrics.json, audit.json,
  ledger.json); the unchanged `scripts/blackbox_view.py` renders it in a
  subprocess that never imports jax, sml_tpu or torch, which proves the
  format is the reference's; the port's own `_tracefmt.py`, loaded by
  file path, renders its events too.
- `install()`'s stall hook dumps exactly one bundle a process; the
  manifest's exception block has the JAX package's shape.
- The JSONL sink's header line and the exported trace both carry the
  recorder's `epoch_unix`.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

from sml_tpu_torch import obs as pobs
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.utils.profiler import PROFILER

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
VIEWER = os.path.join(REPO, "scripts", "blackbox_view.py")
TRACEFMT = os.path.join(REPO, "sml_tpu_torch", "obs", "_tracefmt.py")


@pytest.fixture()
def recorder():
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    try:
        yield pobs.RECORDER
    finally:
        PCONF.set("sml.obs.enabled", False)
        for key in ("sml.obs.stallMillis", "sml.obs.stallFactor",
                    "sml.obs.blackboxDir", "sml.obs.sinkPath"):
            PCONF.unset(key)
        pobs.reset()


def _force_activity():
    """Events, a metric with an exemplar, and a flagged stall."""
    PCONF.set("sml.obs.stallMillis", 50)
    PCONF.set("sml.obs.stallFactor", 2.0)
    ctx = pobs.new_trace()
    pobs.METRICS.observe("serve.request_ms", 42.0, exemplar=ctx.trace_id)
    PROFILER.count("staging.cache_hit")
    pobs.LEDGER.alloc("bin_cache", 4096)
    with pobs.WATCHDOG.watch("serve.flush", "serve.batch", trace=ctx):
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if any(e.name == "stall.detected"
                   for e in pobs.RECORDER.events()):
                break
            time.sleep(0.02)
    pobs.LEDGER.free("bin_cache", 4096)
    return ctx


def test_blackbox_bundle_renders_with_the_unchanged_viewer(recorder,
                                                           tmp_path):
    ctx = _force_activity()
    bundle = pobs.dump_blackbox("test-forced-stall", directory=str(tmp_path))
    assert bundle and os.path.isdir(bundle)
    sizes = {name: os.path.getsize(os.path.join(bundle, name))
             for name in ("MANIFEST.json", "events.jsonl", "metrics.json",
                          "audit.json", "ledger.json")}
    assert all(v > 0 for v in sizes.values()), sizes
    with open(os.path.join(bundle, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == "test-forced-stall"
    assert manifest["package"] == "sml_tpu_torch"
    assert abs(manifest["dumped_unix"] - time.time()) < 120
    assert manifest["epoch_unix"] <= manifest["dumped_unix"]
    assert manifest["conf"]["sml.obs.enabled"] is True
    assert manifest["thread_stacks"]
    with open(os.path.join(bundle, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["metrics"]["serve.request_ms"]["count"] >= 1
    assert metrics["slo"]["worst_trace"] == f"0x{ctx.trace_id:013x}"
    with open(os.path.join(bundle, "ledger.json")) as f:
        ledger = json.load(f)
    assert ledger["bin_cache"]["peak"] >= 4096
    stall_lines = [json.loads(ln) for ln in
                   open(os.path.join(bundle, "events.jsonl"))
                   if "stall.detected" in ln]
    assert stall_lines and stall_lines[0]["args"]["stacks"]

    probe = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('_v', {VIEWER!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"rc = m.main([{bundle!r}])\n"
        "for mod in ('jax', 'sml_tpu', 'sml_tpu_torch', 'torch'):\n"
        "    assert mod not in sys.modules, mod\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", probe],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "blackbox bundle" in proc.stdout
    assert "test-forced-stall" in proc.stdout
    assert "stall" in proc.stdout
    with open(os.path.join(bundle, "trace.json")) as f:
        doc = json.load(f)
    assert doc["otherData"]["epoch_unix"] == pytest.approx(
        manifest["epoch_unix"], abs=1.0)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "stall.detected" in names

    # the port's own converter, by file path, renders the same events
    spec = importlib.util.spec_from_file_location("_pt_tracefmt", TRACEFMT)
    fmt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fmt)
    records = [json.loads(ln) for ln in
               open(os.path.join(bundle, "events.jsonl"))][1:]
    own = fmt.trace_doc(records, epoch_unix=manifest["epoch_unix"])
    assert {e.get("name") for e in own["traceEvents"]} == names
    host = [e for e in own["traceEvents"] if e.get("name") == "process_name"
            and e["pid"] == fmt.PID_HOST]
    assert host[0]["args"]["name"] == "sml_tpu_torch host"


def test_blackbox_with_the_recorder_off_still_dumps(tmp_path):
    assert not pobs.RECORDER.enabled
    bundle = pobs.dump_blackbox("off", directory=str(tmp_path))
    with open(os.path.join(bundle, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["recorder_enabled"] is False
    assert manifest["inflight"] == []


def test_blackbox_stall_hook_dumps_once(recorder, tmp_path, monkeypatch):
    from sml_tpu_torch.obs import blackbox
    PCONF.set("sml.obs.blackboxDir", str(tmp_path / "bb"))
    monkeypatch.setitem(blackbox._state, "stall_dumped", False)
    blackbox._stall_hook({"name": "program.wedged"})
    blackbox._stall_hook({"name": "program.wedged"})
    root = tmp_path / "bb"
    bundles = os.listdir(root) if root.exists() else []
    assert len(bundles) == 1, bundles


def test_exception_block_shapes():
    from sml_tpu.obs import blackbox as jbb
    from sml_tpu_torch.obs import blackbox
    try:
        raise ValueError("boom")
    except ValueError as e:
        blk = blackbox._exception_block(e)
        blk2 = blackbox._exception_block(sys.exc_info())
        jblk = jbb._exception_block(e)
    assert blk["type"] == "ValueError" and "boom" in blk["value"]
    assert any("boom" in ln for ln in blk["traceback"])
    assert blk2["type"] == "ValueError"
    assert blackbox._exception_block(None) is None
    assert set(blk) == set(jblk) and blk["value"] == jblk["value"]


def test_sink_header_and_trace_carry_epoch_anchor(recorder, tmp_path):
    sink = tmp_path / "events.jsonl"
    PCONF.set("sml.obs.sinkPath", str(sink))
    try:
        pobs.RECORDER.emit("cache", "cache.anchor_probe", args={})
        lines = [json.loads(ln) for ln in sink.read_text().splitlines()]
    finally:
        PCONF.set("sml.obs.sinkPath", "")
    assert lines[0]["kind"] == "meta" and lines[0]["name"] == "obs.header"
    anchor = lines[0]["args"]["epoch_unix"]
    assert abs(anchor - time.time()) < 300
    assert anchor == pytest.approx(pobs.RECORDER.epoch_unix(), abs=1.0)
    out = tmp_path / "trace.json"
    pobs.export_chrome_trace(str(out))
    doc = json.loads(out.read_text())
    assert doc["otherData"]["epoch_unix"] == pytest.approx(anchor, abs=1.0)
