"""The port's regression gate (`sml_tpu_torch/obs/regress.py`,
`scripts/torch_bench_diff.py`) on the CPU, every record built in memory.

- (a) On seeded bench sidecars and driver records that carry every block
  the JAX package's `sml_tpu/obs/regress.py` judges, and on seeded
  perturbations of them (numbers scaled, proofs flipped, counts grown,
  blocks, legs, shapes and lines dropped), the port's `normalize`,
  `compare` (at several `min_tol`), `render` and `trace_events` equal the
  reference's, dict for dict and string for string (the reference loaded
  by file path: it imports no jax).
- (b) The port's counterparts of the reference's rule tests
  (tests/test_engine_health.py:308-419, test_chunked_ingest.py:345,
  test_drift.py:408, test_fleet.py:506, test_hierarchical.py:619,
  test_lint_clean.py:194, test_loadgen.py:332-378,
  test_traverse_kernel.py:312, test_obs_forensics.py:329) on in-memory
  records; those that read a committed record or run `bench.py` are left
  out.
- (c) The torch-smoke run record (`record_from_blocks` over synthetic
  blocks with the keys `chip_smoke.py` prints): the self-compare is clean;
  each of phase 27's injections (`chip_smoke.rg_injections`) gives
  exactly its finding; an improvement is listed as one; the racy paths'
  tolerance; another card or host turns off the wall rules only; a null
  `device_ms` is absent; each family's rule; phase 27 itself
  (`chip_smoke.phase_regress`) on the whole record and on `--only 27`'s.
- (d) `scripts/torch_bench_diff.py` in a subprocess on two temporary
  records: exit 0 and 1, `--trace` and `--min-tol`, and the child's
  `sys.modules` holds none of torch, jax, sml_tpu or sml_tpu_torch.
"""

import copy
import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from sml_tpu_torch import obs as pobs
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.obs import regress
from sml_tpu_torch.obs._trace import to_trace_events

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DIFF = os.path.join(REPO, "scripts", "torch_bench_diff.py")
FORBIDDEN = ("torch", "jax", "sml_tpu", "sml_tpu_torch")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _by_path(name, *parts):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _by_path("_reference_regress", "sml_tpu", "obs", "regress.py")


def _kinds(res, key="regressions"):
    return [(f["kind"], f["key"]) for f in res[key]]


# ------------------------------------------------- (a) the reference's shapes
LEGS = ("ml02_lr", "ml03_lr", "ml06_dt", "ml07_rf", "ml07_cv", "ml11_xgb",
        "serving")


def _blocks(rng) -> dict:
    """Every block the reference judges beside the legs, seeded."""
    u = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
    n = lambda lo, hi: int(rng.integers(lo, hi))  # noqa: E731
    flag = lambda p=0.9: bool(rng.random() < p)  # noqa: E731
    return {
        "multichip": {"widths": [
            {"devices": d, "seconds": u(1, 20), "collective_psum": n(1, 300),
             "collective_psum_bytes": float(n(1 << 10, 1 << 26))}
            for d in (1, 2, 4, 8)]},
        "multihost": {"shapes": [
            {"hosts": h, "per_host": 4, "seconds": u(0.5, 3),
             "psum_ici": n(1, 9), "psum_dcn": n(1, 9),
             "psum_bytes_ici": float(n(1000, 20000)),
             "psum_bytes_dcn": float(n(100, 5000)), "parity_ok": flag(),
             "slowest_host": 0,
             "host_skew": [{"host": i, "compute_ms": u(1, 2)}
                           for i in range(h)] if flag() else None}
            for h in (2, 4)]},
        "kernel": {"legs": [
            {"max_bins": b, "max_depth": d, "pallas_s": u(0.1, 2),
             "xla_s": u(0.1, 2) if flag() else None,
             "kernel_counters": {"kernel.fallback": float(n(0, 2))}}
            for b in (32, 256) for d in (4, 8)]},
        "kernel_infer": {"fallbacks": float(n(0, 2)),
                         "tuned_beats_default": flag(), "replay_ok": flag(),
                         "interpret": flag(0.3), "legs": []},
        "scale": {"rows": 10_000_000, "ingest_rows_per_s": u(1e5, 5e5),
                  "predict_rows_per_s": u(1e5, 5e5),
                  "prefetch": {"events_ok": flag()}},
        "drift": {"baseline": {"reload_bit_compat": flag()},
                  "iid": {"flagged": flag(0.1), "n_flagged": 0,
                          "max_severity": u(0.1, 0.5)},
                  "shift": {"flagged": flag(), "named_ok": flag(),
                            "n_flagged": 3}},
        "lint": {"rules": n(14, 16), "files": 119, "violations": n(0, 2),
                 "suppressed_pragma": 88, "suppressed_baseline": 3,
                 "violations_by_rule": {"untracked-compile-input": 0}
                 if flag(0.5) else {}},
        "ct": {"drift": {"promoted": flag(), "hot_swap": flag(),
                         "warm_refits": n(0, 3), "request_errors": n(0, 2)},
               "iid": {"refits": n(0, 2)}},
        "fleet": {
            "requests": 10_000, "hung_futures": n(0, 2),
            "closed_loop": flag(0.3), "priority_order_ok": flag(),
            "priority": {c: {"p99_ms": u(5, 60), "shed_rate": u(0, 0.7)}
                         for c in ("high", "normal", "low")},
            "scale": {"up_ok": flag(), "down_ok": flag()},
            "rollout": {"clean": {"passed": flag()},
                        "rollback": {"rolled_back": flag(),
                                     "blackbox_on_disk": flag()}},
            "trace": {"fanin_ok": flag()}},
        "load": {
            "requests": 500, "overrun": n(0, 2), "shed_rate": u(0, 0.1),
            "engineering": {"win": flag()},
            "phases": {ph: {
                "p50_ms": u(1, 5), "p99_ms": u(5, 20), "p999_ms": u(10, 40),
                "worst_trace": "0x00000abc" if flag() else None,
                "classes": {"high": {"p99_ms": u(4, 12), "count": 50}}}
                for ph in ("steady", "burst")}},
    }


def _sidecar(seed: int) -> dict:
    rng = np.random.default_rng([seed, 1])
    legs = {}
    for name in LEGS:
        passes = [float(rng.uniform(0.5, 40))] * 3
        passes = [p * float(rng.uniform(1.0, 1.2)) for p in passes]
        counters = {"compile.programs": float(rng.integers(1, 30)),
                    "tree.fit_dispatch": float(rng.integers(1, 20)),
                    "staging.h2d_bytes": float(rng.integers(1, 1 << 26)),
                    "staging.d2h_bytes": float(rng.integers(1, 1 << 22)),
                    "collective.psum_bytes": float(rng.integers(1, 1 << 24))}
        if rng.random() < 0.5:
            counters["kernel.fallback"] = float(rng.integers(0, 2))
        leg = {"seconds": min(passes), "seconds_per_pass": passes,
               "engine_counters": counters}
        if rng.random() < 0.5:
            leg["programs_compiled"] = int(rng.integers(1, 30))
            leg["tree_fit_dispatches"] = int(rng.integers(1, 20))
        legs[name] = leg
    metrics = {"serve_p50_ms": float(rng.uniform(1, 5)),
               "serve_p99_ms": float(rng.uniform(5, 30)),
               "serve_worst_trace": "0x21bd608200001"}
    if rng.random() < 0.3:
        metrics["serve_closed_loop"] = 1.0
    walls = [float(rng.uniform(90, 120)) for _ in range(3)]
    return dict(_blocks(rng), value=min(walls), timed_pass_walls=walls,
                legs=legs, metrics=metrics)


def _driver_record(seed: int) -> dict:
    rng = np.random.default_rng([seed, 2])
    lines = ["bench: suite", "legs:"]
    lines += [f"  {name}  {rng.uniform(0.5, 40):.2f}s" for name in LEGS]
    lines += ["metrics:"]
    lines += [f"  {k}  {rng.uniform(1, 30):.3f}"
              for k in ("serve_p50_ms", "serve_p99_ms", "fit_rmse")]
    blocks = _blocks(rng)
    walls = [float(rng.uniform(90, 120)) for _ in range(3)]
    return dict(blocks, scaling=blocks.pop("multichip"),
                parsed={"value": min(walls), "pass_walls": walls},
                tail="\n".join(lines))


#: ints the reference reads as identities, never perturbed
_IDS = {"devices", "hosts", "max_bins", "max_depth", "per_host", "host",
        "slowest_host", "rows"}


def _perturb(doc: dict, rng) -> dict:
    """A seeded candidate: numbers scaled, booleans flipped, counts
    grown, and blocks, legs, shapes, phases and tail lines dropped."""
    doc = copy.deepcopy(doc)

    def walk(node):
        if isinstance(node, dict):
            for k in list(node):
                v = node[k]
                if isinstance(v, bool):
                    if rng.random() < 0.15:
                        node[k] = not v
                elif isinstance(v, float) and rng.random() < 0.5:
                    node[k] = v * math.exp(rng.normal(0.0, 0.3))
                elif isinstance(v, int) and k not in _IDS \
                        and rng.random() < 0.2:
                    node[k] = max(0, v + int(rng.integers(-1, 3)))
                elif isinstance(v, (dict, list)):
                    walk(v)
                    if isinstance(v, dict) and k in ("legs", "phases") \
                            and len(v) > 1 and rng.random() < 0.3:
                        v.pop(sorted(v)[int(rng.integers(len(v)))])
        elif isinstance(node, list):
            for v in node:
                walk(v)
            if node and isinstance(node[0], dict) and rng.random() < 0.2:
                node.pop(int(rng.integers(len(node))))

    walk(doc)
    for block in ("multichip", "scaling", "multihost", "kernel",
                  "kernel_infer", "scale", "drift", "lint", "ct", "fleet",
                  "load"):
        if block in doc and rng.random() < 0.08:
            doc.pop(block)
    if "tail" in doc:
        out = []
        for line in doc["tail"].splitlines():
            if rng.random() < 0.1:
                continue
            out.append(re.sub(r"([0-9]+\.[0-9]+)", lambda m: (
                f"{float(m.group(1)) * math.exp(rng.normal(0, 0.3)):.2f}"),
                line))
        doc["tail"] = "\n".join(out)
    return doc


@pytest.mark.parametrize("shape", ["sidecar", "record"])
@pytest.mark.parametrize("seed", range(6))
def test_reference_shapes_judged_as_the_reference_judges(seed, shape):
    make = _sidecar if shape == "sidecar" else _driver_record
    other = _driver_record if shape == "sidecar" else _sidecar
    doc = make(seed)
    rng = np.random.default_rng([seed, 3])
    cands = [doc, other(seed)] + [_perturb(doc, rng) for _ in range(4)]
    flagged = 0
    for cand in cands:
        nb, nc = regress.normalize(doc), regress.normalize(cand)
        assert nb == REF.normalize(doc) and nc == REF.normalize(cand)
        for tol in (0.0, regress.MIN_TOL, 0.12, 0.3):
            got = regress.compare(nb, nc, tol)
            want = REF.compare(REF.normalize(doc), REF.normalize(cand), tol)
            assert got == want
            assert regress.render(got, "b.json", "c.json") == \
                REF.render(want, "b.json", "c.json")
            assert regress.trace_events(got) == REF.trace_events(want)
            flagged += not got["ok"]
    assert regress.compare(regress.normalize(doc),
                           regress.normalize(doc))["ok"]
    assert flagged > 0


def test_reference_constants_kept():
    for name in ("MIN_TOL", "TOL_CAP", "SERVE_TOL", "LOAD_TOL", "STATIC_TOL",
                 "BYTES_FLOOR", "LINT_RULE_FLOOR", "COUNTER_CHECKS"):
        assert getattr(regress, name) == getattr(REF, name), name
    assert regress.LINT_RULE_FLOOR == 14
    assert regress.SMOKE_LINT_RULE_FLOOR == 11


def test_diff_paths_and_load_equal_the_reference(tmp_path):
    base, cand = tmp_path / "b.json", tmp_path / "c.json"
    base.write_text(json.dumps(_sidecar(7)))
    cand.write_text(json.dumps(_perturb(_sidecar(7),
                                        np.random.default_rng(7))))
    assert regress.load(str(base)) == REF.load(str(base))
    assert regress.diff_paths(str(base), str(cand)) == \
        REF.diff_paths(str(base), str(cand))


# ---------------------------------------- (b) the reference's rule tests
def _doc(**blocks):
    doc = {"legs": {}, "value": 1.0, "metrics": {}}
    doc.update({k: v for k, v in blocks.items() if v is not None})
    return regress.normalize(doc)


RECORD = {"parsed": {}, "tail": ""}


def test_counter_collective_and_coverage_rules():
    """tests/test_engine_health.py:343: a leg vanishing, a dispatch-count
    growth, a multichip psum-payload growth and a kernel fallback each
    flag; the kernelbench block and one of its legs vanishing flag."""
    raw = _sidecar(0)
    base = regress.normalize(raw)
    cand = copy.deepcopy(base)
    cand["legs"].pop("ml06_dt")
    assert ("missing-leg", "ml06_dt") in _kinds(regress.compare(base, cand))
    cand = copy.deepcopy(base)
    cand["legs"]["ml07_cv"]["counters"]["tree.fit_dispatch"] += 9.0
    assert ("leg-counter", "ml07_cv:tree.fit_dispatch") in _kinds(
        regress.compare(base, cand))
    grown = copy.deepcopy(raw)
    for e in grown["multichip"]["widths"]:
        e["collective_psum_bytes"] *= 1.10
    assert any(f["kind"] == "multichip-collective" for f in regress.compare(
        base, regress.normalize(grown))["regressions"])
    cand = copy.deepcopy(base)
    cand["legs"]["ml07_rf"]["counters"].pop("kernel.fallback", None)
    base2 = copy.deepcopy(cand)
    cand["legs"]["ml07_rf"]["counters"]["kernel.fallback"] = 1.0
    assert ("leg-counter", "ml07_rf:kernel.fallback") in _kinds(
        regress.compare(base2, cand))
    fell = copy.deepcopy(raw)
    for e in fell["kernel"]["legs"]:
        e["kernel_counters"]["kernel.fallback"] += 1.0
    assert any(f["kind"] == "kernel-fallback" for f in regress.compare(
        base, regress.normalize(fell))["regressions"])
    gone = copy.deepcopy(raw)
    gone.pop("kernel")
    assert ("missing-kernel-block", "kernel") in _kinds(
        regress.compare(base, regress.normalize(gone)))
    short = copy.deepcopy(raw)
    short["kernel"]["legs"] = short["kernel"]["legs"][1:]
    assert any(f["kind"] == "missing-kernel-leg" for f in regress.compare(
        base, regress.normalize(short))["regressions"])


def test_injected_leg_wall_flags_in_both_reference_shapes(tmp_path):
    """tests/test_engine_health.py:308 and :326 (in memory): a 25% slower
    sidecar leg and a 30% slower driver-record leg each flag, and the
    CLI exits 1 on them."""
    side = _sidecar(1)
    slow = copy.deepcopy(side)
    slow["legs"]["ml07_cv"]["seconds"] *= 1.25
    slow["legs"]["ml07_cv"]["seconds_per_pass"] = [
        x * 1.25 for x in slow["legs"]["ml07_cv"]["seconds_per_pass"]]
    rec = _driver_record(1)
    slow_rec = copy.deepcopy(rec)
    slow_rec["tail"] = re.sub(
        r"ml11_xgb(\s+)([0-9.]+)s",
        lambda m: f"ml11_xgb{m.group(1)}{float(m.group(2)) * 1.3:.2f}s",
        rec["tail"])
    for base, cand, key in ((side, slow, "ml07_cv"),
                            (rec, slow_rec, "ml11_xgb")):
        b, c = tmp_path / "b.json", tmp_path / "c.json"
        b.write_text(json.dumps(base))
        c.write_text(json.dumps(cand))
        proc = _run_diff(str(b), str(c), "--json")
        assert proc.returncode == 1, proc.stdout + proc.stderr
        got = json.loads(proc.stdout)
        assert ("leg-wall", key) in _kinds(got)


@pytest.fixture()
def recorder():
    prev = PCONF.get("sml.obs.enabled")
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    yield pobs
    PCONF.set("sml.obs.enabled", bool(prev))
    pobs.reset()


def test_verdicts_annotate_the_trace(recorder, tmp_path):
    """tests/test_engine_health.py:419: verdicts land in the flight
    recorder as `regress.verdict` events and render as instant markers;
    `--trace` writes the standalone marker file."""
    base = regress.normalize(_sidecar(2))
    cand = copy.deepcopy(base)
    cand["legs"]["ml02_lr"]["seconds"] *= 1.5
    cand["legs"]["ml02_lr"]["passes"] = [
        x * 1.5 for x in cand["legs"]["ml02_lr"]["passes"]]
    res = regress.compare(base, cand)
    assert not res["ok"]
    n = pobs.annotate_regressions(res["regressions"])
    assert n == len(res["regressions"]) >= 1
    marks = [e for e in to_trace_events(pobs.RECORDER.events())
             if e.get("ph") == "i" and e["name"] == "regress.verdict"]
    assert len(marks) == n and marks[0]["args"]["key"] == "ml02_lr"
    side = tmp_path / "side.json"
    side.write_text(json.dumps(_sidecar(2)))
    out = tmp_path / "verdicts.json"
    proc = _run_diff(str(side), str(side), "--trace", str(out))
    assert proc.returncode == 0
    assert json.loads(out.read_text())["traceEvents"] == []


def test_scale_block_rules():
    """tests/test_chunked_ingest.py:345."""
    block = {"rows": 10_000_000, "ingest_rows_per_s": 300_000.0,
             "predict_rows_per_s": 400_000.0,
             "prefetch": {"events_ok": True}}
    base = _doc(scale=block)
    assert regress.compare(base, _doc(scale=dict(block)))["ok"]
    assert ("missing-scale-block", "scale") in _kinds(
        regress.compare(base, _doc()))
    assert regress.compare(base, regress.normalize(RECORD))["ok"]
    slow = dict(block, ingest_rows_per_s=210_000.0)
    assert ("scale-throughput", "ingest_rows_per_s") in _kinds(
        regress.compare(base, _doc(scale=slow)))
    serial = dict(block, prefetch={"events_ok": False})
    assert ("scale-overlap", "prefetch.events_ok") in _kinds(
        regress.compare(base, _doc(scale=serial)))
    other = dict(block, rows=1_000_000, ingest_rows_per_s=100_000.0)
    assert regress.compare(base, _doc(scale=other))["ok"]


def _drift_block(shift_flagged=True, named_ok=True, iid_flagged=False,
                 bit_compat=True):
    return {"baseline": {"reload_bit_compat": bit_compat},
            "iid": {"flagged": iid_flagged, "n_flagged": int(iid_flagged),
                    "max_severity": 0.4},
            "shift": {"flagged": shift_flagged, "named_ok": named_ok,
                      "n_flagged": 3}}


@pytest.mark.parametrize("change, finding", [
    ({"shift_flagged": False}, ("drift-detection", "shift.flagged")),
    ({"named_ok": False}, ("drift-detection", "shift.named_ok")),
    ({"iid_flagged": True}, ("drift-false-positive", "iid.flagged")),
    ({"bit_compat": False}, ("drift-roundtrip",
                             "baseline.reload_bit_compat")),
])
def test_drift_proofs(change, finding):
    """tests/test_drift.py:408."""
    base = _doc(drift=_drift_block())
    assert regress.compare(base, base)["ok"]
    assert ("missing-drift-block", "drift") in _kinds(
        regress.compare(base, _doc()))
    assert _kinds(regress.compare(base, _doc(
        drift=_drift_block(**change)))) == [finding]


def _fleet_block(hung=0, up_ok=True, down_ok=True, clean=True,
                 rolled_back=True, bb=True, order=True, fanin=True,
                 low_shed=0.6, low_p99=50.0):
    return {"requests": 10_000, "hung_futures": hung,
            "priority_order_ok": order,
            "priority": {"high": {"p99_ms": 20.0, "shed_rate": 0.0},
                         "normal": {"p99_ms": 30.0, "shed_rate": 0.2},
                         "low": {"p99_ms": low_p99, "shed_rate": low_shed}},
            "scale": {"up_ok": up_ok, "down_ok": down_ok},
            "rollout": {"clean": {"passed": clean},
                        "rollback": {"rolled_back": rolled_back,
                                     "blackbox_on_disk": bb}},
            "trace": {"fanin_ok": fanin}}


@pytest.mark.parametrize("change, finding", [
    ({"hung": 3}, ("fleet-liveness", "hung_futures")),
    ({"rolled_back": False}, ("fleet-proof", "rollout.rollback.rolled_back")),
    ({"bb": False}, ("fleet-proof", "rollout.rollback.blackbox_on_disk")),
    ({"clean": False}, ("fleet-proof", "rollout.clean.passed")),
    ({"up_ok": False}, ("fleet-proof", "scale.up_ok")),
    ({"down_ok": False}, ("fleet-proof", "scale.down_ok")),
    ({"order": False}, ("fleet-proof", "priority_order_ok")),
    ({"fanin": False}, ("fleet-proof", "trace.fanin_ok")),
    ({"low_p99": 200.0}, ("fleet-latency", "low:p99_ms")),
    ({"low_shed": 0.95}, ("fleet-shed-rate", "low:shed_rate")),
])
def test_fleet_proofs(change, finding):
    """tests/test_fleet.py:506."""
    base = _doc(fleet=_fleet_block())
    assert regress.compare(base, base)["ok"]
    assert ("missing-fleet-block", "fleet") in _kinds(
        regress.compare(base, _doc()))
    assert _kinds(regress.compare(base, _doc(
        fleet=_fleet_block(**change)))) == [finding]


def _mh_entry(**over):
    e = {"hosts": 2, "per_host": 4, "seconds": 1.0, "psum_ici": 5,
         "psum_dcn": 5, "psum_bytes_ici": 9408.0, "psum_bytes_dcn": 2352.0,
         "parity_ok": True, "slowest_host": 0,
         "host_skew": [{"host": 0, "compute_ms": 1.0},
                       {"host": 1, "compute_ms": 1.2}]}
    e.update(over)
    return e


@pytest.mark.parametrize("entry, kind", [
    (_mh_entry(psum_bytes_dcn=9408.0), "multihost-collective"),
    (_mh_entry(parity_ok=False), "multihost-parity"),
    (_mh_entry(host_skew=None), "multihost-skew"),
    (_mh_entry(hosts=4), "missing-multihost-shape"),
    (None, "missing-multihost-block"),
])
def test_multihost_block(entry, kind):
    """tests/test_hierarchical.py:619."""
    base = _doc(multihost={"shapes": [_mh_entry()]})
    assert regress.compare(base, _doc(multihost={"shapes": [_mh_entry()]}
                                      ))["ok"]
    rec = regress.normalize(RECORD)
    assert rec["shape"] == "record" and regress.compare(base, rec)["ok"]
    cand = _doc(multihost=None if entry is None else {"shapes": [entry]})
    res = regress.compare(base, cand)
    assert not res["ok"]
    assert any(f["kind"] == kind for f in res["regressions"])


LINT = {"rules": 14, "files": 119, "violations": 0,
        "suppressed_pragma": 88, "suppressed_baseline": 3}


@pytest.mark.parametrize("base_lint, cand_lint, kind", [
    (LINT, None, "missing-lint-block"),
    (LINT, dict(LINT, violations=2), "lint-violations"),
    (LINT, dict(LINT, rules=9), "lint-rules"),
    (dict(LINT, rules=10), dict(LINT, rules=13), "lint-rule-floor"),
    (LINT, dict(LINT, violations_by_rule={"untracked-compile-input": 1}),
     "lint-compile-input"),
])
def test_lint_block(base_lint, cand_lint, kind):
    """tests/test_lint_clean.py:194: the reference's 14-rule floor and
    its exact untracked-compile-input counter, kept for its records."""
    base = _doc(lint=dict(base_lint))
    assert regress.compare(_doc(lint=dict(LINT)), _doc(lint=dict(LINT))
                           )["ok"]
    assert regress.compare(_doc(lint=dict(LINT)), regress.normalize(RECORD)
                           )["ok"]
    assert regress.compare(_doc(lint=dict(LINT)), _doc(lint=dict(
        LINT, violations_by_rule={})))["ok"]
    cand = _doc(lint=cand_lint)
    assert any(f["kind"] == kind
               for f in regress.compare(base, cand)["regressions"])


def _load_block():
    return {"requests": 500, "served": 480, "shed": 15, "timeout": 5,
            "errors": 0, "overrun": 0, "shed_rate": 0.03,
            "timeout_rate": 0.01,
            "engineering": {"win": True, "off": {"p999_ms": 40.0},
                            "on": {"p999_ms": 20.0}},
            "phases": {
                "steady": {"p50_ms": 2.0, "p99_ms": 8.0, "p999_ms": 12.0,
                           "requests": 250, "worst_ms": 14.0,
                           "worst_trace": "0x0000000000abc",
                           "classes": {"high": {"p99_ms": 6.0,
                                                "count": 50}}},
                "burst": {"p50_ms": 3.0, "p99_ms": 15.0, "p999_ms": 25.0,
                          "requests": 250, "worst_ms": 30.0,
                          "worst_trace": "0x0000000000def",
                          "classes": {}}}}


def _set(block, path, fn):
    node = block
    for p in path[:-1]:
        node = node[p]
    if fn is None:
        node.pop(path[-1])
    else:
        node[path[-1]] = fn(node[path[-1]] if isinstance(node, list)
                            else node.get(path[-1]))
    return block


@pytest.mark.parametrize("path, fn, kind", [
    (("overrun",), lambda v: 2, "load-overrun"),
    (("engineering", "win"), lambda v: False, "load-engineering"),
    (("phases", "burst"), None, "missing-load-phase"),
    (("phases", "steady", "p999_ms"), lambda v: v * 2.5, "load-tail"),
    (("phases", "steady", "p999_ms"), lambda v: v * 1.5, None),
    (("phases", "steady", "classes", "high", "p99_ms"), lambda v: v * 2.5,
     "load-tail"),
    (("phases", "steady", "worst_trace"), lambda v: None, "load-exemplar"),
])
def test_load_rules(path, fn, kind):
    """tests/test_loadgen.py:332: each rule flags; within-tolerance
    open-loop weather does not."""
    base = _doc(load=_load_block())
    assert regress.compare(base, _doc(load=_load_block()))["ok"]
    assert ("missing-load-block", "load") in _kinds(
        regress.compare(base, _doc()))
    assert regress.compare(base, regress.normalize(RECORD))["ok"]
    res = regress.compare(base, _doc(load=_set(_load_block(), path, fn)))
    if kind is None:
        assert res["ok"]
    else:
        assert kind in {f["kind"] for f in res["regressions"]}


def test_closed_loop_annotation_guards():
    """tests/test_loadgen.py:378: closed- and open-loop percentiles are
    never compared like for like."""
    base = regress.normalize({"legs": {}, "metrics": {"serve_p99_ms": 10.0}})
    cand = regress.normalize({"legs": {}, "metrics": {
        "serve_p99_ms": 100.0, "serve_closed_loop": 1.0}})
    assert regress.compare(base, cand)["ok"]
    cand2 = regress.normalize({"legs": {}, "metrics": {"serve_p99_ms": 100.0}})
    assert ("serve-latency", "serve_p99_ms") in _kinds(
        regress.compare(base, cand2))

    def fleet(p99, closed_loop=None):
        fl = {"hung_futures": 0,
              "priority": {"high": {"p99_ms": p99, "shed_rate": 0.0}}}
        if closed_loop is not None:
            fl["closed_loop"] = closed_loop
        return regress.normalize({"legs": {}, "fleet": fl})

    assert regress.compare(fleet(10.0), fleet(100.0, closed_loop=True))["ok"]
    assert ("fleet-latency", "high:p99_ms") in _kinds(
        regress.compare(fleet(10.0), fleet(100.0)))


@pytest.mark.parametrize("change, key", [
    ({"fallbacks": 2.0}, "fallbacks"),
    ({"tuned_beats_default": False}, "tuned_beats_default"),
    ({"replay_ok": False}, "replay_ok"),
])
def test_kernel_infer_rules(change, key):
    """tests/test_traverse_kernel.py:312; in interpret mode beats-default
    is timer noise and not judged, replay_ok still is."""
    block = {"fallbacks": 0.0, "tuned_beats_default": True,
             "replay_ok": True, "legs": []}
    base = regress.normalize({"legs": {}, "kernel_infer": dict(block)})
    assert regress.compare(base, regress.normalize(
        {"legs": {}, "kernel_infer": dict(block)}))["ok"]
    assert ("missing-kernel-infer-block", "kernel_infer") in _kinds(
        regress.compare(base, regress.normalize({"legs": {}})))
    assert not any(f["kind"] == "missing-kernel-infer-block"
                   for f in regress.compare(
                       base, regress.normalize(RECORD))["regressions"])
    res = regress.compare(base, regress.normalize(
        {"legs": {}, "kernel_infer": dict(block, **change)}))
    assert key in {f["key"] for f in res["regressions"]}
    ib = dict(block, interpret=True)
    res_i = regress.compare(
        regress.normalize({"legs": {}, "kernel_infer": dict(ib)}),
        regress.normalize({"legs": {}, "kernel_infer": dict(ib, **change)}))
    judged = key != "tuned_beats_default"
    assert (key in {f["key"] for f in res_i["regressions"]}) == judged


def test_annotation_fields_neither_crash_nor_flag():
    """tests/test_obs_forensics.py:329: a string metric (a trace-id
    exemplar) is an annotation, not a load number."""
    doc = {"value": 1.0, "timed_pass_walls": [1.0],
           "legs": {"serving": {"seconds": 1.0, "seconds_per_pass": [1.0]}},
           "metrics": {"serve_p50_ms": 2.0,
                       "serve_worst_trace": "0x21bd608200001"}}
    base = regress.normalize(doc)
    assert "serve_worst_trace" not in base["metrics"]
    assert base["metrics"]["serve_p50_ms"] == 2.0
    cand = json.loads(json.dumps(doc))
    cand["metrics"]["serve_worst_trace"] = "0xdeadbeef00000"
    res = regress.compare(base, regress.normalize(cand))
    assert res["ok"], res["regressions"]


# --------------------------------------------- (c) the torch-smoke record
KERNELS = ("forest_traverse", "hist_accumulate", "split_scan",
           "row_weights", "feature_mask")
PATHS = ("serving", "tuning", "fit", "selection", "chunked", "endpoint",
         "dispatch", "fleet", "multirank", "multirank_tuning", "pandas")
PHASES = {"02 build": 11.2, "03 kernels": 4.8, "08 fit": 9.5,
          "10 tuning": 21.0, "13 chunked": 25.1, "21 fleet": 18.5,
          "22 multirank": 61.0, "25 lint": 6.4, "26 pandas": 22.7}
CPU = {"model": "AMD EPYC 7R13 Processor", "count": 8}


def _kernel(rng, name) -> dict:
    ms = lambda: float(rng.uniform(0.005, 0.5))  # noqa: E731
    k = {"name": name, "route": "cuda",
         "device_windows": {f"{name} main": {"want": 100, "seen": [96]}},
         "source": f"sml_tpu_torch/csrc/{name}.cu",
         "replaces": "sml_tpu/native/hist_kernel.py:128",
         "launches_by_path": {p: int(rng.integers(1, 3000)) for p in PATHS},
         "max_abs_err": 0.0, "ms": ms(), "device_ms": ms(),
         "plain_ms": ms() * 1e3, "bound_ms": ms() / 1e3, "bound_by": "bytes",
         "library_ms": None, "shape": f"{name} main shape"}
    k["launches"] = sum(k["launches_by_path"].values())
    return k


def _smoke_blocks(seed=0) -> dict:
    """Blocks with the keys chip_smoke.py prints, seeded: ints as dict
    keys and tuples where the script builds them."""
    rng = np.random.default_rng([seed, 5])
    u = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
    kernels = [_kernel(rng, name) for name in KERNELS]
    ft, hist = kernels[0], kernels[1]
    ft["launches_by_path"]["fleet"] = 1669
    ft["replay_launches"] = 1
    ft["replay"] = {"ms": u(0.05, 0.2), "device_ms": None,
                    "device_seen": "44/50"}
    ft["launches_by_rows"] = {"<=64": 96, "65-4096": 3, ">4096": 2}
    ft["by_rows"] = {n: {"ms": u(0.05, 0.2), "device_ms": u(0.005, 0.02),
                         "bound_by": "bytes"} for n in (64, 4096, 100_000)}
    hist["device_ms"] = None
    hist["deterministic"] = True
    hist["ml11"] = {"ms": u(0.05, 0.2), "device_ms": u(0.02, 0.03),
                    "shape": "ML 11"}
    hist["f64_out"] = {"max_abs_err": 0.0, "40000x16": {
        "ms": u(0.05, 0.2), "device_ms": u(0.01, 0.03), "max_abs_err": 0.0,
        "f32_out": {"ms": u(0.05, 0.2), "device_ms": u(0.01, 0.03)}}}
    kernels[3]["one_round"] = {"ML 07 RF": {"ms": u(0.1, 0.2),
                                            "device_ms": u(0.001, 0.01),
                                            "rows_per_thread": 1}}
    runs = lambda k: [{"fit_ms": u(200, 600), "loop_ms": u(100, 400)}  # noqa
                      for _ in range(k)]
    report = {"requests": 1720, "served": 1706, "shed": 14, "timeout": 0,
              "errors": 0, "overrun": 0, "phases": {
                  ph: {"p50_ms": u(3, 14), "p99_ms": u(8, 40),
                       "p999_ms": u(10, 45), "requests": 300,
                       "worst_trace": None,
                       "classes": {c: {"p50_ms": u(3, 14),
                                       "p99_ms": u(8, 40),
                                       "p999_ms": u(10, 45), "count": 60}
                                   for c in ("high", "normal", "low")}}
                  for ph in ("steady", "burst", "steady2")}}
    wall = lambda k: [u(200, 3000) for _ in range(k)]  # noqa: E731
    launches = {k: int(rng.integers(0, 500)) for k in KERNELS}
    return {
        "tuning": {"launches_fused": dict(launches),
                   "walls_ms": {"fused": runs(3), "sequential": runs(3),
                                "max_fused_5": runs(1)},
                   "busy_ms": {"busy_ms": u(40, 60)},
                   "binning_ms_cpp_numpy": {"bin_with 4096": (u(2, 5),
                                                              u(2, 5))},
                   "selection": {"card": CARD, "a": {"best": (5, 10)}}},
        "chunked": {"e": {"rows": 4_194_304, "chunks": 32, "ingest": {
            2: {"sketch_s": u(5, 10), "wall_s": u(10, 12)},
            1: {"sketch_s": 0.001, "wall_s": u(1, 2)}},
            "order_head": [("dispatch", 0), ("dispatch", 1)],
            "pass2_device_bytes": 41_943_040, "compact_bytes": 41_943_040,
            "chunk_block_bytes": 1_310_720}, "launches": dict(launches)},
        "nontree": {"card": CARD, "tf32": False, "linear": {
            m: {"fit_ms": u(5, 40), "coefficients_bit_equal": True}
            for m in ("ml02", "ml03", "ridge")},
            "serving": {"serve": {"requests": 2000, "sheds": 0.0,
                                  "p50_ms": u(2, 4), "p99_ms": u(4, 6)}}},
        "timeseries": {"card": CARD, "dedup": {"count": 100_000,
                                               "hash": 972882115}},
        "featurizer": {"routes": {r: {"fits_bit_equal": True}
                                  for r in ("ml03_lr", "ml07_rf")},
                       "compact": {"linear_bit_equal": True,
                                   "below_gate": {"linear_bit_equal": True}},
                       "batches": {
                           "lr_factorized": {
                               "next_dispatch_before_drain": None},
                           "rf_block": {"next_dispatch_before_drain": True}},
                       "launches": dict(launches)},
        "registry": {"endpoint": {
            "burst": {"p50_ms": u(4, 6), "p99_ms": u(6, 8), "requests": 96},
            "canary_off": {"p50_ms": u(4, 6), "p99_ms": u(6, 9)},
            "canary_1.0": {"p50_ms": u(4, 6), "p99_ms": u(6, 9),
                           "errors": 0},
            "sheds": 0}},
        "dispatch": {"calibration": {"preroute": "device",
                                     "reason": "local-chip"},
                     "saturation": {"fallback_on": {"shed": 0},
                                    "fallback_off": {"shed": 87}},
                     "recorder": {"on": {"dropped": 0}},
                     "prewarm": {"on": {"prewarm": {"failed": 0}}}},
        "dataplane": {"card": CARD, "a": {"install_ms": u(1000, 2000)}},
        "observed": {"card": CARD,
                     "b": {"iid": {"flagged": []},
                           "shift": {"flagged": ["f9"], "psi": u(5, 7)}},
                     "d": {"verdicts": {i: ["f9"] if i == 5 else []
                                        for i in range(8)}},
                     "f": {"default_reasons": ["local-chip"]}},
        "fleet": {"card": CARD,
                  "b": {"report": report,
                        "counters": {"fleet.shed.high": 0.0,
                                     "load.timeout": 0.0,
                                     "load.overrun": 0.0}},
                  "c": {"replay": {"timeout": 0, "errors": 0,
                                   "overrun": 0}},
                  "d": {"cycles": [
                      {"action": "accumulate", "passed": None,
                       "checks": None},
                      {"action": "refit", "passed": True,
                       "checks": {"mirrored": True, "quality": True}},
                      {"action": "rollback", "passed": False,
                       "checks": {"mirrored": True, "quality": False}}]}},
        "multirank": {"card": CARD, "launches": dict(launches),
                      "1xnccl xgb": {
                          "wall_ms": wall(1),
                          "collectives": {"collective.psum": 281.0,
                                          "collective.psum_bytes":
                                          19_722_256.0},
                          "mesh": "Mesh(ranks=(0,), backend=nccl)"},
                      "4xgloo 2 groups xgb": {
                          "wall_ms": wall(4),
                          "collectives": {"collective.psum.dcn": 280.0,
                                          "collective.psum_bytes.dcn":
                                          9_861_120.0}},
                      "launch_s 4xgloo": u(10, 30)},
        "multirank_tuning": {
            "card": CARD, "launches": dict(launches),
            "1xnccl grid rows": {"width": 1, "wall_ms": wall(1),
                                 "psum": 121, "psum_bytes": 37_048_512,
                                 "all_gather_bytes": 0},
            "4xgloo grid auto": {"width": 4, "wall_ms": wall(4), "psum": 0,
                                 "psum_bytes": 0,
                                 "all_gather_bytes": 75_612},
            "1xnccl ranks": [{"backend": "nccl", "local_sync": True}]},
        "multirank_nontree": {
            "card": CARD, "1xnccl ml02": {"psum_calls": 1.0,
                                          "psum_bytes": 64.0,
                                          "dcn_bytes": None,
                                          "wall_ms": wall(1)}},
        "lint": {"rules": 11, "files": 138, "suppressed_pragma": 141,
                 "suppressed_baseline": 3, "wall_s": u(5, 8),
                 "python": "3.12.3", "card": CARD,
                 "forbidden_imported": []},
        "pandas": {"pandas": True, "a": {"loaded": [],
                                         "koalas_is_port": True},
                   "b": {"alias_moves_key": True},
                   "launches": dict(launches), "card": CARD},
        "dataframe": {"launches_fit": dict(launches),
                      "rmse": {"dt": u(60, 70)}},
        "host_routes": [{"name": "forest_host",
                         "calls_by_path": {"dispatch": 90,
                                           "endpoint_canary": 120},
                         "bit_equal_to_card": True,
                         "by_rows": {64: {"host_ms": u(0.2, 0.5)}},
                         "card": CARD}],
        "kernels": kernels,
    }


def _meta(**over) -> dict:
    meta = {"card": CARD, "host_cpu": dict(CPU),
            "versions": {"torch": "2.11.0+cu128", "cuda": "12.8",
                         "python": "3.12.3"},
            "commit": None, "seed": 0, "phases": dict(PHASES),
            "wall_s": 612.5,
            "proofs": {"multirank.trees_equal_one_card": True,
                       "pandas.handouts_equal_score_block": True,
                       "ok": True}}
    meta.update(over)
    return meta


def _record(seed=0, **meta) -> dict:
    return regress.record_from_blocks(_smoke_blocks(seed), _meta(**meta))


def _cmp(base_doc, cand_doc, min_tol=regress.MIN_TOL):
    return regress.compare(regress.normalize(base_doc),
                           regress.normalize(cand_doc), min_tol)


def _changed(doc, *path, fn):
    doc = json.loads(json.dumps(doc))
    _set(doc, path, fn)
    return doc


def test_record_is_json_as_printed_and_keeps_its_keys():
    blocks, meta = _smoke_blocks(), _meta()
    rec = regress.record_from_blocks(blocks, meta)
    assert rec == json.loads(json.dumps(rec))
    assert rec["shape"] == regress.SMOKE_SHAPE
    assert set(rec) == set(regress.META_KEYS) | set(blocks)
    for name, block in blocks.items():
        assert rec[name] == json.loads(json.dumps(block))
    assert rec["kernels"][0]["by_rows"]["64"]["bound_by"] == "bytes"
    assert rec["observed"]["d"]["verdicts"]["5"] == ["f9"]
    assert rec["chunked"]["e"]["order_head"][0] == ["dispatch", 0]
    assert rec["host_cpu"] == CPU and rec["commit"] is None
    with pytest.raises(ValueError):
        regress.record_from_blocks(dict(blocks, card={}), meta)
    with pytest.raises(ValueError):
        regress.record_from_blocks(blocks, dict(meta, host="x"))


def test_smoke_self_compare_is_clean():
    rec = _record()
    res = _cmp(rec, rec)
    assert res["ok"] and res["improvements"] == []
    assert res["not_comparable"] == []
    norm = regress.normalize(rec)
    assert res["checked"] > sum(len(f) for f in norm["families"].values())
    # the multi-rank phases' walls are information, the others legs
    assert "phase 22 multirank" not in norm["legs"]
    assert norm["legs"]["phase 10 tuning"]["seconds"] == PHASES["10 tuning"]
    assert norm["legs"]["tuning fused fit_ms"]["passes"]
    assert norm["legs"]["tuning max_fused_5 fit_ms"]["passes"] == []
    assert "kernel forest_traverse by_rows.64 device_ms" in norm["legs"]
    assert "kernel hist_accumulate device_ms" not in norm["legs"]
    assert "kernel forest_traverse replay ms" in norm["legs"]
    assert "kernel forest_traverse replay device_ms" not in norm["legs"]
    assert regress.normalize(rec) == regress.normalize(
        json.loads(json.dumps(rec)))


def _injections():
    import chip_smoke
    return chip_smoke.rg_injections(regress)


@pytest.mark.parametrize("label", [label for label, _ in _injections()])
def test_phase_27_injection_gives_exactly_its_finding(label):
    change = dict(_injections())[label]
    rec = _record()
    doc = json.loads(json.dumps(rec))
    want = change(doc)
    assert want is not False
    res = _cmp(rec, doc)
    assert _kinds(res) == ([want] if want else [])
    assert res["improvements"] == [] and res["not_comparable"] == []


def test_phase_27_injections_on_the_smaller_record():
    """`--only 27`: lint and pandas alone; what the record lacks is
    skipped, the rest still gives exactly its finding."""
    rec = regress.record_from_blocks(
        {k: v for k, v in _smoke_blocks().items() if k in ("lint", "pandas")},
        _meta(phases={"02 build": 11.0, "25 lint": 6.0, "26 pandas": 20.0}))
    skipped = []
    for label, change in _injections():
        doc = json.loads(json.dumps(rec))
        want = change(doc)
        if want is False:
            skipped.append(label)
            continue
        assert _kinds(_cmp(rec, doc)) == ([want] if want else []), label
    assert len(skipped) == 3


@pytest.mark.parametrize("path, fn, kind", [
    (("phases", "10 tuning"), lambda v: v * 0.7, "leg-wall"),
    (("kernels", 1, "launches_by_path", "fit"), lambda v: v - 1,
     "kernel-launches"),
    (("multirank_tuning", "1xnccl grid rows", "psum_bytes"),
     lambda v: v * 0.5, "multirank-collective"),
    (("registry", "endpoint", "burst", "p50_ms"), lambda v: v / 3,
     "serve-latency"),
    (("chunked", "e", "ingest", "2", "wall_s"), lambda v: v / 2,
     "scale-throughput"),
])
def test_an_improvement_is_listed_as_one(path, fn, kind):
    rec = _record()
    res = _cmp(rec, _changed(rec, *path, fn=fn))
    assert res["ok"] and [f["kind"] for f in res["improvements"]] == [kind]


@pytest.mark.parametrize("path, factor, flags", [
    (("kernels", 0, "launches_by_path", "fleet"), 1.10, False),
    (("kernels", 0, "launches_by_path", "fleet"), 1.90, False),
    (("kernels", 0, "launches_by_path", "fleet"), 2.50, True),
    (("kernels", 0, "launches_by_path", "serving"), 1.50, False),
    (("kernels", 0, "launches_by_path", "endpoint"), 1.50, False),
    (("host_routes", 0, "calls_by_path", "dispatch"), 1.50, False),
    (("host_routes", 0, "calls_by_path", "dispatch"), 2.50, True),
    (("host_routes", 0, "calls_by_path", "endpoint_canary"), 1.01, True),
    (("kernels", 2, "launches_by_path", "selection"), 1.001, True),
])
def test_racy_paths_at_load_tol_the_rest_exact(path, factor, flags):
    rec = _record()
    res = _cmp(rec, _changed(rec, *path,
                             fn=lambda v: int(math.ceil(v * factor))))
    assert (not res["ok"]) == flags
    if flags:
        assert len(res["regressions"]) == 1
        assert res["regressions"][0]["kind"] in ("kernel-launches",
                                                 "host-route-calls")


@pytest.mark.parametrize("field, value", [
    ("card", "NVIDIA H100 80GB HBM3, 350.00 W"),
    ("card", "NVIDIA A100-SXM4-80GB, 400.00 W"),
    ("host_cpu", {"model": "Intel Xeon", "count": 8}),
    ("host_cpu", {"model": CPU["model"], "count": 32}),
])
def test_another_card_or_host_turns_off_the_walls_only(field, value):
    rec = _record()
    doc = _changed(rec, "phases", "10 tuning", fn=lambda v: v * 1.5)
    doc = _changed(doc, "registry", "endpoint", "burst", "p99_ms",
                   fn=lambda v: v * 3)
    doc = _changed(doc, "kernels", 1, "launches_by_path", "fit",
                   fn=lambda v: v + 1)
    doc = _changed(doc, "fleet", "c", "replay", "overrun",
                   fn=lambda v: v + 1)
    doc[field] = value
    res = _cmp(rec, doc)
    assert _kinds(res) == [("kernel-launches", "hist_accumulate:fit")]
    unjudged = {f["key"] for f in res["not_comparable"]}
    assert {"phase 10 tuning", "registry.endpoint.burst.p99_ms", "script",
            "kernel split_scan ms", "fleet.c.replay.overrun",
            "chunked.e.ingest.2:rows_per_s"} <= unjudged
    assert all(f["severity"] == "not-comparable"
               for f in res["not_comparable"])
    assert "not compared" in regress.render(res, "b", "c")
    same = dict(doc, **{field: rec[field]})
    assert {("leg-wall", "phase 10 tuning"),
            ("zero-count", "fleet.c.replay.overrun")} <= set(
        _kinds(_cmp(rec, same)))


@pytest.mark.parametrize("base_null, cand_null", [
    (False, True), (True, False), (True, True)])
def test_null_device_ms_is_absent(base_null, cand_null):
    rec = _record()
    base = _changed(rec, "kernels", 2, "device_ms",
                    fn=lambda v: None if base_null else v)
    cand = _changed(rec, "kernels", 2, "device_ms",
                    fn=lambda v: None if cand_null else v * 10)
    res = _cmp(base, cand)
    assert res["ok"] and res["improvements"] == []
    listed = [f["key"] for f in res["not_comparable"]]
    assert listed == (["kernel split_scan device_ms"]
                      if cand_null and not base_null else [])


@pytest.mark.parametrize("path, fn, finding", [
    (("kernels", 0, "max_abs_err"), lambda v: 1e-7,
     ("kernel-error", "forest_traverse:max_abs_err")),
    (("kernels", 1, "f64_out", "40000x16", "max_abs_err"), lambda v: 2.0,
     ("kernel-error", "hist_accumulate:f64_out.40000x16.max_abs_err")),
    (("kernels", 1, "deterministic"), lambda v: False,
     ("proof", "kernels.hist_accumulate.deterministic")),
    (("host_routes", 0, "bit_equal_to_card"), lambda v: False,
     ("proof", "host_routes.forest_host.bit_equal_to_card")),
    (("featurizer", "compact", "below_gate", "linear_bit_equal"), None,
     ("proof", "featurizer.compact.below_gate.linear_bit_equal")),
    (("fleet", "d", "cycles", 1, "checks", "quality"), lambda v: False,
     ("proof", "fleet.d.cycles.1.checks.quality")),
    (("proofs", "multirank.trees_equal_one_card"), lambda v: False,
     ("proof", "proofs.multirank.trees_equal_one_card")),
    (("dispatch", "calibration", "reason"), lambda v: "forced-mode",
     ("dispatch-decision", "dispatch.calibration.reason")),
    (("observed", "f", "default_reasons"), lambda v: v + ["slow-link"],
     ("dispatch-decision", "observed.f.default_reasons")),
    (("fleet", "b", "report", "timeout"), lambda v: 2,
     ("zero-count", "fleet.b.report.timeout")),
    (("fleet", "b", "counters", "fleet.shed.high"), lambda v: 1.0,
     ("zero-count", "fleet.b.counters.fleet.shed.high")),
    (("registry", "endpoint", "sheds"), lambda v: 3,
     ("zero-count", "registry.endpoint.sheds")),
    (("dispatch", "prewarm", "on", "prewarm", "failed"), lambda v: 1,
     ("zero-count", "dispatch.prewarm.on.prewarm.failed")),
    (("registry", "endpoint", "canary_off", "p99_ms"), lambda v: v * 1.6,
     ("serve-latency", "registry.endpoint.canary_off.p99_ms")),
    (("fleet", "b", "report", "phases", "steady", "classes", "low",
      "p999_ms"), lambda v: v * 2.5, ("load-tail", "steady:low:p999_ms")),
    (("chunked", "e", "ingest", "1", "wall_s"), lambda v: v * 1.3,
     ("scale-throughput", "chunked.e.ingest.1:rows_per_s")),
    (("chunked", "e", "pass2_device_bytes"), lambda v: v + (20 << 20),
     ("device-bytes-limit", "chunked.e.pass2_device_bytes")),
    (("observed", "b", "shift", "flagged"), lambda v: ["f9", "f2"],
     ("drift-detection", "observed.b.shift.flagged")),
    (("observed", "b", "iid", "flagged"), lambda v: ["f0"],
     ("drift-false-positive", "observed.b.iid.flagged")),
    (("observed", "d", "verdicts", "3"), lambda v: ["f9"],
     ("drift-false-positive", "observed.d.verdicts.3")),
    (("multirank", "4xgloo 2 groups xgb", "collectives",
      "collective.psum_bytes.dcn"), lambda v: v * 2,
     ("multirank-collective",
      "multirank/4xgloo 2 groups xgb/collective.psum_bytes.dcn")),
    (("multirank_tuning", "4xgloo grid auto", "psum"), lambda v: 1,
     ("multirank-collective", "multirank_tuning/4xgloo grid auto/psum")),
    (("multirank_nontree", "1xnccl ml02", "psum_bytes"), None,
     ("missing-collective", "multirank_nontree/1xnccl ml02/psum_bytes")),
    (("lint", "violations"), lambda v: 1,
     ("lint-violations", "violations")),
    (("lint", "forbidden_imported"), lambda v: ["torch"],
     ("lint-imports", "forbidden_imported")),
    (("kernels", 3), None, ("missing-kernel", "kernels/row_weights")),
    (("host_routes", 0), None,
     ("missing-host-route", "host_routes/forest_host")),
    (("phases", "08 fit"), None, ("missing-phase", "phases/08 fit")),
    (("kernels", 4, "launches_by_path", "pandas"), None,
     ("missing-path", "feature_mask:pandas")),
    (("kernels", 0, "by_rows", "4096"), None,
     ("missing-leg", "kernel forest_traverse by_rows.4096 ms")),
    (("fleet", "b", "report", "phases", "steady2"), None,
     ("missing-load-phase", "fleet/load/steady2")),
    (("fleet",), None, ("missing-block", "fleet")),
])
def test_each_smoke_rule_gives_its_finding(path, fn, finding):
    rec = _record()
    doc = json.loads(json.dumps(rec))
    if path[0] in ("kernels", "host_routes") and len(path) == 2:
        doc[path[0]].pop(path[1])
    else:
        _set(doc, path, fn)
    res = _cmp(rec, doc)
    assert _kinds(res) == [finding]


def test_lint_floor_and_shrink_each_once():
    rec = _record()
    at_ten = _changed(rec, "lint", "rules", fn=lambda v: 10)
    assert _kinds(_cmp(rec, at_ten)) == [("lint-rule-floor", "rules")]
    assert _kinds(_cmp(at_ten, at_ten)) == [("lint-rule-floor", "rules")]
    twelve = _changed(rec, "lint", "rules", fn=lambda v: 12)
    assert _kinds(_cmp(twelve, rec)) == [("lint-rules", "rules")]
    assert _cmp(rec, twelve)["ok"]


def test_wall_tolerance_reads_the_turns():
    """A wall timed in turns is judged at its runs' spread (capped at
    TOL_CAP, never under min_tol); one with no passes at
    max(TOL_CAP, min_tol)."""
    rec = _record()
    for i, r in enumerate(rec["tuning"]["walls_ms"]["fused"]):
        r["fit_ms"] = 100.0 * (1.0 + 0.06 * i)   # a 12% spread

    def fused(factor):
        return _changed(rec, "tuning", "walls_ms", "fused", fn=lambda rs: [
            dict(r, fit_ms=r["fit_ms"] * factor) for r in rs])

    assert _cmp(rec, fused(1.10))["ok"]
    assert ("leg-wall", "tuning fused fit_ms") in _kinds(
        _cmp(rec, fused(1.14)))
    assert _cmp(rec, fused(1.14), min_tol=0.2)["ok"]
    for factor, flags in ((1.17, False), (1.19, True)):
        doc = _changed(rec, "phases", "03 kernels", fn=lambda v: v * factor)
        assert (("leg-wall", "phase 03 kernels") in _kinds(
            _cmp(rec, doc))) == flags
        assert _cmp(rec, doc, min_tol=0.5)["ok"]


def test_shapes_are_never_mixed():
    rec = _record()
    for other in (_sidecar(0), _driver_record(0)):
        for a, b in ((rec, other), (other, rec)):
            res = _cmp(a, b)
            assert _kinds(res) == [("record-shape", "shape")]
            assert res["checked"] == 0


def test_smoke_verdicts_render_and_mark_the_trace():
    rec = _record()
    doc = _changed(rec, "kernels", 1, "launches_by_path", "fit",
                   fn=lambda v: v + 1)
    res = _cmp(rec, doc)
    text = regress.render(res, "base.json", "cand.json")
    assert text.splitlines()[-1] == "verdict: REGRESSED"
    assert "kernel-launches" in text and "hist_accumulate:fit" in text
    marks = regress.trace_events(res)
    assert [m["args"]["key"] for m in marks] == ["hist_accumulate:fit"]
    assert regress.render(_cmp(rec, rec), "a", "a").splitlines()[-1] == \
        "verdict: OK"


def test_phase_27_rehearsed_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 27 on a synthetic record, whole and as
    `--only 27` gives it: every check passes, the CLI included."""
    import chip_smoke
    rec = _record()
    path = str(tmp_path / "record.json")
    chip_smoke.write_record(rec, path)
    out = chip_smoke.phase_regress(rec, path, "cpu")
    assert out["skipped"] == [] and len(out["injections"]) == 8
    assert out["self_checks"] > 150
    small = regress.record_from_blocks(
        {k: v for k, v in _smoke_blocks().items() if k in ("lint", "pandas")},
        _meta(phases={"02 build": 11.0, "25 lint": 6.0, "26 pandas": 20.0}))
    chip_smoke.write_record(small, path)
    out = chip_smoke.phase_regress(small, path, "cpu")
    assert len(out["skipped"]) == 3 and len(out["injections"]) == 5
    assert os.listdir(tmp_path) == ["record.json"]


def test_host_cpu_and_commit_read_this_machine():
    import chip_smoke
    cpu = chip_smoke.host_cpu()
    assert cpu["count"] >= 1 and isinstance(cpu["model"], (str, type(None)))
    commit = chip_smoke.git_commit()
    assert commit is None or re.fullmatch(r"[0-9a-f]{40}", commit)


# ------------------------------------------- (d) the CLI, standalone
def _run_diff(*args):
    return subprocess.run([sys.executable, DIFF, *args], capture_output=True,
                          text=True, timeout=120, cwd=REPO)


PROBE = """
import json, runpy, sys
sys.argv = [{diff!r}] + {args!r}
try:
    runpy.run_path({diff!r}, run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
bad = sorted(k for k in sys.modules if k.split(".")[0] in {forbidden!r})
print(json.dumps({{"rc": rc, "bad": bad}}), file=sys.stderr)
"""


def _probe(*args):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(diff=DIFF, args=list(args),
                                            forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    return proc, json.loads(proc.stderr.strip().splitlines()[-1])


def test_cli_exit_status_is_the_verdict_and_imports_nothing(tmp_path):
    rec = _record()
    base, cand = tmp_path / "base.json", tmp_path / "cand.json"
    base.write_text(json.dumps(rec))
    cand.write_text(json.dumps(_changed(
        rec, "kernels", 1, "launches_by_path", "fit", fn=lambda v: v + 1)))
    proc, child = _probe(str(base), "--json")
    assert child == {"rc": 0, "bad": []}, proc.stderr
    got = json.loads(proc.stdout)
    assert got["ok"] and got["regressions"] == [] and got["checked"] > 0
    proc, child = _probe(str(base), str(cand))
    assert child == {"rc": 1, "bad": []}
    assert "REGRESSION" in proc.stdout and "hist_accumulate:fit" in proc.stdout
    assert proc.stdout.splitlines()[-1] == "verdict: REGRESSED"


def test_cli_trace_and_min_tol(tmp_path):
    rec = _record()
    base, cand = tmp_path / "base.json", tmp_path / "cand.json"
    base.write_text(json.dumps(rec))
    cand.write_text(json.dumps(_changed(rec, "phases", "10 tuning",
                                        fn=lambda v: v * 1.3)))
    out = tmp_path / "verdicts.json"
    proc = _run_diff(str(base), str(cand), "--trace", str(out))
    assert proc.returncode == 1
    trace = json.loads(out.read_text())
    assert trace["otherData"]["producer"] == "scripts/torch_bench_diff.py"
    assert [e["args"]["key"] for e in trace["traceEvents"]] == [
        "phase 10 tuning"]
    proc = _run_diff(str(base), str(cand), "--min-tol", "0.4", "--json")
    assert proc.returncode == 0 and json.loads(proc.stdout)["ok"]
