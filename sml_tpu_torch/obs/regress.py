"""sml_tpu_torch.obs.regress — noise-aware comparison of two run records.

The port's copy of `sml_tpu/obs/regress.py`. `normalize` reads three
shapes of record:

- the JAX package's `bench_legs.json` sidecar and its `BENCH_r0x` /
  `MULTICHIP_r0x` driver records, judged by the JAX package's rules
  unchanged (per-leg walls at a noise-aware tolerance, engine counters,
  multichip and multihost collective statics, the kernelbench blocks,
  serving percentiles, the ct / fleet / load / drift / scale / lint
  blocks and their coverage);
- the port's run record, shape "torch-smoke": the JSON blocks
  `chip_smoke.py` prints, keyed as printed, beside the card, the host
  CPU, the versions, the commit, the seed and each phase's wall
  (`record_from_blocks`; `chip_smoke.py --record PATH` writes one).

`compare` judges a torch-smoke candidate against a torch-smoke base by
the same families of rules, applied to the port's blocks:

- **walls**: each phase's wall (the multi-rank phases' excepted: their
  ranks share one card, so their walls are information), the script's,
  the tuning phase's fits timed in turns (the turns are the passes) and
  each kernel's `ms` / `device_ms` at each shape, judged as the
  reference judges a leg; a wall with no passes at
  max(TOL_CAP, min_tol). Walls, and every other number read off a
  clock (the ingest's rows/s, request percentiles), are judged only when
  both records name the same card, power limit and host CPU; otherwise
  they are listed in `not_comparable`, never as a regression. A
  `device_ms` of null (not measured) is absent;
- **launches**: each kernel's launches on each path and the host
  route's calls on each path: any growth on a deterministic path is a
  regression, the racy paths (`RACY_PATHS`) are judged at LOAD_TOL;
- **collectives**: the `multirank*` blocks' collective calls and bytes
  per layout, at STATIC_TOL;
- **proofs**: a boolean proof true in the base stays true
  (`PROOF_PATHS`), each dispatch decision stays what it was
  (`DECISION_PATHS`: "local-chip"), a kernel's `max_abs_err` does not
  grow from 0, and the counts of `ZERO_KEYS` (overruns, timeouts,
  errors, sheds, a shed of the top class) do not grow from 0 (those
  read off the host's clock, `LATE_KEYS`, on the same machine only);
- **load and serving**: the registry's p50 / p99 at SERVE_TOL, the
  fleet's open-loop p50 / p99 / p99.9 by phase and class at LOAD_TOL
  (same machine only);
- **data plane**: the chunked ingest's rows/s at the capped tolerance
  (a wall: same machine only), pass 2's device bytes under their limit;
- **drift**: the shifted feature flagged alone, no iid window or chunk
  flagged;
- **lint**: at least SMOKE_LINT_RULE_FLOOR rules, no new violation, no
  forbidden module imported;
- **coverage**: a phase, block, kernel, path, layout or proof in the
  base and missing from the candidate is a regression (once: the
  entries of a missing block, kernel or phase are not listed again).

STDLIB-ONLY and free of the port's imports: `scripts/torch_bench_diff.py`
loads this file by path, so the gate runs in milliseconds without torch.
`obs.annotate_regressions(findings)` lands verdicts in the flight
recorder for trace rendering.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

#: floor for the wall-clock tolerance: best-of-N runs on a shared host
#: are never comparable tighter than this
MIN_TOL = 0.05
#: cap: recorded noise may WIDEN the tolerance only this far, so a >=20%
#: wall regression is flagged regardless of how noisy either run was
TOL_CAP = 0.18
#: serving p50/p99 are load numbers (contention-dependent); judge loosely
SERVE_TOL = 0.50
#: open-loop trace tails are noisier still — the driver charges every
#: scheduler hiccup of a shared (possibly 1-core) bench box to the
#: percentiles by design, so honest p99.9s swing well past SERVE_TOL
#: run-to-run; only a >2x tail move is evidence and not weather
LOAD_TOL = 1.00
#: per-trace collective statics are deterministic; 1% covers rounding
STATIC_TOL = 0.01
#: byte-volume counters (H2D, psum payload) below this are noise
BYTES_FLOOR = 1 << 20
#: absolute floor of the JAX package's graftlint catalogue — its
#: distributed-semantics pass took the active rule count to 14; a
#: candidate below it dropped an invariant rule even if its base record
#: predates the pass
LINT_RULE_FLOOR = 14

#: per-leg engine counters the sentry judges, with their growth bound:
#: ("count", slack) = cand may exceed base by max(1, slack*base);
#: ("bytes", rel) = cand may exceed base by rel (volumes >= BYTES_FLOOR);
#: ("exact", _) = ANY growth flags (kernel fallbacks: a fit silently
#: degrading from the pallas path to XLA is a perf regression even by 1)
COUNTER_CHECKS = {
    "compile.programs": ("count", 0.0),
    "tree.fit_dispatch": ("count", 0.0),
    "kernel.fallback": ("exact", 0.0),
    "staging.h2d_bytes": ("bytes", 0.25),
    "staging.d2h_bytes": ("bytes", 0.25),
    "collective.psum_bytes": ("bytes", STATIC_TOL),
}

_TAIL_LEG = re.compile(r"^\s+([A-Za-z_]\w*)\s+([0-9.]+)s\s*$")

#: the shape of the port's run record (`record_from_blocks`)
SMOKE_SHAPE = "torch-smoke"
#: the port's lint has 11 rules: the JAX package's 14 less
#: donation-after-use, untracked-compile-input and unsharded-device-put,
#: which mean nothing for eager torch (ROADMAP.md section 1)
SMOKE_LINT_RULE_FLOOR = 11
#: launch and call paths whose counts follow a race, judged at LOAD_TOL:
#: the micro-batcher's coalescing of concurrent requests (serving), the
#: promote under live clients (endpoint), the saturated queue's host
#: fallback (dispatch) and the open-loop load (fleet). Every other
#: path's count is exact
RACY_PATHS = ("serving", "endpoint", "dispatch", "fleet")
#: the run record's own keys; every other top-level key is a block
META_KEYS = ("shape", "card", "host_cpu", "versions", "commit", "seed",
             "phases", "wall_s", "proofs")
#: phases whose walls are information only: their ranks share one card
INFO_PHASES = ("multirank", "multirank_tuning", "multirank_nontree")
#: boolean proofs, as paths into the record ("*" matches any key or
#: index; kernels and host routes are keyed by name): true in the base,
#: each must stay true
PROOF_PATHS = (
    ("proofs", "*"),
    ("kernels", "*", "deterministic"),
    ("host_routes", "*", "bit_equal_to_card"),
    ("nontree", "linear", "*", "coefficients_bit_equal"),
    ("featurizer", "routes", "*", "fits_bit_equal"),
    ("featurizer", "compact", "linear_bit_equal"),
    ("featurizer", "compact", "below_gate", "linear_bit_equal"),
    ("featurizer", "batches", "*", "next_dispatch_before_drain"),
    ("fleet", "d", "cycles", "*", "passed"),
    ("fleet", "d", "cycles", "*", "checks", "*"),
    ("pandas", "a", "koalas_is_port"),
    ("pandas", "b", "alias_moves_key"),
)
#: dispatch decisions on the card: each stays what the base recorded
#: ("device" for "local-chip")
DECISION_PATHS = (
    ("dispatch", "calibration", "preroute"),
    ("dispatch", "calibration", "reason"),
    ("observed", "f", "default_reasons"),
)
#: counts that must not grow from 0, wherever a block carries them
ZERO_KEYS = ("overrun", "timeout", "errors", "sheds", "hung_futures",
             "failed", "dropped", "load.overrun", "load.timeout",
             "fleet.shed.high")
#: those of ZERO_KEYS read off the host's clock (a request started or
#: waiting past its deadline), judged like walls: on the same machine only
LATE_KEYS = ("overrun", "timeout", "load.overrun", "load.timeout")
#: pass 2 of the chunked ingest may add at most the compact matrix, two
#: chunk blocks and this many bytes of device memory
PASS2_SLACK_BYTES = 16 << 20


# ------------------------------------------------------------- normalization
def normalize(doc: dict) -> dict:
    """Any committed bench artifact -> one comparable shape:
    {value, pass_walls, legs: {name: {seconds, passes, counters}},
    metrics, multichip}. Understands the bench_legs.json sidecar and the
    BENCH_r0x driver record (headline + tail text), and the port's
    torch-smoke run record (`_normalize_smoke`)."""
    if doc.get("shape") == SMOKE_SHAPE:
        return _normalize_smoke(doc)
    if "legs" in doc and isinstance(doc["legs"], dict):
        legs = {}
        for name, leg in doc["legs"].items():
            legs[name] = {
                "seconds": float(leg["seconds"]),
                "passes": [float(x) for x in
                           (leg.get("seconds_per_pass") or [])],
                "counters": dict(leg.get("engine_counters") or {}),
            }
            for k in ("programs_compiled", "tree_fit_dispatches"):
                if k in leg:
                    legs[name]["counters"].setdefault(
                        {"programs_compiled": "compile.programs",
                         "tree_fit_dispatches": "tree.fit_dispatch"}[k],
                        float(leg[k]))
        return {
            "value": float(doc.get("value", 0.0)) or None,
            "pass_walls": [float(x) for x in
                           (doc.get("timed_pass_walls") or [])],
            "legs": legs,
            # non-numeric metric values are ANNOTATIONS, not perf
            # numbers (the serve_worst_trace trace-id exemplar):
            # skipped here so the sentry neither crashes on them nor
            # flags them as coverage drift
            "metrics": {k: float(v) for k, v in
                        (doc.get("metrics") or {}).items()
                        if isinstance(v, (int, float))},
            "multichip": doc.get("multichip"),
            "multihost": doc.get("multihost"),
            "kernel": doc.get("kernel"),
            "kernel_infer": doc.get("kernel_infer"),
            "scale": doc.get("scale"),
            "drift": doc.get("drift"),
            "lint": doc.get("lint"),
            "ct": doc.get("ct"),
            "fleet": doc.get("fleet"),
            "load": doc.get("load"),
            "shape": "sidecar",
        }
    # driver-record shape: {"parsed": {headline...}, "tail": "stdout..."}
    parsed = doc.get("parsed") or {}
    legs: Dict[str, dict] = {}
    metrics: Dict[str, float] = {}
    for line in str(doc.get("tail", "")).splitlines():
        m = _TAIL_LEG.match(line)
        if m:
            legs[m.group(1)] = {"seconds": float(m.group(2)),
                                "passes": [], "counters": {}}
            continue
        mm = re.match(r"^\s+([A-Za-z_]\w*)\s+([0-9.]+)\s*$", line)
        if mm:
            metrics[mm.group(1)] = float(mm.group(2))
    value = parsed.get("value")
    mc = doc.get("scaling") or doc.get("multichip")
    return {
        "value": float(value) if value is not None else None,
        "pass_walls": [float(x) for x in (parsed.get("pass_walls") or [])],
        "legs": legs,
        "metrics": metrics,
        "multichip": mc,
        "multihost": doc.get("multihost"),
        "kernel": doc.get("kernel"),
        "kernel_infer": doc.get("kernel_infer"),
        "scale": doc.get("scale"),
        "drift": doc.get("drift"),
        "lint": doc.get("lint"),
        "ct": doc.get("ct"),
        "fleet": doc.get("fleet"),
        "load": doc.get("load"),
        "shape": "record",
    }


def load(path: str) -> dict:
    with open(path) as f:
        return normalize(json.load(f))


# ----------------------------------------------------------------- comparison
def _spread(passes: List[float]) -> float:
    """Pass-to-pass relative spread (max/min - 1); 0 when unrecorded."""
    if not passes or min(passes) <= 0:
        return 0.0
    return max(passes) / min(passes) - 1.0


def _wall_tol(base_passes: List[float], cand_passes: List[float],
              min_tol: float) -> float:
    """`min_tol` is a HARD floor (an explicit --min-tol is always
    honored); only the noise-derived widening from recorded pass spreads
    is capped at TOL_CAP, so with the default floor a >=20% regression
    always flags."""
    noise = min(max(_spread(base_passes), _spread(cand_passes)), TOL_CAP)
    return max(min_tol, noise)


def _dig(doc, path):
    """Nested dict lookup along `path`, None on any miss — how the
    proof-flip rules address a block's interior fields."""
    cur = doc
    for p in path:
        cur = cur.get(p) if isinstance(cur, dict) else None
    return cur


def _finding(kind: str, key: str, base: float, cand: float, tol: float,
             severity: str, note: str = "") -> dict:
    ratio = (cand / base) if base else float("inf")
    return {"kind": kind, "key": key, "base": round(base, 4),
            "cand": round(cand, 4), "ratio": round(ratio, 4),
            "tol": round(tol, 4), "severity": severity, "note": note}


def compare(base: dict, cand: dict, min_tol: float = MIN_TOL) -> dict:
    """Judge `cand` (normalized) against `base`. Returns
    {ok, regressions, improvements, checked}; `ok` is False iff any
    regression was found. A torch-smoke record is judged by
    `_compare_smoke`, which adds `not_comparable`."""
    if SMOKE_SHAPE in (base.get("shape"), cand.get("shape")):
        return _compare_smoke(base, cand, min_tol)
    reg: List[dict] = []
    imp: List[dict] = []
    checked = 0

    # ---- per-leg wall clock
    for name, b in sorted(base["legs"].items()):
        c = cand["legs"].get(name)
        if c is None:
            reg.append(_finding("missing-leg", name, b["seconds"], 0.0,
                                0.0, "regression",
                                "leg present in base, absent in candidate"))
            continue
        checked += 1
        tol = _wall_tol(b["passes"], c["passes"], min_tol)
        rel = (c["seconds"] / b["seconds"] - 1.0) if b["seconds"] else 0.0
        if rel > tol:
            reg.append(_finding("leg-wall", name, b["seconds"],
                                c["seconds"], tol, "regression",
                                f"+{100 * rel:.1f}% vs tol "
                                f"{100 * tol:.0f}% (noise-aware)"))
        elif rel < -tol:
            imp.append(_finding("leg-wall", name, b["seconds"],
                                c["seconds"], tol, "improvement"))
        # ---- engine-counter deltas for the leg
        for key, (mode, slack) in COUNTER_CHECKS.items():
            bv = b["counters"].get(key)
            cv = c["counters"].get(key)
            if mode == "exact":
                # absence means zero, not "unjudgeable": legs only record
                # counters that fired, so the realistic regression is
                # exactly 0 (key absent in base) -> N (present in cand)
                bv = 0.0 if bv is None else bv
                cv = 0.0 if cv is None else cv
            if bv is None or cv is None:
                continue
            checked += 1
            if mode == "exact":
                if cv > bv:
                    reg.append(_finding(
                        "leg-counter", f"{name}:{key}", bv, cv, 0.0,
                        "regression",
                        "kernel fallback count grew — fits silently "
                        "degrading off the pallas path"))
                elif cv < bv:
                    imp.append(_finding("leg-counter", f"{name}:{key}",
                                        bv, cv, 0.0, "improvement"))
            elif mode == "count":
                bound = bv + max(1.0, slack * bv)
                if cv > bound:
                    reg.append(_finding(
                        "leg-counter", f"{name}:{key}", bv, cv, slack,
                        "regression",
                        "dispatch/compile count grew — the fusion/"
                        "prewarm contract"))
                elif cv < bv:
                    imp.append(_finding("leg-counter", f"{name}:{key}",
                                        bv, cv, slack, "improvement"))
            else:
                if max(bv, cv) >= BYTES_FLOOR and bv > 0 \
                        and cv > bv * (1.0 + slack):
                    reg.append(_finding(
                        "leg-counter", f"{name}:{key}", bv, cv, slack,
                        "regression", "byte volume grew"))

    # ---- suite total
    if base.get("value") and cand.get("value"):
        checked += 1
        tol = _wall_tol(base["pass_walls"], cand["pass_walls"], min_tol)
        rel = cand["value"] / base["value"] - 1.0
        if rel > tol:
            reg.append(_finding("suite-wall", "value", base["value"],
                                cand["value"], tol, "regression"))
        elif rel < -tol:
            imp.append(_finding("suite-wall", "value", base["value"],
                                cand["value"], tol, "improvement"))

    # ---- serving percentiles (load numbers: generous tolerance).
    # Closed- and open-loop percentiles are different quantities (the
    # coordinated-omission gap, docs/LOADGEN.md): records are judged
    # only when BOTH carry the same serve_closed_loop annotation — a
    # record that re-based onto intended arrivals is not comparable to
    # one that stamped send time
    _b_cl = base["metrics"].get("serve_closed_loop")
    _c_cl = cand["metrics"].get("serve_closed_loop")
    for key in ("serve_p50_ms", "serve_p99_ms"):
        bv, cv = base["metrics"].get(key), cand["metrics"].get(key)
        if bv and cv and _b_cl == _c_cl:
            checked += 1
            rel = cv / bv - 1.0
            if rel > SERVE_TOL:
                reg.append(_finding("serve-latency", key, bv, cv,
                                    SERVE_TOL, "regression"))
            elif rel < -SERVE_TOL:
                imp.append(_finding("serve-latency", key, bv, cv,
                                    SERVE_TOL, "improvement"))

    # ---- multichip scaling block (per-trace collective statics + walls)
    bmc, cmc = base.get("multichip"), cand.get("multichip")
    if bmc and cmc:
        cw = {int(e["devices"]): e for e in cmc.get("widths", [])}
        for e in bmc.get("widths", []):
            ce = cw.get(int(e["devices"]))
            if ce is None:
                continue
            w = int(e["devices"])
            checked += 1
            tol = max(TOL_CAP, min_tol)  # best-of-3, no recorded passes
            rel = ce["seconds"] / e["seconds"] - 1.0 if e["seconds"] else 0.0
            if rel > tol:
                reg.append(_finding("multichip-wall", f"{w}dev",
                                    e["seconds"], ce["seconds"], tol,
                                    "regression"))
            for key, slack in (("collective_psum", STATIC_TOL),
                               ("collective_psum_bytes", STATIC_TOL)):
                bv, cv = float(e.get(key, 0)), float(ce.get(key, 0))
                if bv > 0:
                    checked += 1
                    if cv > bv * (1.0 + slack):
                        reg.append(_finding(
                            "multichip-collective", f"{w}dev:{key}", bv,
                            cv, slack, "regression",
                            "per-trace collective static grew"))

    # ---- multihost scaling block (hierarchical-collective statics,
    # DCN-byte fractions, parity proofs, host-skew coverage)
    bmh, cmh = base.get("multihost"), cand.get("multihost")
    if bmh and not cmh and cand.get("shape") != "record":
        # coverage rule, like the kernel/scale blocks: bench.py carries
        # the block across plain suite runs, so a SIDECAR candidate
        # missing it actually lost the --multihost gate; BENCH_r0x
        # driver records can never carry it, so they are exempt
        reg.append(_finding(
            "missing-multihost-block", "multihost", 1.0, 0.0, 0.0,
            "regression",
            "multihost block present in base, absent in candidate"))
    if bmh and cmh:
        csh = {int(e["hosts"]): e for e in cmh.get("shapes", [])}
        for e in bmh.get("shapes", []):
            h = int(e["hosts"])
            ce = csh.get(h)
            tag = f"{h}host"
            if ce is None:
                reg.append(_finding(
                    "missing-multihost-shape", tag, 1.0, 0.0, 0.0,
                    "regression",
                    "host-group shape present in base, absent in "
                    "candidate"))
                continue
            checked += 1
            tol = max(TOL_CAP, min_tol)  # best-of-3, no recorded passes
            bs, cs = float(e.get("seconds", 0)), float(ce.get("seconds", 0))
            if bs and cs / bs - 1.0 > tol:
                reg.append(_finding("multihost-wall", tag, bs, cs, tol,
                                    "regression"))
            # per-hop collective statics of the compiled program: any
            # growth is a real change — the DCN hop ballooning back
            # toward the flat-allreduce payload is exactly the
            # regression the hierarchical path exists to prevent
            for key in ("psum_bytes_dcn", "psum_bytes_ici",
                        "psum_dcn", "psum_ici"):
                bv, cv = float(e.get(key, 0)), float(ce.get(key, 0))
                if bv > 0:
                    checked += 1
                    if cv > bv * (1.0 + STATIC_TOL):
                        reg.append(_finding(
                            "multihost-collective", f"{tag}:{key}", bv,
                            cv, STATIC_TOL, "regression",
                            "per-hop collective static grew"))
            # parity proof: an H-host fit matching the 1-host fit is a
            # correctness gate, not a perf number — a flip flags
            if e.get("parity_ok"):
                checked += 1
                if ce.get("parity_ok") is not True:
                    reg.append(_finding(
                        "multihost-parity", f"{tag}:parity_ok", 1.0, 0.0,
                        0.0, "regression",
                        "H-host fit no longer matches the 1-host fit — "
                        "layout-invariant sampling broke"))
            # host-skew coverage: a base shape that attributed per-host
            # compute must keep being able to name its slowest host
            if e.get("host_skew"):
                checked += 1
                if not ce.get("host_skew"):
                    reg.append(_finding(
                        "multihost-skew", f"{tag}:host_skew", 1.0, 0.0,
                        0.0, "regression",
                        "per-host skew table vanished — straggler "
                        "attribution lost its host lanes"))

    # ---- kernelbench block (pallas vs xla sweep + kernel.* counters)
    bk, ck = base.get("kernel"), cand.get("kernel")
    if bk and not ck and cand.get("shape") != "record":
        # same coverage rule as ordinary legs: the gate silently
        # vanishing IS the regression (bench.py carries the block across
        # plain suite runs, so a SIDECAR candidate missing it actually
        # lost it; BENCH_r0x driver records can never carry the block,
        # so they are exempt — like the multichip both-present rule)
        reg.append(_finding(
            "missing-kernel-block", "kernel", 1.0, 0.0, 0.0, "regression",
            "kernelbench block present in base, absent in candidate"))
    if bk and ck:
        ckl = {(int(e["max_bins"]), int(e["max_depth"])): e
               for e in ck.get("legs", [])}
        for e in bk.get("legs", []):
            ce = ckl.get((int(e["max_bins"]), int(e["max_depth"])))
            tag = f"b{e['max_bins']}d{e['max_depth']}"
            if ce is None:
                reg.append(_finding(
                    "missing-kernel-leg", tag, 1.0, 0.0, 0.0,
                    "regression",
                    "sweep leg present in base, absent in candidate"))
                continue
            # any fallback growth = fits silently leaving the pallas path
            bf = float((e.get("kernel_counters") or {})
                       .get("kernel.fallback", 0.0))
            cf = float((ce.get("kernel_counters") or {})
                       .get("kernel.fallback", 0.0))
            checked += 1
            if cf > bf:
                reg.append(_finding(
                    "kernel-fallback", tag, bf, cf, 0.0, "regression",
                    "kernel.fallback grew — pallas path silently lost"))
            for key in ("pallas_s", "xla_s"):
                bv, cv = e.get(key), ce.get(key)
                if not bv or not cv:
                    continue
                checked += 1
                tol = max(TOL_CAP, min_tol)  # best-of-3, no pass record
                if cv / bv - 1.0 > tol:
                    reg.append(_finding("kernel-wall", f"{tag}:{key}",
                                        float(bv), float(cv), tol,
                                        "regression"))

    # ---- kernelbench inference sweep (autotuned traversal specs)
    bki, cki = base.get("kernel_infer"), cand.get("kernel_infer")
    if bki and not cki and cand.get("shape") != "record":
        # coverage rule, like the fit-kernel block: bench.py carries the
        # block across plain suite runs, so a sidecar candidate missing
        # it actually lost the autotuner gate; driver records exempt
        reg.append(_finding(
            "missing-kernel-infer-block", "kernel_infer", 1.0, 0.0, 0.0,
            "regression",
            "kernelbench inference block present in base, absent in "
            "candidate"))
    if cki:
        # a NONZERO fallback count is a regression in its own right:
        # scoring dispatches requested (or were tuned to) pallas but
        # silently degraded to XLA — judged against the base's count so
        # an intentionally committed nonzero baseline stays comparable
        bf = float((bki or {}).get("fallbacks", 0.0))
        cf = float(cki.get("fallbacks", 0.0))
        checked += 1
        if cf > bf:
            reg.append(_finding(
                "infer-kernel-fallback", "fallbacks", bf, cf, 0.0,
                "regression",
                "infer.kernel.fallback grew — scoring silently off the "
                "tuned/pallas path"))
    if bki and cki:
        proofs = [("replay_ok",
                   "tuned spec no longer round-trips through the prewarm "
                   "manifest (replay would re-sweep)")]
        # beats-default is only a PROOF on compiled runs: in interpret
        # mode every pallas block_rows candidate executes the identical
        # single-block program, so the margin is timer noise — judging
        # it would flip the gate on an honest CPU re-run
        if not (bki.get("interpret") or cki.get("interpret")):
            proofs.append(("tuned_beats_default",
                           "autotuned spec no longer beats the default "
                           "kernelBlockRows at any sweep point"))
        for key, note in proofs:
            if bki.get(key) and cki.get(key) is not True:
                checked += 1
                reg.append(_finding(
                    "infer-kernel-proof", key, 1.0, 0.0, 0.0,
                    "regression", note))

    # ---- out-of-core scale block (data-plane throughput + coverage)
    bsc, csc = base.get("scale"), cand.get("scale")
    if bsc and not csc and cand.get("shape") != "record":
        # same coverage rule as the kernelbench block: a SIDECAR
        # candidate missing the block actually lost it (bench.py carries
        # it across plain suite runs); BENCH_r0x driver records can
        # never carry it, so they are exempt
        reg.append(_finding(
            "missing-scale-block", "scale", 1.0, 0.0, 0.0, "regression",
            "out-of-core scale block present in base, absent in candidate"))
    if bsc and csc and int(bsc.get("rows", 0)) == int(csc.get("rows", -1)):
        # throughputs are best-effort single runs (no pass record):
        # judge at the capped tolerance, like the multichip walls
        tol = max(TOL_CAP, min_tol)
        for key in ("ingest_rows_per_s", "predict_rows_per_s"):
            bv, cv = bsc.get(key), csc.get(key)
            if not bv or not cv:
                continue
            checked += 1
            rel = float(bv) / float(cv) - 1.0  # higher rows/s is better
            if rel > tol:
                reg.append(_finding(
                    "scale-throughput", key, float(bv), float(cv), tol,
                    "regression", "data-plane throughput dropped"))
            elif rel < -tol:
                imp.append(_finding("scale-throughput", key, float(bv),
                                    float(cv), tol, "improvement"))
        # prefetch overlap losing its event proof = the double buffer
        # silently degraded to serial staging
        bp = (bsc.get("prefetch") or {}).get("events_ok")
        cp = (csc.get("prefetch") or {}).get("events_ok")
        if bp and cp is False:
            checked += 1
            reg.append(_finding(
                "scale-overlap", "prefetch.events_ok", 1.0, 0.0, 0.0,
                "regression",
                "ingest dispatch/drain overlap proof vanished — prefetch "
                "pipeline running serially"))

    # ---- drift block (detection + no-false-positive proofs)
    bdr, cdr = base.get("drift"), cand.get("drift")
    if bdr and not cdr and cand.get("shape") != "record":
        # coverage rule, like the kernel/scale blocks: a sidecar
        # candidate missing the block actually lost the drift gate
        # (bench.py carries it across plain suite runs); driver records
        # can never carry it
        reg.append(_finding(
            "missing-drift-block", "drift", 1.0, 0.0, 0.0, "regression",
            "drift block present in base, absent in candidate"))
    if bdr and cdr:
        bs, cs = bdr.get("shift") or {}, cdr.get("shift") or {}
        bi, ci = bdr.get("iid") or {}, cdr.get("iid") or {}
        if bs.get("flagged"):
            checked += 1
            if not cs.get("flagged"):
                reg.append(_finding(
                    "drift-detection", "shift.flagged", 1.0, 0.0, 0.0,
                    "regression",
                    "injected covariate shift no longer flagged — the "
                    "detector went blind"))
            elif bs.get("named_ok") and not cs.get("named_ok"):
                reg.append(_finding(
                    "drift-detection", "shift.named_ok", 1.0, 0.0, 0.0,
                    "regression",
                    "shift flagged but the moved features are no longer "
                    "named"))
        if bi and not bi.get("flagged"):
            checked += 1
            if not ci or ci.get("flagged") is not False:
                # the no-false-positive proof either flipped (iid now
                # flags) or vanished — both mean the threshold floor
                # stopped doing its job
                reg.append(_finding(
                    "drift-false-positive", "iid.flagged", 0.0, 1.0, 0.0,
                    "regression",
                    "iid holdout no longer proven clean — noise-aware "
                    "threshold floor lost"))
        bb = (bdr.get("baseline") or {}).get("reload_bit_compat")
        cb = (cdr.get("baseline") or {}).get("reload_bit_compat")
        if bb:
            checked += 1
            if cb is not True:
                reg.append(_finding(
                    "drift-roundtrip", "baseline.reload_bit_compat", 1.0,
                    0.0, 0.0, "regression",
                    "baseline save/load round trip no longer "
                    "bit-compatible (reload self-distance != 0)"))

    # ---- continuous-training block (closed-loop promotion proofs)
    bct, cct = base.get("ct"), cand.get("ct")
    if bct and not cct and cand.get("shape") != "record":
        # coverage rule, like the kernel/scale/drift blocks: a sidecar
        # candidate missing the block lost the closed-loop gate
        # (bench.py carries it across plain suite runs); driver records
        # can never carry it
        reg.append(_finding(
            "missing-ct-block", "ct", 1.0, 0.0, 0.0, "regression",
            "continuous-training block present in base, absent in "
            "candidate"))
    if bct and cct:
        bd, cd = bct.get("drift") or {}, cct.get("drift") or {}
        bi, ci = bct.get("iid") or {}, cct.get("iid") or {}
        if bd.get("promoted"):
            checked += 1
            if not cd.get("promoted"):
                reg.append(_finding(
                    "ct-promotion", "drift.promoted", 1.0, 0.0, 0.0,
                    "regression",
                    "drift-triggered refit no longer promotes through "
                    "the canary gate — the loop lost its proof"))
            elif bd.get("hot_swap") and not cd.get("hot_swap"):
                reg.append(_finding(
                    "ct-promotion", "drift.hot_swap", 1.0, 0.0, 0.0,
                    "regression",
                    "promotion no longer hot-swaps the live endpoint"))
            elif int(bd.get("warm_refits", 0)) >= 1 \
                    and int(cd.get("warm_refits", 0)) < 1:
                reg.append(_finding(
                    "ct-promotion", "drift.warm_refits",
                    float(bd.get("warm_refits", 0)),
                    float(cd.get("warm_refits", 0)), 0.0, "regression",
                    "refits no longer warm-start (round-append lost — "
                    "every trigger refits from scratch)"))
        if int(bd.get("request_errors", -1)) == 0:
            checked += 1
            if int(cd.get("request_errors", -1)) != 0:
                reg.append(_finding(
                    "ct-promotion", "drift.request_errors", 0.0,
                    float(cd.get("request_errors", -1)), 0.0,
                    "regression",
                    "promotion window no longer error-free on the "
                    "serving path"))
        if bi and int(bi.get("refits", 1)) == 0:
            checked += 1
            if not ci or int(ci.get("refits", 0)) != 0:
                # the no-false-positive proof flipped (the iid control
                # now refits) or vanished — the drift trigger stopped
                # discriminating
                reg.append(_finding(
                    "ct-false-positive", "iid.refits", 0.0,
                    float((ci or {}).get("refits", -1)), 0.0,
                    "regression",
                    "iid control stream now triggers refits — the "
                    "drift trigger false-positives"))

    # ---- fleet block (serving-fleet closed-loop proofs)
    bfl, cfl = base.get("fleet"), cand.get("fleet")
    if bfl and not cfl and cand.get("shape") != "record":
        # coverage rule, like the kernel/scale/drift/ct blocks: a
        # sidecar candidate missing the block lost the fleet gate
        # (bench.py carries it across plain suite runs); driver records
        # can never carry it
        reg.append(_finding(
            "missing-fleet-block", "fleet", 1.0, 0.0, 0.0, "regression",
            "serving-fleet block present in base, absent in candidate"))
    if bfl and cfl:
        # a hung future is a liveness bug, not a perf number: 0 → N flags
        if int(bfl.get("hung_futures", -1)) == 0:
            checked += 1
            if int(cfl.get("hung_futures", -1)) != 0:
                reg.append(_finding(
                    "fleet-liveness", "hung_futures", 0.0,
                    float(cfl.get("hung_futures", -1)), 0.0,
                    "regression",
                    "requests hung instead of resolving (re-route or "
                    "shed) — the never-a-hung-future contract broke"))

        for path, note in (
                (("scale", "up_ok"),
                 "occupancy scale-up proof lost — the autoscaler no "
                 "longer adds replicas under load"),
                (("scale", "down_ok"),
                 "scale-down proof lost — the idle fleet no longer "
                 "retires to its floor"),
                (("rollout", "clean", "passed"),
                 "clean staged rollout no longer promotes"),
                (("rollout", "rollback", "rolled_back"),
                 "divergent rollout no longer auto-rolls-back — the "
                 "fleet would ship the bad candidate"),
                (("rollout", "rollback", "blackbox_on_disk"),
                 "evicted replica's black-box bundle proof lost"),
                (("priority_order_ok",),
                 "priority shed ladder no longer ordered (low must "
                 "shed first, high never)"),
                (("trace", "fanin_ok"),
                 "per-request trace ids no longer recoverable through "
                 "the router fan-in")):
            if _dig(bfl, path):
                checked += 1
                if _dig(cfl, path) is not True:
                    reg.append(_finding(
                        "fleet-proof", ".".join(path), 1.0, 0.0, 0.0,
                        "regression", note))
        # per-class latency/shed: load numbers — p99 at the serving
        # tolerance, shed rate noise-aware (absolute floor + half the
        # base rate of slack). p99 is judged only when both blocks'
        # closed_loop annotations agree: a block re-based onto intended
        # arrivals measures a different quantity than a send-time one
        same_loop = bool(bfl.get("closed_loop")) == \
            bool(cfl.get("closed_loop"))
        bp = bfl.get("priority") or {}
        cp = cfl.get("priority") or {}
        for cls in sorted(bp):
            ce = cp.get(cls)
            if not ce:
                continue
            bv, cv = bp[cls].get("p99_ms"), ce.get("p99_ms")
            if bv and cv and same_loop:
                checked += 1
                rel = float(cv) / float(bv) - 1.0
                if rel > SERVE_TOL:
                    reg.append(_finding(
                        "fleet-latency", f"{cls}:p99_ms", float(bv),
                        float(cv), SERVE_TOL, "regression"))
                elif rel < -SERVE_TOL:
                    imp.append(_finding(
                        "fleet-latency", f"{cls}:p99_ms", float(bv),
                        float(cv), SERVE_TOL, "improvement"))
            br = float(bp[cls].get("shed_rate", 0.0))
            cr = float(ce.get("shed_rate", 0.0))
            checked += 1
            if cr > br + max(0.1, 0.5 * br):
                reg.append(_finding(
                    "fleet-shed-rate", f"{cls}:shed_rate", br, cr,
                    0.5, "regression",
                    "per-class shed rate grew past the noise-aware "
                    "slack"))

    # ---- load block (open-loop trace-harness proofs)
    bld, cld = base.get("load"), cand.get("load")
    if bld and not cld and cand.get("shape") != "record":
        # coverage rule, like the kernel/scale/drift/ct/fleet blocks: a
        # sidecar candidate missing the block lost the --load gate
        # (bench.py carries it across plain suite runs); driver records
        # can never carry it
        reg.append(_finding(
            "missing-load-block", "load", 1.0, 0.0, 0.0, "regression",
            "open-loop load block present in base, absent in candidate"))
    if bld and cld:
        # overruns indict the HARNESS (its pool outran the schedule):
        # a committed zero growing to N means the record's percentiles
        # stopped describing the declared workload — exact-mode, like
        # the hung-future rule
        if int(bld.get("overrun", -1)) == 0:
            checked += 1
            if int(cld.get("overrun", -1)) != 0:
                reg.append(_finding(
                    "load-overrun", "overrun", 0.0,
                    float(cld.get("overrun", -1)), 0.0, "regression",
                    "open-loop driver overran its schedule — the "
                    "recorded tails no longer describe the declared "
                    "arrival rate"))
        # the tail-engineering proof: auto-tune + burst admission +
        # speculative prewarm must keep beating the untuned baseline
        # on the burst phase's p99.9
        if _dig(bld, ("engineering", "win")):
            checked += 1
            if _dig(cld, ("engineering", "win")) is not True:
                reg.append(_finding(
                    "load-engineering", "engineering.win", 1.0, 0.0,
                    0.0, "regression",
                    "tail-engineering on-vs-off p99.9 win on the burst "
                    "phase lost — the ladder stopped paying for itself"))
        # per-phase (and per-class) tails: open-loop load numbers,
        # judged at the serving/load tolerance
        bph = bld.get("phases") or {}
        cph = cld.get("phases") or {}
        for ph in sorted(bph):
            ce = cph.get(ph)
            if ce is None:
                reg.append(_finding(
                    "missing-load-phase", ph, 1.0, 0.0, 0.0,
                    "regression",
                    "trace phase present in base, absent in candidate"))
                continue
            for key in ("p50_ms", "p99_ms", "p999_ms"):
                bv, cv = bph[ph].get(key), ce.get(key)
                if bv and cv:
                    checked += 1
                    rel = float(cv) / float(bv) - 1.0
                    if rel > LOAD_TOL:
                        reg.append(_finding(
                            "load-tail", f"{ph}:{key}", float(bv),
                            float(cv), LOAD_TOL, "regression"))
                    elif rel < -LOAD_TOL:
                        imp.append(_finding(
                            "load-tail", f"{ph}:{key}", float(bv),
                            float(cv), LOAD_TOL, "improvement"))
            bcl = bph[ph].get("classes") or {}
            ccl = ce.get("classes") or {}
            for cls in sorted(bcl):
                cc = ccl.get(cls)
                bv = bcl[cls].get("p99_ms")
                cv = (cc or {}).get("p99_ms")
                if bv and cv:
                    checked += 1
                    if float(cv) / float(bv) - 1.0 > LOAD_TOL:
                        reg.append(_finding(
                            "load-tail", f"{ph}:{cls}:p99_ms",
                            float(bv), float(cv), LOAD_TOL,
                            "regression"))
            # worst-request exemplar: a base phase that could name its
            # literal worst request must keep being able to
            if bph[ph].get("worst_trace"):
                checked += 1
                if not ce.get("worst_trace"):
                    reg.append(_finding(
                        "load-exemplar", f"{ph}:worst_trace", 1.0, 0.0,
                        0.0, "regression",
                        "per-phase worst-request trace exemplar no "
                        "longer recoverable"))

    # ---- lint block (static-analysis gate receipts)
    bln, cln = base.get("lint"), cand.get("lint")
    if bln and not cln and cand.get("shape") != "record":
        # coverage rule, like the kernel/scale/drift blocks: a sidecar
        # candidate missing the block lost the --lint gate (bench.py
        # carries it across plain suite runs); driver records exempt
        reg.append(_finding(
            "missing-lint-block", "lint", 1.0, 0.0, 0.0, "regression",
            "graftlint gate block present in base, absent in candidate"))
    if bln and cln:
        bv = float(bln.get("violations", 0))
        cv = float(cln.get("violations", 0))
        checked += 1
        if cv > bv:
            reg.append(_finding(
                "lint-violations", "violations", bv, cv, 0.0,
                "regression",
                "unsuppressed graftlint violation count grew — the tree "
                "was recorded dirty"))
        br = float(bln.get("rules", 0))
        cr = float(cln.get("rules", 0))
        if br:
            checked += 1
            if cr < br:
                reg.append(_finding(
                    "lint-rules", "rules", br, cr, 0.0, "regression",
                    "active graftlint rule count shrank — invariant "
                    "coverage loss"))
    if cln:
        # absolute floor, independent of the base record: the
        # distributed-semantics pass took the catalogue to 14; any
        # candidate below that lost rules even when diffed against a
        # base that predates the pass
        cr = float(cln.get("rules", 0))
        checked += 1
        if cr < LINT_RULE_FLOOR:
            reg.append(_finding(
                "lint-rule-floor", "rules", float(LINT_RULE_FLOOR), cr,
                0.0, "regression",
                f"active graftlint rule count below the {LINT_RULE_FLOOR}"
                "-rule floor — a distributed-semantics rule was dropped"))
        # exact-mode counter: untracked-compile-input names a real
        # silent-staleness bug class, found by hand twice — one
        # reappearance means a conf read traced into an executable
        # off-key, which no runtime test catches
        cbr = cln.get("violations_by_rule") or {}
        checked += 1
        n_uci = float(cbr.get("untracked-compile-input", 0))
        if n_uci > 0:
            reg.append(_finding(
                "lint-compile-input", "untracked-compile-input", 0.0,
                n_uci, 0.0, "regression",
                "a conf/global read traces into a device program off the "
                "cache key (the kernelBlockRows bug class) — exact-mode: "
                "zero tolerance"))

    return {"ok": not reg, "regressions": reg, "improvements": imp,
            "checked": checked}


# ------------------------------------------------------ the torch-smoke record
_COLLECTIVE = re.compile(r"psum|all_gather|pmin|pmax|dcn_bytes")


def record_from_blocks(blocks: dict, meta: dict) -> dict:
    """The port's run record: `blocks` (the JSON blocks `chip_smoke.py`
    prints, under the key each is printed with) beside `meta`, any of
    META_KEYS but "shape": the card's name and power limit (one
    `nvidia-smi --query-gpu=name,power.limit` line), the host CPU
    ({"model", "count"}), the versions ({"torch", "cuda", "python"}), the
    commit (None outside a checkout), the seed, each phase's wall
    ({name: seconds}), the script's wall in seconds and the proofs the
    script asserted ({name: bool}). Round-tripped through JSON, so it
    equals what a file holds: tuples read back as lists, int keys as
    strings."""
    extra = sorted(set(meta) - set(META_KEYS[1:]))
    clash = sorted(set(blocks) & set(META_KEYS))
    if extra or clash:
        raise ValueError(f"record_from_blocks: meta keys {extra} unknown, "
                         f"blocks {clash} named as meta keys")
    rec = {"shape": SMOKE_SHAPE}
    rec.update({k: meta.get(k) for k in META_KEYS[1:]})
    rec.update(blocks)
    return json.loads(json.dumps(rec))


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _leaves(node, path=()):
    """(path, value) of every leaf under `node`, list indices as keys."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, node


def _timed_nodes(node, path=()):
    """(path, dict) of every dict under a kernel's entry with a numeric
    "ms": the shapes the script timed it at (not its profiler windows)."""
    if _number(node.get("ms")):
        yield path, node
    for k, v in node.items():
        if isinstance(v, dict) and k != "device_windows":
            yield from _timed_nodes(v, path + (str(k),))


def _normalize_smoke(doc: dict) -> dict:
    """A torch-smoke run record -> the normalized shape: walls as `legs`
    (a leg's "seconds" holds the wall in the unit its key ends with:
    "ms" for a kernel and the tuning fits, seconds otherwise), the other
    judged numbers as `families` of {key: (owner, value)}, and the
    `owners` whose loss is one coverage finding ({owner: kind}: blocks,
    kernels, host routes, phases and the fleet's open-loop phases)."""
    tree = {k: v for k, v in doc.items() if k not in META_KEYS}
    kernels = {e["name"]: e for e in tree.get("kernels") or []
               if isinstance(e, dict) and "name" in e}
    routes = {e["name"]: e for e in tree.get("host_routes") or []
              if isinstance(e, dict) and "name" in e}
    if "kernels" in tree:
        tree["kernels"] = kernels
    if "host_routes" in tree:
        tree["host_routes"] = routes
    phases = {str(k): v for k, v in (doc.get("phases") or {}).items()}
    owners = {name: "missing-block" for name in tree}
    owners.update({f"kernels/{n}": "missing-kernel" for n in kernels})
    owners.update({f"host_routes/{n}": "missing-host-route" for n in routes})
    owners.update({f"phases/{n}": "missing-phase" for n in phases})

    def owner_of(path) -> str:
        if path[0] in ("kernels", "host_routes") and len(path) > 1:
            return f"{path[0]}/{path[1]}"
        return path[0]

    legs: Dict[str, dict] = {}

    def leg(key, owner, value, passes=()):
        legs[key] = {"seconds": float(value),
                     "passes": [float(x) for x in passes]
                     if len(passes) > 1 else [],
                     "counters": {}, "owner": owner}

    for name, wall in phases.items():
        if _number(wall) and name.split(" ", 1)[-1] not in INFO_PHASES:
            leg(f"phase {name}", f"phases/{name}", wall)
    if _number(doc.get("wall_s")):
        leg("script", None, doc["wall_s"])
    for mode, runs in (_dig(tree, ("tuning", "walls_ms")) or {}).items():
        fits = [r["fit_ms"] for r in runs or []
                if isinstance(r, dict) and _number(r.get("fit_ms"))]
        if fits:
            leg(f"tuning {mode} fit_ms", "tuning", min(fits), fits)
    for name, k in kernels.items():
        for path, node in _timed_nodes(k):
            where = " ".join((name, ".".join(path))).strip()
            for unit in ("ms", "device_ms"):
                if _number(node.get(unit)):
                    leg(f"kernel {where} {unit}", f"kernels/{name}",
                        node[unit])

    fam: Dict[str, Dict[str, tuple]] = {f: {} for f in (
        "launches", "collectives", "proofs", "decisions", "errors",
        "zeros", "late", "serve", "load", "throughput", "limits",
        "drift")}
    for name, k in kernels.items():
        own = f"kernels/{name}"
        for path, n in (k.get("launches_by_path") or {}).items():
            if _number(n):
                fam["launches"][f"{name}:{path}"] = (own, n)
        if _number(k.get("replay_launches")):
            fam["launches"][f"{name}:replay"] = (own, k["replay_launches"])
        for path, v in _leaves(k):
            if path[-1] == "max_abs_err" and _number(v):
                fam["errors"][f"{name}:{'.'.join(path)}"] = (own, v)
    for name, r in routes.items():
        for path, n in (r.get("calls_by_path") or {}).items():
            if _number(n):
                fam["launches"][f"{name}:{path}"] = (f"host_routes/{name}",
                                                      n)
    for blk, node in tree.items():
        if not blk.startswith("multirank") or not isinstance(node, dict):
            continue
        for layout, entry in node.items():
            if not isinstance(entry, dict):
                continue
            fields = dict(entry.get("collectives") or {})
            fields.update({k: v for k, v in entry.items()
                           if _COLLECTIVE.search(k)})
            for key, v in fields.items():
                if _number(v):
                    fam["collectives"][f"{blk}/{layout}/{key}"] = (blk, v)
    for path, v in _leaves(dict(tree, proofs=doc.get("proofs") or {})):
        if isinstance(v, bool) and any(
                len(path) == len(p)
                and all(q in ("*", s) for s, q in zip(path, p))
                for p in PROOF_PATHS):
            fam["proofs"][".".join(path)] = (owner_of(path), v)
        elif path[-1] in ZERO_KEYS and _number(v):
            fam["late" if path[-1] in LATE_KEYS else "zeros"][
                ".".join(path)] = (owner_of(path), v)
    for path in DECISION_PATHS:
        v = _dig(tree, path)
        if v is not None:
            fam["decisions"][".".join(path)] = (
                path[0], tuple(v) if isinstance(v, list) else v)
    for path, v in _leaves(tree.get("registry") or {}):
        if path[-1] in ("p50_ms", "p99_ms") and _number(v):
            fam["serve"]["registry." + ".".join(path)] = ("registry", v)
    for ph, e in (_dig(tree, ("fleet", "b", "report", "phases")) or {}
                  ).items():
        own = f"fleet/load/{ph}"
        owners[own] = "missing-load-phase"
        rows = [((ph,), e)] + [((ph, cls), c) for cls, c in
                               ((e or {}).get("classes") or {}).items()]
        for where, entry in rows:
            for key in ("p50_ms", "p99_ms", "p999_ms"):
                if _number((entry or {}).get(key)):
                    fam["load"][":".join(where + (key,))] = (own,
                                                              entry[key])
    ing = _dig(tree, ("chunked", "e")) or {}
    for depth, st in (ing.get("ingest") or {}).items():
        if _number(ing.get("rows")) and _number((st or {}).get("wall_s")) \
                and st["wall_s"] > 0:
            fam["throughput"][f"chunked.e.ingest.{depth}:rows_per_s"] = (
                "chunked", (ing["rows"], ing["rows"] / st["wall_s"]))
    if all(_number(ing.get(k)) for k in (
            "pass2_device_bytes", "compact_bytes", "chunk_block_bytes")):
        fam["limits"]["chunked.e.pass2_device_bytes"] = ("chunked", (
            ing["pass2_device_bytes"], ing["compact_bytes"]
            + 2 * ing["chunk_block_bytes"] + PASS2_SLACK_BYTES))
    for path in (("observed", "b", "shift", "flagged"),
                 ("observed", "b", "iid", "flagged")):
        v = _dig(tree, path)
        if isinstance(v, list):
            fam["drift"][".".join(path)] = ("observed", tuple(v))
    for chunk, v in (_dig(tree, ("observed", "d", "verdicts")) or {}
                     ).items():
        if isinstance(v, list):
            fam["drift"][f"observed.d.verdicts.{chunk}"] = ("observed",
                                                            tuple(v))
    cpu = doc.get("host_cpu") or {}
    return {
        "value": None, "pass_walls": [], "legs": legs, "metrics": {},
        "multichip": None, "multihost": None, "kernel": None,
        "kernel_infer": None, "scale": None, "drift": None,
        "lint": tree.get("lint"), "ct": None, "fleet": None, "load": None,
        "shape": SMOKE_SHAPE,
        "machine": {"card": doc.get("card"), "cpu": cpu.get("model"),
                    "cpus": cpu.get("count")},
        "owners": owners, "families": fam,
    }


def _compare_smoke(base: dict, cand: dict, min_tol: float) -> dict:
    """`compare` for torch-smoke records (the module docstring's rules).
    Adds `not_comparable`: the walls left unjudged, each with its reason
    (card or host differ, a device time not measured, other row
    counts)."""
    reg: List[dict] = []
    imp: List[dict] = []
    nc: List[dict] = []
    if base.get("shape") != cand.get("shape"):
        reg.append(_finding(
            "record-shape", "shape", 1.0, 0.0, 0.0, "regression",
            f"a {base.get('shape')} record against a {cand.get('shape')} "
            f"record: nothing to compare"))
        return {"ok": False, "regressions": reg, "improvements": imp,
                "checked": 0, "not_comparable": nc}
    checked = 0

    # ---- coverage: each lost owner once, its entries not again
    gone: List[str] = []
    for owner, kind in sorted(base["owners"].items()):
        if owner in cand["owners"]:
            continue
        if not any(owner.startswith(g + "/") for g in gone):
            reg.append(_finding(kind, owner, 1.0, 0.0, 0.0, "regression",
                                "present in base, absent in candidate"))
        gone.append(owner)

    def live(owner) -> bool:
        return owner is None or not any(
            owner == g or owner.startswith(g + "/") for g in gone)

    def judged(name):
        """(key, owner, base value, candidate value or None) of a
        family's entries whose owner the candidate still has."""
        cf = cand["families"][name]
        for key, (owner, bv) in sorted(base["families"][name].items()):
            if live(owner):
                yield key, owner, bv, (cf[key][1] if key in cf else None)

    # ---- walls, judged only on the same card and host
    same = base["machine"] == cand["machine"]
    why = (f"card or host differ: {base['machine']} against "
           f"{cand['machine']}")
    capped = max(TOL_CAP, min_tol)
    for name, b in sorted(base["legs"].items()):
        if not live(b["owner"]):
            continue
        c = cand["legs"].get(name)
        if c is None:
            if name.endswith("device_ms"):
                nc.append(_finding("leg-wall", name, b["seconds"], 0.0, 0.0,
                                   "not-comparable",
                                   "not measured in the candidate"))
            else:
                reg.append(_finding("missing-leg", name, b["seconds"], 0.0,
                                    0.0, "regression", "leg present in "
                                    "base, absent in candidate"))
            continue
        tol = _wall_tol(b["passes"], c["passes"], min_tol) \
            if b["passes"] and c["passes"] else capped
        if not same:
            nc.append(_finding("leg-wall", name, b["seconds"], c["seconds"],
                               tol, "not-comparable", why))
            continue
        checked += 1
        rel = (c["seconds"] / b["seconds"] - 1.0) if b["seconds"] else 0.0
        if rel > tol:
            reg.append(_finding("leg-wall", name, b["seconds"], c["seconds"],
                                tol, "regression",
                                f"+{100 * rel:.1f}% vs tol "
                                f"{100 * tol:.0f}% (noise-aware)"))
        elif rel < -tol:
            imp.append(_finding("leg-wall", name, b["seconds"], c["seconds"],
                                tol, "improvement"))
    for key, _o, (brows, bv), got in judged("throughput"):
        if got is None:
            continue
        crows, cv = got
        if not same or brows != crows:
            nc.append(_finding("scale-throughput", key, bv, cv, capped,
                               "not-comparable", why if not same else
                               f"rows {brows} against {crows}"))
            continue
        checked += 1
        rel = bv / cv - 1.0  # higher rows/s is better
        if rel > capped:
            reg.append(_finding("scale-throughput", key, bv, cv, capped,
                                "regression",
                                "data-plane throughput dropped"))
        elif rel < -capped:
            imp.append(_finding("scale-throughput", key, bv, cv, capped,
                                "improvement"))

    # ---- launches and host-route calls: exact, the racy paths LOAD_TOL
    for key, owner, bv, cv in judged("launches"):
        if cv is None:
            reg.append(_finding("missing-path", key, bv, 0.0, 0.0,
                                "regression", "path present in base, "
                                "absent in candidate"))
            continue
        checked += 1
        kind = "kernel-launches" if owner.startswith("kernels/") \
            else "host-route-calls"
        tol = LOAD_TOL if key.rsplit(":", 1)[1] in RACY_PATHS else 0.0
        if cv > bv * (1.0 + tol):
            reg.append(_finding(kind, key, bv, cv, tol, "regression",
                                "a racy path's count grew past LOAD_TOL"
                                if tol else "launches grew"))
        elif cv * (1.0 + tol) < bv:
            imp.append(_finding(kind, key, bv, cv, tol, "improvement"))

    # ---- multi-rank collective statics
    for key, _o, bv, cv in judged("collectives"):
        if cv is None:
            reg.append(_finding("missing-collective", key, bv, 0.0, 0.0,
                                "regression", "present in base, absent "
                                "in candidate"))
            continue
        checked += 1
        if cv > bv * (1.0 + STATIC_TOL):
            reg.append(_finding("multirank-collective", key, bv, cv,
                                STATIC_TOL, "regression",
                                "a rank's collective static grew"))
        elif cv < bv * (1.0 - STATIC_TOL):
            imp.append(_finding("multirank-collective", key, bv, cv,
                                STATIC_TOL, "improvement"))

    # ---- proofs, decisions, kernel errors, counts held at zero
    for key, _o, bv, cv in judged("proofs"):
        if bv is True:
            checked += 1
            if cv is not True:
                reg.append(_finding("proof", key, 1.0, 0.0, 0.0,
                                    "regression", "proof flipped"
                                    if cv is False else "proof vanished"))
    for key, _o, bv, cv in judged("decisions"):
        checked += 1
        if cv != bv:
            reg.append(_finding("dispatch-decision", key, 1.0, 0.0, 0.0,
                                "regression", f"{cv!r} against {bv!r}"))
    for family, kind, note in (
            ("errors", "kernel-error",
             "the kernel no longer equals its plain version"),
            ("zeros", "zero-count", "grew from 0"),
            ("late", "zero-count", "grew from 0 (late against the host's "
                                   "clock)")):
        for key, _o, bv, cv in judged(family):
            if bv == 0:
                if family == "late" and not same:
                    nc.append(_finding(kind, key, bv, cv or 0.0, 0.0,
                                       "not-comparable", why))
                    continue
                checked += 1
                if cv is None or cv != 0:
                    reg.append(_finding(
                        kind, key, 0.0, 0.0 if cv is None else cv, 0.0,
                        "regression",
                        note if cv is not None else "vanished"))

    # ---- request percentiles: read off the host's clock, like walls
    for family, kind, tol in (("serve", "serve-latency", SERVE_TOL),
                              ("load", "load-tail", LOAD_TOL)):
        for key, _o, bv, cv in judged(family):
            if not bv or not cv:
                continue
            if not same:
                nc.append(_finding(kind, key, bv, cv, tol,
                                   "not-comparable", why))
                continue
            checked += 1
            rel = cv / bv - 1.0
            if rel > tol:
                reg.append(_finding(kind, key, bv, cv, tol, "regression"))
            elif rel < -tol:
                imp.append(_finding(kind, key, bv, cv, tol, "improvement"))

    # ---- the chunked ingest's device bytes under their limit
    for key, _o, _b, got in judged("limits"):
        if got is not None:
            checked += 1
            if got[0] > got[1]:
                reg.append(_finding("device-bytes-limit", key, got[1],
                                    got[0], 0.0, "regression",
                                    "pass 2 past compact + 2 chunk blocks "
                                    "+ 16 MiB"))

    # ---- drift: the shifted feature alone
    for key, _o, bv, cv in judged("drift"):
        checked += 1
        if cv != bv:
            reg.append(_finding(
                "drift-detection" if bv else "drift-false-positive", key,
                float(len(bv)), float(len(cv or ())), 0.0, "regression",
                f"flagged {list(cv or ())} against {list(bv)}"))

    # ---- lint: the port's floor, no new finding, no forbidden import
    bln, cln = base.get("lint") or {}, cand.get("lint")
    if cln and live("lint"):
        cr, br = float(cln.get("rules", 0)), float(bln.get("rules", 0))
        checked += 1
        if cr < SMOKE_LINT_RULE_FLOOR:
            reg.append(_finding(
                "lint-rule-floor", "rules", float(SMOKE_LINT_RULE_FLOOR), cr,
                0.0, "regression", "active lint rule count below the "
                f"port's {SMOKE_LINT_RULE_FLOOR}-rule floor"))
        elif cr < br:
            reg.append(_finding("lint-rules", "rules", br, cr, 0.0,
                                "regression",
                                "active lint rule count shrank"))
        if bln:
            checked += 1
            bv = float(bln.get("violations", 0))
            cv = float(cln.get("violations", 0))
            if cv > bv:
                reg.append(_finding("lint-violations", "violations", bv, cv,
                                    0.0, "regression",
                                    "unsuppressed lint findings grew"))
        if bln.get("forbidden_imported") == []:
            checked += 1
            cf = cln.get("forbidden_imported")
            if cf != []:
                reg.append(_finding(
                    "lint-imports", "forbidden_imported", 0.0,
                    float(len(cf or ())), 0.0, "regression",
                    f"the lint imported {cf}" if cf
                    else "the import check vanished"))

    return {"ok": not reg, "regressions": reg, "improvements": imp,
            "checked": checked, "not_comparable": nc}


# ------------------------------------------------------------------ rendering
def render(result: dict, base_path: str, cand_path: str) -> str:
    unjudged = result.get("not_comparable", [])
    lines = [f"bench_diff: {base_path} -> {cand_path} "
             f"({result['checked']} checks, "
             f"{len(result['regressions'])} regressions, "
             f"{len(result['improvements'])} improvements"
             + (f", {len(unjudged)} not comparable" if unjudged else "")
             + ")"]
    fmt = "{:<22}{:<28}{:>12}{:>12}{:>8}{:>8}  {}"
    if result["regressions"] or result["improvements"] or unjudged:
        lines.append(fmt.format("kind", "key", "base", "cand", "ratio",
                                "tol", "note"))
    tags = {"regression": "REGRESSION ", "not-comparable": "not compared: "}
    for f in result["regressions"] + result["improvements"] + unjudged:
        tag = tags.get(f["severity"], "improved ")
        lines.append(fmt.format(f["kind"], f["key"], f["base"], f["cand"],
                                f["ratio"], f["tol"],
                                tag + f.get("note", "")))
    lines.append("verdict: " + ("OK" if result["ok"] else "REGRESSED"))
    return "\n".join(lines)


def trace_events(result: dict) -> List[dict]:
    """Chrome-trace instant markers for every verdict — mergeable into
    any exported engine trace (`obs.annotate_regressions` is the
    in-process equivalent through the flight recorder)."""
    out = []
    for i, f in enumerate(result["regressions"] + result["improvements"]):
        out.append({"ph": "i", "s": "g", "pid": 99, "tid": 0,
                    "ts": float(i), "name": "regress.verdict",
                    "cat": "regress", "args": dict(f)})
    return out


def diff_paths(base_path: str, cand_path: str,
               min_tol: float = MIN_TOL) -> dict:
    return compare(load(base_path), load(cand_path), min_tol)
