"""sml_tpu_torch.obs — the port's flight recorder.

The port's copy of `sml_tpu/obs`, on ONE structured event bus:

- `RECORDER` (`_recorder`): typed events (spans, counters, dispatch
  decisions, serving flushes and swaps, prewarm replays, pipeline
  stages, ledger gauges, drift verdicts) in a bounded ring with an
  optional JSONL sink (`sml.obs.sinkPath`, the JAX package's record
  format). Enabled by `sml.obs.enabled`; disabled it costs one attribute
  load per instrumentation site.
- `export_chrome_trace(path)` (`_trace`, over the stdlib-only
  `_tracefmt`): the ring as a Chrome/Perfetto trace, with host thread
  lanes, a device lane for dispatched programs, per-device skew lanes,
  counter tracks and causal flow arrows.
- `audit_report()` (`_audit`): every `dispatch.decide` with its
  predicted host and device times and the routed program's measured
  wall: calibration drift and would-have-been-faster misroutes.
- `memory_report()` / `LEDGER` (`_ledger`): live and peak device bytes
  of the bin cache, the staging cache, the boosted fits' margin and the
  chunked ingest's transient matrix; `engine.hbm_peak_bytes` reads it.
- `engine_metrics()` and `autolog_fit`: the outermost `Estimator.fit`
  under an active tracking run logs its `engine.*` deltas to the run
  (`sml.obs.autoLogRunMetrics`).
- `METRICS` (`_metrics`): streaming log-bucketed histograms (latency
  quantiles and rates without kept samples); `engine_health()` is the
  one-call snapshot of every block, surfaced on
  `ServingEndpoint.health_report()`.
- `SKEW` / `INGEST_SKEW` / `straggler_report()` (`_skew`): BSP
  compute-against-wait attribution; on one card the chunked ingest
  feeds `INGEST_SKEW` per chunk, and `SKEW` has no feed of its own.
- `TraceContext` (`_context`): a context minted at serving admission
  rides contextvars (handed across threads explicitly) through the
  micro-batch fan-in and the program spans.
- `WATCHDOG` (`_watchdog`): in-flight stall detection for routed
  program spans, micro-batch flushes, pipeline stages and prewarm
  replays, with all-thread stacks on a stall.
- `dump_blackbox` / `install_blackbox` (`blackbox`): postmortem bundles
  in the JAX package's layout.
- `drift` / `DRIFT` (`drift`): live traffic and ingest chunks judged
  against the training baseline a tree model carries.
- `regress` (stdlib-only, also loadable standalone by
  `scripts/torch_bench_diff.py`): noise-aware comparison of two run
  records (the torch-smoke record `chip_smoke.py --record` writes, or
  the JAX package's bench records), the machine-checkable regression
  gate; `annotate_regressions` lands its verdicts here.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, Optional

from ..conf import GLOBAL_CONF
from . import _audit, _context, _ledger
from . import drift as drift  # noqa: F401 — re-exported subsystem
from ._audit import records as audit_records, report as audit_report
from ._context import TraceContext, activate as activate_trace, \
    current as current_trace, hex_id as trace_hex, new_trace
from ._ledger import LEDGER, report as memory_report
from ._metrics import METRICS, LogHistogram, merge_snapshots
from ._recorder import RECORDER, Event
from ._skew import INGEST_SKEW, SKEW, \
    report_from_trace as skew_report_from_trace
from ._trace import export_chrome_trace
from ._watchdog import WATCHDOG, all_thread_stacks
from .blackbox import dump_blackbox, install as install_blackbox
from .drift import DRIFT

__all__ = ["RECORDER", "Event", "LEDGER", "METRICS", "SKEW", "INGEST_SKEW",
           "WATCHDOG", "drift", "DRIFT",
           "TraceContext", "current_trace", "new_trace", "activate_trace",
           "trace_hex", "all_thread_stacks", "dump_blackbox",
           "install_blackbox",
           "LogHistogram", "merge_snapshots", "export_chrome_trace",
           "audit_report", "audit_records", "memory_report",
           "engine_metrics", "engine_health", "straggler_report",
           "skew_report_from_trace", "annotate_regressions", "reset",
           "enabled", "note_compile", "autolog_fit", "slo_report",
           "note_pipeline"]


def enabled() -> bool:
    return RECORDER.enabled


def reset() -> None:
    """Drop recorded events, audit records, metric histograms, skew
    attributions, watchdog statistics and drift windows, and re-arm the
    ledger's peaks (live ledger bytes, OPEN watchdog tickets and
    registered drift monitors persist: they describe real cache
    residency, real in-flight work and live endpoints)."""
    RECORDER.reset()
    _audit.reset()
    METRICS.reset()
    SKEW.reset()
    INGEST_SKEW.reset()
    WATCHDOG.reset()
    LEDGER.reset_peaks()
    drift.DRIFT.reset()


def note_pipeline(family: str, phase: str, key: str, index: int) -> None:
    """Staging-pipeline counter and event (`parallel/pipeline.py`):
    counts `<family>.<phase>`, with family "infer" (batch inference) or
    "ingest" (chunked ingest), and records it with the recorder on.
    Computed names are this package's (tests/test_torch_taxonomy.py)."""
    from ..utils.profiler import PROFILER
    PROFILER.count(family + "." + phase)
    if RECORDER.enabled:
        RECORDER.emit(family, family + "." + phase, args={key: index})


def note_compile(name: str) -> None:
    """Mark a program-cache miss: in the port, a kernel or host library
    built from its source because no library of its content hash was on
    disk (`native/build.py`). Bumps `compile.programs` and the per-name
    `compile.program.<name>`, and records a compile event."""
    from ..utils.profiler import PROFILER
    PROFILER.count("compile.programs")
    PROFILER.count(f"compile.program.{name}")
    if RECORDER.enabled:
        RECORDER.emit("compile", "compile.trace", args={"program": name})


def engine_metrics() -> Dict[str, float]:
    """The engine's health snapshot as flat `engine.*` metrics: byte
    volumes, cache hit rates, route mix, library builds, the ledger's
    peak device bytes. Sourced from the recorder's own totals (what
    happened while the recorder was on) and the memory ledger."""
    t = RECORDER.counters()
    hits = t.get("staging.cache_hit", 0.0)
    misses = t.get("staging.cache_miss", 0.0)
    bhits = t.get("staging.bin_cache_hit", 0.0)
    bmisses = t.get("staging.bin_cache_miss", 0.0)
    return {
        "engine.h2d_bytes": t.get("staging.h2d_bytes", 0.0),
        "engine.d2h_bytes": t.get("staging.d2h_bytes", 0.0),
        "engine.h2d_bytes_saved": t.get("staging.h2d_bytes_saved", 0.0),
        "engine.cache_hit_rate": hits / max(hits + misses, 1.0),
        "engine.bin_cache_hit_rate": bhits / max(bhits + bmisses, 1.0),
        "engine.route_device": t.get("dispatch.route_device", 0.0),
        "engine.route_host": t.get("dispatch.route_host", 0.0),
        "engine.compile_programs": t.get("compile.programs", 0.0),
        "engine.hbm_peak_bytes": float(LEDGER.peak_total()),
        "engine.shuffle_rows": t.get("shuffle.rows", 0.0),
    }


def straggler_report() -> Optional[Dict[str, object]]:
    """Aggregate per-device skew attribution across every program noted
    with `SKEW.note` (None when nothing was noted: one card notes
    nothing of its own). See obs/_skew.py for the BSP decomposition."""
    return SKEW.straggler_report()


def slo_report(window_s: Optional[float] = None) -> Dict[str, float]:
    """Latency-SLO burn for the serving path: the fraction of
    `serve.request_ms` observations above `sml.serve.sloMillis`, divided
    by the error budget (`sml.serve.sloBudget`): burn_rate 1.0 spends the
    budget exactly as fast as allowed; above 1 is an alert. Breach
    counting is bucket-exact (within one ~9% histogram bucket of the
    threshold). `worst_ms` / `worst_trace` are all-time and stay empty on
    a windowed report."""
    target_ms = float(GLOBAL_CONF.get("sml.serve.sloMillis"))
    budget = float(GLOBAL_CONF.get("sml.serve.sloBudget"))
    hist = METRICS.histogram("serve.request_ms")
    worst_ms, worst_trace = 0.0, None
    if hist is None:
        total = breaches = 0
    else:
        total = hist.total_count(window_s)
        breaches = hist.count_above(target_ms, window_s)
        if window_s is None:
            worst_ms, worst_trace = hist.worst()
    fraction = (breaches / total) if total else 0.0
    burn = fraction / budget if budget > 0 else 0.0
    if RECORDER.enabled and total:
        RECORDER.gauge("slo.burn_rate", burn)
    return {"target_ms": target_ms, "budget_fraction": budget,
            "requests": float(total), "breaches": float(breaches),
            "breach_fraction": round(fraction, 6),
            "burn_rate": round(burn, 4),
            "worst_ms": round(float(worst_ms), 3),
            "worst_trace": _context.hex_id(worst_trace)}


def _infer_kernel_report() -> Optional[Dict[str, object]]:
    mod = sys.modules.get("sml_tpu_torch.ml.inference")
    return None if mod is None else mod.kernel_report()


def _fleet_report() -> Optional[Dict[str, object]]:
    mod = sys.modules.get("sml_tpu_torch.fleet")
    return None if mod is None else mod.fleet_report()


def _load_report() -> Optional[Dict[str, object]]:
    mod = sys.modules.get("sml_tpu_torch.loadgen")
    return None if mod is None else mod.load_report()


def engine_health(window_s: Optional[float] = None) -> Dict[str, object]:
    """ONE call, the engine's whole health surface: streaming-metric
    quantiles (serving latency, per-route dispatch walls), the dispatch
    audit's verdicts, the memory ledger, the flat `engine.*` metrics, the
    serving SLO burn-rate, the straggler and ingest-chunk attributions,
    the in-flight watchdog table, drift, the scorer's traversal plan,
    sheds by reason, and the fleet and load blocks (None until a pool or
    a load replay exists). `window_s` restricts metric quantiles and
    rates to the trailing window (None = all-time). Cheap enough to
    poll: everything is read from bounded in-memory state, and the
    lazily read blocks import nothing."""
    recs = audit_records()
    measured = [r for r in recs if r.measured is not None]
    # shed counters live in whichever stream was on when they fired
    # (PROFILER counts always; the recorder only while it is on):
    # max-merge the two, so both on never double-counts
    counters = dict(RECORDER.counters())
    from ..utils.profiler import PROFILER as _PROF
    for k, v in _PROF.counters().items():
        if k.startswith("serve.shed"):
            counters[k] = max(counters.get(k, 0.0), v)
    health = {
        "metrics": METRICS.snapshot(window_s),
        "audit": {
            "decisions": len(recs),
            "measured": len(measured),
            "misroutes": sum(1 for r in measured if r.misroute),
            "report": audit_report(),
        },
        "hbm": LEDGER.snapshot(),
        "engine": engine_metrics(),
        "slo": slo_report(window_s),
        "skew": straggler_report(),
        # chunked-ingest attribution (ml/_chunked.py feeds each chunk's
        # host quantization wall): "slowest_device" is the slowest CHUNK
        "ingest": INGEST_SKEW.straggler_report(),
        # what is running RIGHT NOW, how long it has been, and whether
        # it broke its own prediction
        "inflight": WATCHDOG.report(),
        # every registered monitor's live-against-baseline verdict:
        # endpoints under "serve.<name>/<stage>", the chunked ingest
        # under "ingest"; None until a monitor registers
        "drift": drift.DRIFT.report(),
        # the scorer's last traversal plan and its launches by plan,
        # read off sys.modules: None until the inference module loaded
        "infer_kernel": _infer_kernel_report(),
        "shed": {
            "total": counters.get("serve.shed", 0.0),
            "by_reason": {k.split("serve.shed.", 1)[1]: v
                          for k, v in counters.items()
                          if k.startswith("serve.shed.")},
        },
        "fleet": _fleet_report(),
        "load": _load_report(),
    }
    if RECORDER.enabled:
        RECORDER.emit("health", "health.snapshot", args={
            "metrics": len(health["metrics"]),
            "audit_decisions": health["audit"]["decisions"],
            "slo_burn_rate": health["slo"]["burn_rate"]})
    return health


def annotate_regressions(findings) -> int:
    """Land regression verdicts (dicts: `regress.compare`'s findings, or
    `scripts/torch_bench_diff.py --json`'s) in the flight recorder as
    `regress.verdict` events, so an exported Chrome trace pins each one
    on the timeline next to the engine activity it indicts. Returns the
    number of events emitted (0 with the recorder off)."""
    if not RECORDER.enabled:
        return 0
    n = 0
    for f in findings:
        RECORDER.emit("regress", "regress.verdict", args=dict(f))
        n += 1
    return n


_fit_depth = threading.local()


@contextlib.contextmanager
def autolog_fit(estimator):
    """Wrap one Estimator.fit: with the recorder on, autologging enabled
    (`sml.obs.autoLogRunMetrics`) and a tracking run active on this
    thread, log the fit's `engine.*` metric DELTAS to the run (levels
    for rates and the peak bytes). Only the OUTERMOST fit on a thread
    logs: a Pipeline's stage fits and a CrossValidator's inner fits fold
    into their parent."""
    if not RECORDER.enabled:
        yield
        return
    depth = getattr(_fit_depth, "d", 0)
    _fit_depth.d = depth + 1
    before: Optional[Dict[str, float]] = None
    run = None
    try:
        if depth == 0 and GLOBAL_CONF.getBool("sml.obs.autoLogRunMetrics"):
            from .. import tracking
            run = tracking.active_run()
            if run is not None:
                before = engine_metrics()
        yield
    finally:
        _fit_depth.d = depth
        if run is not None and before is not None:
            after = engine_metrics()
            delta = {}
            for k, v in after.items():
                if k.endswith(("_rate", "_peak_bytes")):
                    delta[k] = v          # level metrics: log the level
                else:
                    delta[k] = v - before.get(k, 0.0)
            try:
                from .. import tracking
                tracking.log_engine_metrics(delta)
            except Exception:  # noqa: BLE001 — autologging never fails a fit
                pass
