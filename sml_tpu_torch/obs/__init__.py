"""sml_tpu_torch.obs — the port's flight recorder, its core.

Counterpart of the part of `sml_tpu/obs` that the dispatcher, the
serving path and prewarm write to, on ONE structured event bus:

- `RECORDER` (`_recorder`): typed events (spans, counters, dispatch
  decisions, serving flushes and swaps, prewarm replays, pipeline
  stages) in a bounded ring with an optional JSONL sink
  (`sml.obs.sinkPath`, the JAX package's record format). Enabled by
  `sml.obs.enabled`; disabled it costs one attribute load per
  instrumentation site.
- `audit_report()` (`_audit`): every `dispatch.decide` with its
  predicted host and device times and the routed program's measured
  wall: calibration drift and would-have-been-faster misroutes.
- `METRICS` (`_metrics`): streaming log-bucketed histograms (latency
  quantiles and rates without kept samples); `slo_report()` reads the
  serving path's.
- `TraceContext` (`_context`): a context minted at serving admission
  rides contextvars (handed across threads explicitly) through the
  micro-batch fan-in and the program spans.
- `WATCHDOG` (`_watchdog`): in-flight stall detection for routed
  program spans, micro-batch flushes, pipeline stages and prewarm
  replays, with all-thread stacks on a stall.

The rest of the JAX package's obs (drift, skew, the regression gate,
blackbox bundles, the event taxonomy, the memory ledger, the Chrome-trace
export, `autolog_fit` and `engine_health`) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..conf import GLOBAL_CONF
from . import _audit, _context
from ._audit import records as audit_records, report as audit_report
from ._context import TraceContext, activate as activate_trace, \
    current as current_trace, hex_id as trace_hex, new_trace
from ._metrics import METRICS, LogHistogram, merge_snapshots
from ._recorder import RECORDER, Event
from ._watchdog import WATCHDOG, all_thread_stacks

__all__ = ["RECORDER", "Event", "METRICS", "WATCHDOG",
           "TraceContext", "current_trace", "new_trace", "activate_trace",
           "trace_hex", "all_thread_stacks", "LogHistogram",
           "merge_snapshots", "audit_report", "audit_records",
           "engine_metrics", "slo_report", "note_pipeline", "reset",
           "enabled"]


def enabled() -> bool:
    return RECORDER.enabled


def reset() -> None:
    """Drop recorded events, audit records, metric histograms and
    watchdog statistics (OPEN watchdog tickets persist: they describe
    real in-flight work)."""
    RECORDER.reset()
    _audit.reset()
    METRICS.reset()
    WATCHDOG.reset()


def note_pipeline(family: str, phase: str, key: str, index: int) -> None:
    """Staging-pipeline event emitter (`parallel/pipeline.py`):
    `<family>.<phase>` with family "infer" (batch inference) or "ingest"
    (chunked ingest)."""
    if RECORDER.enabled:
        RECORDER.emit(family, family + "." + phase, args={key: index})


def _peak_device_bytes() -> float:
    """The card's peak allocated bytes in this process (0 before the
    card is first used): the port's stand-in for the JAX package's
    memory ledger, which is not ported yet."""
    import torch
    if not torch.cuda.is_initialized():
        return 0.0
    return float(torch.cuda.max_memory_allocated())


def engine_metrics() -> Dict[str, float]:
    """The engine's health snapshot as flat `engine.*` metrics: byte
    volumes, cache hit rates, route mix, peak device bytes. Sourced from
    the recorder's own totals, so it counts what happened while the
    recorder was on."""
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
        "engine.hbm_peak_bytes": _peak_device_bytes(),
        "engine.shuffle_rows": t.get("shuffle.rows", 0.0),
    }


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
