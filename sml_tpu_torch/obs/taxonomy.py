"""Registered dotted-name taxonomy for spans, counters, and events.

The port's own registry, started from `sml_tpu/obs/taxonomy.py` with the
names the port's call sites add (the kernels' launch counters, the
port's program spans, the staging, binning and ingest spans). The
profiler report, the Chrome-trace exporter and the engine-metrics
autologger all key off these names; a call site inventing
`staging.h2dBytes` next to `staging.h2d_bytes` silently splits a metric
in two. Every `PROFILER.span`/`PROFILER.count` and
`RECORDER.emit/counter/gauge` and `METRICS.observe` call site under
`sml_tpu_torch/` is AST-checked against this registry by the port's
lint (rule `obs-taxonomy`, `sml_tpu_torch/lint/rules/taxonomy.py`), and
so are the kernel wrappers' launch counters (`KERNEL_LAUNCHES`).

Entries are exact names or `prefix.*` wildcards (wildcards cover the
f-string sites whose suffix is runtime data: the op behind a
`materialize.<op>` span, the fn behind `program.<name>`).
"""

from __future__ import annotations

from typing import Iterable

SPANS = {
    # frame engine
    "materialize.*",
    "shuffle.partition", "shuffle.dropDuplicates", "shuffle.join",
    "shuffle.sort", "shuffle.repartition",
    # ML engine
    "fused_transform", "binning.predict",
    "program.*",          # program.<fn> / program.tree_ensemble / ...
    # serving layer: one coalesced device dispatch of the micro-batcher
    "serve.batch",
    # per-device straggler attribution (obs/_skew.py): skew.compute /
    # skew.wait lanes rendered on the trace exporter's per-device process
    "skew.*",
    # chunked-ingest per-CHUNK attribution lanes (the INGEST_SKEW
    # tracker): ingest.compute / ingest.wait with "device" = chunk index
    "ingest.*",
    # the port's fit staging: host binning of a fit's rows (one span
    # around `_cached_bins`, or the folds' / grid's binning) and the
    # copy of its bins and labels onto the device
    "binning.fit", "staging.fit",
}

COUNTERS = {
    # stall watchdog (obs/_watchdog.py): flagged in-flight tickets
    "stall.*",
    # black-box postmortem (obs/blackbox.py): bundles written
    "blackbox.*",
    # out-of-core data plane (frame/_chunks.py + ml/_chunked.py):
    # ingest.chunks / ingest.rows / ingest.raw_bytes (float bytes the
    # chunk plane SAW but never held whole) / ingest.h2d_bytes (compact
    # chunk-block transfers) / ingest.sketch_compress / ingest.memo_hit
    "ingest.*",
    # the port's pipelined batch scoring (parallel/pipeline.py through
    # obs.note_pipeline): a batch's dispatch and drain
    "infer.dispatch", "infer.drain",
    "staging.cache_hit", "staging.cache_miss",
    "staging.bin_cache_hit", "staging.bin_cache_miss",
    "staging.h2d_bytes", "staging.d2h_bytes", "staging.h2d_bytes_saved",
    "staging.evict_bytes", "staging.bin_evict_bytes",
    "shuffle.rows", "shuffle.bytes",
    "cv.batchFolds.fallback",
    # fused tree kernels (native/hist_kernel.py, docs/KERNELS.md):
    # kernel.pallas_launch / kernel.interpret are TRACE-TIME statics
    # (counted once per program trace, like collective.*: launches per
    # execution = the count × executions); kernel.fallback counts fits
    # that requested pallas but degraded to the XLA path — bench_diff
    # treats any growth as a regression
    "kernel.*",
    # fused traversal kernel on the SCORING path (native/traverse_kernel
    # + ml/inference.py resolution): infer.kernel.pallas / infer.kernel.xla
    # count spec resolutions landing on each path; infer.kernel.fallback
    # counts dispatches that requested (or were tuned to) pallas but
    # demoted to XLA — obs/regress.py flags any growth, like
    # kernel.fallback; infer.kernel.autotune_s accumulates --kernelbench
    # sweep seconds (the cost the persisted manifest spec amortizes away)
    "infer.kernel.*",
    "compile.programs",
    "compile.program.*",  # per-name program-cache-miss counts (bench
                          # derives distinct-programs-per-leg from these)
    "tree.fit_dispatch",  # device launches of tree-fit programs (the
                          # grid-fused CV dispatch-count contract)
    # prewarm manifest (parallel/prewarm.py): recorded signatures,
    # replayed/failed first-dispatches, pool-size attribution
    "prewarm.*",
    "dispatch.route_*",   # dispatch.route_host / dispatch.route_device
    "collective.*",       # per-trace collective launch counts PLUS the
                          # per-op payload-byte counters
                          # (collective.psum_bytes / pmean_bytes / ...):
                          # one launch's ICI allreduce volume, recorded at
                          # trace time from the operand's static shape —
                          # the *_bytes suffix puts them on the trace
                          # exporter's counter tracks
    # serving layer (sml_tpu/serving): request admission, micro-batch
    # dispatches, degradation ladder, model cache, canary mirror
    "serve.requests", "serve.rows",
    "serve.batches", "serve.batch_rows", "serve.batch_pad_rows",
    "serve.shed", "serve.expired", "serve.host_routed",
    # reason-tagged shed attribution next to the serve.shed total:
    # serve.shed.overflow (queue saturated, host fallback off) /
    # serve.shed.deadline (expired before its batch flushed) /
    # serve.shed.closed (submitted to a closing batcher) — so
    # engine_health()["shed"] and the fleet router see shed rate per
    # CAUSE, not one undifferentiated count
    "serve.shed.*",
    "serve.hot_swap",
    # a caller's BOUNDED result(timeout=) wait expired before the batch
    # resolved the future (serving/_batcher.py RequestTimeout): the
    # future stays resolvable — this counts impatient callers, not
    # dropped requests, distinct from serve.expired (deadline sheds)
    "serve.timeout",
    "serve.model_cache_hit", "serve.model_cache_miss",
    "serve.model_cache_evict_bytes",
    "serve.canary_mirrored",
    # canary shadow scores that DIED (the _mirror worker raised): a dead
    # canary must show up in canary_stats()/health_report() instead of
    # silently reporting zero divergence
    "serve.canary_error",
    # model & data drift (obs/drift.py): drift.chunk_flagged counts
    # ingest chunks whose sketch drifted past threshold (the
    # refit-trigger signal); drift.observe_error counts serving
    # observation callbacks that raised (observation must never fail a
    # flush, but a dead observer must be visible)
    "drift.*",
    # continuous training (sml_tpu/ct): ct.cycles / ct.refit_warm /
    # ct.refit_full / ct.promotions / ct.rollbacks (gate outcomes
    # applied to the registry) / ct.gate_pass / ct.gate_fail (verdicts)
    # / ct.checkpoints / ct.resumes (round-level boost restartability)
    # / ct.cycle_error (background-loop cycles that raised — the loop
    # survives, the failure is visible)
    "ct.*",
    # elastic multi-host fits (sml_tpu/ct/_elastic.py): elastic.resume
    # (one HostPreempted caught and resumed from the newest round-level
    # checkpoint) / elastic.repartition (the chunk ranges re-split to
    # the surviving host-group count) — paired 1:1 today, kept separate
    # so a future rebalance-without-preemption path counts honestly
    "elastic.*",
    # multi-replica serving fleet (sml_tpu/fleet): fleet.requests /
    # fleet.requests.<class> (router admissions by priority class) /
    # fleet.shed + fleet.shed.<class> (router-level priority sheds) /
    # fleet.reroutes (requests re-routed off a dead replica) /
    # fleet.replicas_started / fleet.replicas_evicted /
    # fleet.scale_up / fleet.scale_down (autoscaler band actions) /
    # fleet.autoscale_error (background steps that raised — the loop
    # survives, the failure is visible) / fleet.rollouts /
    # fleet.rollout_promotions / fleet.rollout_rollbacks (staged
    # rollout outcomes) / fleet.burst_tighten (admission pre-tightened
    # because the burn-rate SLOPE predicted an SLO breach within
    # sml.fleet.burstSlopeHorizonSec — burst anticipation)
    "fleet.*",
    # registry stage-transition listeners that RAISED (the commit
    # landed; later listeners still fired): a dead subscriber must be
    # visible in the counters, like serve.canary_error
    "tracking.listener_error",
    # open-loop trace-driven load harness (sml_tpu/loadgen): load.requests
    # / load.served / load.shed / load.timeout / load.errors fired per
    # scheduled request outcome, and load.overrun — requests the bounded
    # worker pool fired LATER than their scheduled arrival instant (the
    # schedule outran the pool; never silent, the committed gate requires
    # zero)
    "load.*",
    # graftlint gate receipts (bench.py --lint): lint.runs /
    # lint.violations (unsuppressed — 0 on any recorded run, the gate
    # refuses otherwise) / lint.suppressed_pragma /
    # lint.suppressed_baseline / lint.rules (active rule count) /
    # lint.rule.<name> per-rule live-violation counts — obs/regress.py
    # flags a violation-count increase or a rule-count decrease between
    # committed sidecars
    "lint.*",
}

GAUGES = {
    "hbm.*",              # hbm.<pool>_bytes / hbm.total_bytes
    "serve.queue_rows",   # rows admitted but not yet dispatched
    "serve.flush_micros",  # the micro-batcher's LIVE flush deadline —
                          # conf-static unless sml.serve.flushAutoTune
                          # adapts it between the audit's predicted
                          # drain and the SLO budget
    "slo.*",              # slo.burn_rate: breach fraction vs the
                          # sml.serve.sloMillis error budget, stamped by
                          # obs.engine_health()
    "drift.*",            # drift.max_severity / drift.features_flagged:
                          # the worst live-vs-baseline distance (as a
                          # multiple of its noise-aware threshold) and
                          # the flagged-feature count, stamped by every
                          # DriftMonitor.report()
    "fleet.*",            # fleet.replicas (live replica count, stamped
                          # on every pool topology change) /
                          # fleet.occupancy (the autoscaler's band
                          # signal at each step)
}

EVENTS = {
    "dispatch.*",         # dispatch.host / dispatch.device
    "cache.*",            # cache.evict / ...
    "collective.*",       # collective.psum / ...
    "compile.*",          # compile.trace / compile.cache_dir
    "serve.*",            # serve.swap (endpoint hot-swap receipts)
    "infer.*",            # infer.dispatch / infer.drain (batch pipelining)
                          # + infer.kernel.spec (a scoring dispatch's
                          # resolved traversal spec CHANGED: kernel,
                          # block_rows, tuned-or-conf provenance)
    "ingest.*",           # ingest.dispatch / ingest.drain (chunk-i+1
                          # H2D overlapping chunk-i device work — the
                          # double-buffered prefetch proof) + ingest.note
                          # (per-chunk skew attribution summaries)
    "prewarm.*",          # prewarm.start / prewarm.replay / prewarm.done
    "skew.*",             # skew.note (per-program attribution summary)
                          # plus the skew.compute/skew.wait per-device
                          # lanes emitted as kind="span" through the raw
                          # RECORDER.emit path
    "health.*",           # health.snapshot (engine_health() receipts)
    "regress.*",          # regress.verdict (bench_diff annotations)
    # causal tracing (obs/_context.py): trace.request admission spans
    # (emitted as kind="span" so the exporter lands them on the
    # admitting thread's lane — the flow arrows' source anchor). Trace
    # ids themselves are not names: they ride event args ("trace",
    # "span", "parent_traces", "parent_spans") and METRICS observations
    # as per-bucket EXEMPLARS, so no registry entry can rot
    "trace.*",
    # stall watchdog (obs/_watchdog.py): stall.detected (with all-thread
    # stack snapshot args) / stall.resolved
    "stall.*",
    # black-box postmortem (obs/blackbox.py): blackbox.dump receipts
    "blackbox.*",
    # model & data drift (obs/drift.py): drift.report (per-monitor
    # verdict receipts with the flagged-feature list) and drift.chunk
    # (one ingest chunk's sketch judged against the baseline)
    "drift.*",
    # continuous training (sml_tpu/ct): ct.cycle (one trainer cycle's
    # action receipt), ct.refit (a scheduled warm/full refit),
    # ct.promote (canary gate passed — Production moved), ct.rollback
    # (gate failed — candidate archived, blackbox bundle path in args)
    "ct.*",
    # elastic multi-host fits (sml_tpu/ct/_elastic.py): elastic.resume
    # receipts carrying from_hosts/to_hosts, the dead group, and the
    # rows whose host assignment moved under the re-partition
    "elastic.*",
    # multi-replica serving fleet (sml_tpu/fleet): fleet.route (one
    # router decision: replica, priority class, the request's trace id
    # — the router half of the fan-in chain) / fleet.reroute (a
    # request re-routed off a dead replica, old + new trace ids) /
    # fleet.replica_start / fleet.replica_evict (teardown receipts,
    # blackbox bundle path in args) / fleet.scale (autoscaler band
    # action receipts) / fleet.rollout_stage (one replica's gate
    # verdict during a staged rollout) / fleet.rollout (the rollout's
    # final promote/rollback verdict)
    "fleet.*",
    # open-loop load harness (sml_tpu/loadgen): load.phase (the replay
    # loop crossing a trace-phase boundary) / load.run (one replay
    # run's outcome receipt: requests, overruns, per-phase counts)
    "load.*",
}

# streaming-metrics histograms (obs/_metrics.py METRICS.observe): latency
# and size distributions kept as log-bucketed counts, NOT recorder events
METRICS_NAMES = {
    "serve.request_ms",   # micro-batcher admission -> result per request
    "serve.batch_ms",     # one flush's launch+drain wall at the flush
                          # site — the drain floor the flush auto-tuner
                          # reads (sml.serve.flushAutoTune), exemplar =
                          # the flush's fan-in trace id
    "serve.canary_abs_diff",  # per mirrored request: max |shadow -
                          # primary| prediction divergence, exemplar =
                          # the request's trace id — canary_stats()
                          # reports windowed quantiles and the literal
                          # worst-diverging request from this histogram
    "dispatch.*",         # dispatch.host_ms / dispatch.device_ms: measured
                          # walls of routed programs (fed by the audit's
                          # attach path)
    "load.*",             # open-loop harness latencies, SCHEDULED-arrival
                          # -> result (queueing charged to the system, not
                          # hidden in the client): load.request_ms plus the
                          # per-phase load.request_ms.<phase> and
                          # per-phase/class load.request_ms.<phase>.<class>
                          # families, exemplar = the request's trace id
}

# the port's kernel wrappers' launch counts (`LAUNCHES` in
# native/traverse_kernel.py, native/hist_kernel.py and
# native/prng_kernel.py): each wrapper adds one where it launches its
# kernel on the card and nowhere else; `chip_smoke.py` reads them around
# every main path. Not recorder names: the wrappers count with the
# recorder off
KERNEL_LAUNCHES = {
    "forest_traverse",    # csrc/forest_traverse.cu
    "hist_accumulate",    # csrc/hist_accumulate.cu
    "split_scan",         # csrc/split_scan.cu
    "row_weights",        # csrc/threefry.cu
    "feature_mask",       # csrc/threefry.cu
}

_BY_KIND = {"span": SPANS, "count": COUNTERS, "counter": COUNTERS,
            "gauge": GAUGES, "emit": EVENTS, "observe": METRICS_NAMES,
            "launch": KERNEL_LAUNCHES}


def _match(name: str, registry: Iterable[str]) -> bool:
    for entry in registry:
        if entry.endswith("*"):
            if name.startswith(entry[:-1]):
                return True
        elif name == entry:
            return True
    return False


def is_registered(kind: str, name: str) -> bool:
    """Exact-name check (`kind` is the call-site method: span / count /
    counter / gauge / emit)."""
    reg = _BY_KIND.get(kind)
    return reg is not None and _match(name, reg)


def prefix_registered(kind: str, prefix: str) -> bool:
    """f-string check: the literal prefix before the first interpolation
    must sit under some wildcard entry (a dynamic suffix can only be
    legal when the family itself is registered)."""
    reg = _BY_KIND.get(kind)
    if reg is None:
        return False
    for entry in reg:
        if entry.endswith("*") and prefix.startswith(entry[:-1]):
            return True
    return False
