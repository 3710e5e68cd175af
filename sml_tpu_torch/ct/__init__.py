"""Continuous training: live micro-batches, warm-start refits on drift,
canary-gated promotion.

The port's copy of `sml_tpu/ct`:

- **Live sources** (`_sources`): `StreamChunkSource` reads a memory-sink
  `StreamingQuery`'s committed micro-batches as chunks;
  `DeltaChunkSource` the add files of the Delta versions past a
  watermark. Both freeze a `snapshot()` window (both ingest passes
  stream the same rows), and `advance()` consumes it.
- **Round-level checkpoints** (`_checkpoint`): `BoostCheckpoint`,
  `checkpointed_fit` and `checkpointed_warm_start`, so an interrupted
  boosting fit resumes from its last segment boundary, bit for bit.
- **The controller** (`_trainer.ContinuousTrainer`): each cycle judges
  the window against the Production model's training baseline through
  the ingest drift monitor, refits warm (rounds appended) or full when
  the severity clears `sml.ct.warmSeverity` / `sml.ct.fullSeverity`,
  tracks the refit as a run and a registered version, and promotes it
  through the canary gate, or through a fleet's staged rollout.
- **The canary gate** (`_gate.CanaryGate`): the candidate, in Staging,
  is mirrored on the live endpoint's traffic (`sml.serve.canaryFraction`)
  and promoted only when the mirror has its quorum with no error and a
  finite divergence, and its RMSE on the window clears
  `sml.ct.gateQualityTol`; a failed gate archives it and dumps a
  black-box bundle.
- **Elastic fits** (`_elastic`): `elastic_fit`, a `checkpointed_fit` on
  a host mesh of ranks that resumes on the surviving host groups after
  a `HostPreempted` (`sml.ct.elasticResume`,
  `sml.ct.elasticMaxRestarts`).
"""

from __future__ import annotations

from ..conf import _register, _to_bool

_register("sml.ct.warmSeverity", 1.0, float,
          "Drift severity (the largest live-against-baseline distance as "
          "a multiple of its noise-aware threshold, from the ingest drift "
          "monitor) at or above which a trainer cycle runs a WARM-START "
          "refit: sml.ct.warmRounds boosting rounds appended on the "
          "drifted window under the saved model's bin edges. 1.0 = any "
          "flagged feature triggers")
_register("sml.ct.fullSeverity", 100.0, float,
          "Drift severity at or above which the refit is FULL instead of "
          "warm: re-sketch, re-bin and refit from scratch on the fresh "
          "window. A window of another width always refits full")
_register("sml.ct.warmRounds", 8, int,
          "Boosting rounds appended by one warm-start refit (a full refit "
          "uses the trainer's fit_params n_trees)")
_register("sml.ct.minRefitRows", 512, int,
          "Least rows in the source's fresh window before a trainer cycle "
          "judges it: smaller windows keep accumulating (the watermark "
          "does not advance)")
_register("sml.ct.pollSec", 2.0, float,
          "ContinuousTrainer.start() interval: seconds between the "
          "background thread's cycles")
_register("sml.ct.canaryMinMirrored", 8, int,
          "Canary-gate quorum: shadow scores of the Staging candidate "
          "(sml.serve.canaryFraction mirroring on the live endpoint) "
          "before the gate judges; a quorum unmet within "
          "sml.ct.gateTimeoutSec fails the gate")
_register("sml.ct.gateTimeoutSec", 20.0, float,
          "Canary-gate wall bound: seconds the gate waits for its mirror "
          "quorum before it calls the canary unobservable (the gate "
          "fails closed)")
_register("sml.ct.gateQualityTol", 1.1, float,
          "Promotion quality bar: the candidate's RMSE on the gate window "
          "must be at most the incumbent's times this tolerance")
_register("sml.ct.elasticResume", True, _to_bool,
          "Elastic multi-host fits: when a host group is preempted "
          "mid-fit (ct.elastic_fit catches HostPreempted), rebuild the "
          "host mesh over the surviving groups, re-partition the chunk "
          "ranges, and resume from the newest round-level checkpoint. "
          "Off = the preemption propagates to the orchestrator (every "
          "resume still counts elastic.resume / elastic.repartition)")
_register("sml.ct.elasticMaxRestarts", 3, int,
          "Resume budget of one elastic_fit call: preemptions beyond "
          "this many mesh rebuilds propagate instead of resuming (a "
          "fleet losing hosts faster than it fits should fail loudly, "
          "not shrink to a single group)")
_register("sml.ct.gateRows", 2048, int,
          "Rows of the fresh window replayed through the endpoint as gate "
          "traffic (and the quality check's sample)")

from ._checkpoint import (BoostCheckpoint, checkpointed_fit,  # noqa: E402
                          checkpointed_warm_start)
from ._elastic import HostPreempted, elastic_fit  # noqa: E402
from ._gate import CanaryGate  # noqa: E402
from ._sources import DeltaChunkSource, StreamChunkSource  # noqa: E402
from ._trainer import ContinuousTrainer  # noqa: E402

__all__ = ["StreamChunkSource", "DeltaChunkSource", "BoostCheckpoint",
           "checkpointed_fit", "checkpointed_warm_start", "CanaryGate",
           "ContinuousTrainer", "HostPreempted", "elastic_fit"]
