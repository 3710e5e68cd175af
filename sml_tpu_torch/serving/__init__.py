"""Online scoring: registry-backed endpoints over a micro-batching server.

Counterpart of `sml_tpu/serving`. Three layers, composable separately:

- `ModelCache` (`_cache`): byte-bounded multi-model LRU of warm
  `DeviceScorer`s (`sml.serve.modelCacheBytes`), with the process-wide
  `MODEL_CACHE` the endpoints share.
- `MicroBatcher` (`_batcher`): concurrent requests coalesce into one
  `score_block` call (`sml.serve.maxBatchRows` rows or the
  `sml.serve.flushMicros` deadline, whichever first); admission is
  bounded by the rows queued toward the card (`dispatch.DEVICE_QUEUE`),
  and the overflow sheds, or takes the host route when the caller asks
  (`sml.serve.hostFallback`, off by default); queued requests past `sml.serve.requestTimeoutMillis` shed at
  flush time.
- `ServingEndpoint` (`_endpoint`): resolves a model from the tracking
  registry by name and stage alias ("Production"/"Staging"), serves it
  through the cache and the batcher, hot-swaps on stage transitions
  (the store fires `on_stage_transition`; nothing polls), and mirrors a
  fraction of traffic (`sml.serve.canaryFraction`) to the Staging
  version's host route, keeping prediction-divergence stats.
"""

from ._batcher import MicroBatcher, RequestShed, RequestTimeout, ScoreFuture
from ._cache import MODEL_CACHE, ModelCache
from ._endpoint import ServingEndpoint

__all__ = ["MODEL_CACHE", "MicroBatcher", "ModelCache", "RequestShed",
           "RequestTimeout", "ScoreFuture", "ServingEndpoint"]
