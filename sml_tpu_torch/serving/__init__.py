"""Online scoring: the micro-batching server over `DeviceScorer.score_block`
(`_batcher`) and the byte-bounded cache of warm scorers (`_cache`).

`ServingEndpoint` of the JAX package, which resolves models through the
tracking registry, is not ported yet; a server is `MicroBatcher` over a
`DeviceScorer`'s `score_block`, which is what that endpoint wires
together.
"""

from ._batcher import MicroBatcher, RequestShed, RequestTimeout, ScoreFuture
from ._cache import ModelCache

__all__ = ["MicroBatcher", "ModelCache", "RequestShed",
           "RequestTimeout", "ScoreFuture"]
