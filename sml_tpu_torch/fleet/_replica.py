"""One fleet replica: a ServingEndpoint with a pressure of its own.

The port's copy of `sml_tpu/fleet/_replica.py`. A replica is what the
router routes to, the autoscaler adds and retires and the rollout pins,
so it must be observable on its own (its own standing rows, not a share
of one global number) and killable on its own (a dead replica's batches
in flight must fail fast, so the router can re-route them).

- Pressure: the replica owns a `QueuePressure(parent=DEVICE_QUEUE)` and
  hands it to its endpoint's `MicroBatcher`: admissions feed both the
  replica's signal, which the router reads, and the process-wide one,
  which the dispatcher reads (every replica shares the one card).
- Killability: `_ReplicaEndpoint` checks the replica's poison flag on
  every card and host scoring call. `poison()` (a simulated crash, and
  the first step of `ReplicaPool.kill`) makes every batch in flight
  raise `ReplicaGone`, which the batcher lands on each request's future,
  and the router's `FleetFuture` re-routes on exactly that.

Every replica scores on the endpoint's device (the session's by default,
the card), with its own batcher thread: N replicas launch
`forest_traverse` from N flush threads through one shared scorer.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from ..parallel import dispatch
from ..serving._endpoint import ServingEndpoint


class ReplicaGone(RuntimeError):
    """The replica this work was queued on was killed or evicted; the
    router re-routes (or sheds) the request."""


class _ReplicaEndpoint(ServingEndpoint):
    """The replica's endpoint, with the poison check that makes a killed
    replica fail fast instead of serving."""

    def __init__(self, replica: "Replica", *args, **kwargs):
        # bound before the batcher exists: a scoring call comes only
        # through the batcher
        self._replica_ref = replica
        super().__init__(*args, **kwargs)

    def _score_device(self, X: np.ndarray) -> np.ndarray:
        self._replica_ref._check_poisoned()
        return super()._score_device(X)

    def _score_host(self, X: np.ndarray) -> np.ndarray:
        self._replica_ref._check_poisoned()
        return super()._score_host(X)

    def _drift_key(self) -> str:
        # N replicas of one model and stage must not share one drift
        # slot: a same-keyed registration clobbers the others', and the
        # last one's eviction would drop the survivors' coverage
        return (f"serve.{self._name}/{self._stage}"
                f"/r{self._replica_ref.rid}")


class Replica:
    """One warm serving replica of `models:/<name>/<stage>`."""

    def __init__(self, rid: int, name: str, stage: str = "Production",
                 **endpoint_kwargs):
        self.rid = int(rid)
        self._lock = threading.Lock()
        self._alive = True
        self._poisoned = False
        #: this replica's standing rows, chained into the process-wide
        #: DEVICE_QUEUE
        self.queue = dispatch.QueuePressure(parent=dispatch.DEVICE_QUEUE)
        self.endpoint = _ReplicaEndpoint(self, name, stage,
                                         queue=self.queue,
                                         **endpoint_kwargs)
        #: the admission bound the router's class ladder scales
        self.queue_bound = int(self.endpoint._batcher.queue_rows)

    # ---------------------------------------------------------------- state
    @property
    def alive(self) -> bool:
        with self._lock:
            return self._alive

    def _check_poisoned(self) -> None:
        with self._lock:
            poisoned = self._poisoned
        if poisoned:
            raise ReplicaGone(f"replica {self.rid} was killed")

    def poison(self) -> None:
        """Simulate a crash: every scoring call on this replica from now
        on raises ReplicaGone (landed on each request's future)."""
        with self._lock:
            self._poisoned = True
            self._alive = False

    def retire(self) -> None:
        """Graceful removal: no more router traffic; the queue drains."""
        with self._lock:
            self._alive = False

    # -------------------------------------------------------------- signals
    def pressure(self) -> int:
        """Standing rows queued toward the card on this replica."""
        return self.queue.rows()

    def occupancy(self) -> float:
        """pressure / admission bound: the autoscaler's band signal."""
        return self.queue.rows() / max(self.queue_bound, 1)

    def report(self) -> Dict[str, object]:
        return {
            "rid": self.rid,
            "alive": self.alive,
            "queue_rows": self.pressure(),
            "queue_bound": self.queue_bound,
            "occupancy": round(self.occupancy(), 4),
            "version": self.endpoint.current_version(),
            "pinned": self.endpoint.pinned_version(),
        }

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self.endpoint.close()

    def __repr__(self) -> str:
        return (f"Replica(rid={self.rid}, alive={self.alive}, "
                f"rows={self.pressure()})")
