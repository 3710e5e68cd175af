"""The one-card counterpart of `sml_tpu/parallel/mesh.py`.

There is no mesh, no sharding and no collective on one card: a caller
names a device, or gets the CUDA card. Entry points run on the card
unless the caller asks for the CPU; asking for CUDA where there is none
raises instead of carrying on somewhere else.

`run_placed_trials` is the one-card form of the JAX package's placed
trials: tuning's trials run `parallelism` worker threads wide, all on
the session's device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a `torch.device`; None means the CUDA card.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and this process has no usable CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available to this process; the port runs "
            "on the card by default — pass device='cpu' to run the plain "
            "PyTorch versions on the host instead")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def session_device() -> torch.device:
    """The device of the DataFrame entry points: the `sml.device` key,
    through `resolve_device` (so a missing card raises)."""
    from .conf import GLOBAL_CONF
    return resolve_device(GLOBAL_CONF.get("sml.device"))


def run_placed_trials(jobs: Sequence, fn: Callable, parallelism: int
                      ) -> List:
    """`fn(job)` for every job, `parallelism` worker threads wide, all on
    the session's device (one card has one layout; the JAX package gives
    each worker its own submesh). Results come back in job order. An
    exception in a trial propagates."""
    jobs = list(jobs)
    session_device()  # no card: raise before any trial starts
    parallelism = max(1, int(parallelism))
    if parallelism <= 1 or len(jobs) <= 1:
        return [fn(job) for job in jobs]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(parallelism, len(jobs))) as pool:
        return list(pool.map(fn, jobs))
