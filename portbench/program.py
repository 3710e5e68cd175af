"""The boundary to the system under test, the port (`sml_tpu_torch`).

The benchmark takes from the program only its public estimators, what
their calls return (read by `kinds/<kind>.py`), and, in a traced run,
its spans (`PROFILER`, `sml.profiler.enabled`) and the calls of its
kernel wrappers, recorded from this file around the module attributes
the fit loop calls them through.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, List

import numpy as np

#: wrappers recorded in a traced run: (module, function) of the port
WRAPPERS = {
    "hist_accumulate": ("sml_tpu_torch.native.hist_kernel", "hist_accumulate"),
    "split_scan": ("sml_tpu_torch.native.hist_kernel", "split_scan"),
    "row_weights": ("sml_tpu_torch.native.prng_kernel", "fit_row_weights"),
}
#: the fit's span in the program's profiler
FIT_SPAN = "program.tree_ensemble"


def estimator(cfg: dict, rounds: int = None):
    """The configuration's estimator; `rounds` overrides its round
    count (the warm-up)."""
    est = cfg["estimator"]
    module, _, name = est["class"].rpartition(".")
    cls = getattr(importlib.import_module(module), name)
    params = dict(est["params"])
    if rounds is not None:
        params[est["rounds_param"]] = int(rounds)
    return cls(**params)


def call(est, entry: str, X: np.ndarray, y: np.ndarray, device=None):
    """One call of the estimator's public matrix entry (`fit`): on the
    card by default."""
    method = getattr(est, entry)
    if device is None:
        return method(X, y)
    return method(X, y, device=device)


def free_caches() -> None:
    """Drop the port's device copies of staged bins."""
    from sml_tpu_torch.ml._staging import clear_bin_cache
    clear_bin_cache()


@contextlib.contextmanager
def recorded(calls: Dict[str, List[tuple]]):
    """Record the operand shapes of every wrapper call in `calls` (by
    wrapper name) and keep the program's spans, for the enclosed
    block. A wrapper the port no longer has is left out."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.utils.profiler import PROFILER
    patched = []
    for name, (module, attr) in WRAPPERS.items():
        mod = importlib.import_module(module)
        fn = getattr(mod, attr, None)
        if fn is None:
            continue
        calls.setdefault(name, [])

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls[_name].append(_shape(_name, args, kwargs))
            return _fn(*args, **kwargs)
        setattr(mod, attr, wrapper)
        patched.append((mod, attr, fn))
    was = GLOBAL_CONF.getBool("sml.profiler.enabled")
    GLOBAL_CONF.set("sml.profiler.enabled", True)
    PROFILER.reset()
    try:
        yield
    finally:
        GLOBAL_CONF.set("sml.profiler.enabled", was)
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def span_seconds() -> float:
    """The seconds of the program's fit spans kept so far, and reset."""
    from sml_tpu_torch.utils.profiler import PROFILER
    total = sum(s.wall_s for s in PROFILER.spans() if s.name == FIT_SPAN)
    PROFILER.reset()
    return total


def _shape(name: str, args, kwargs) -> tuple:
    """A wrapper call's shapes, read without touching device values."""
    if name == "hist_accumulate":
        binned = args[0]
        return (int(binned.shape[0]), int(binned.shape[1]),
                int(kwargs["n_bins"]), int(kwargs["n_slots"]),
                int(binned.element_size()))
    if name == "split_scan":
        hist = args[0]
        return tuple(int(s) for s in hist.shape[:3])
    keys = args[0]
    return (int(keys.shape[0]), int(keys.shape[1]), int(args[4]))
