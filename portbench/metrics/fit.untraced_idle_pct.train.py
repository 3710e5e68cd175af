"""A check of the trace's coverage, not a speed: the share of the traced
window in which the device sat idle with no host range found open at
the gap's middle (`trace.py`'s `OUTSIDE_OPS`); None without a device
timeline. It reads host code that no recorded operation or program span
covers, and also gaps whose covering range opened more than the 64 host
events that `trace.py` looks back (a gap between two operations deep
inside `program.tree_ensemble`). A program change that speeds a fit
moves it only by the uncovered host time it takes away."""

from portbench.trace import OUTSIDE_OPS


def read(rec):
    t = rec["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * t["idle_by_host"].get(OUTSIDE_OPS, 0.0) / t["window_s"]
