"""The share of the traced window in which no operation ran on the
device (`trace.py`'s union of device activity)."""


def read(rec):
    t = rec["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
