"""A kernel's share of its roofline: the least time of every recorded
call of its wrapper (`roofline.py`, from the call's shapes) over the
device time of the kernel's launches in the traced window."""

from portbench import roofline

#: device kernel names of each wrapper (substrings of the short name)
KERNELS = {
    "hist_accumulate": ("hist_cluster_kernel", "hist_reduce_kernel"),
    "split_scan": ("split_scan_kernel",),
    "row_weights": ("row_weights_kernel",),
}


def least_s(wrapper, call, shape):
    if wrapper == "hist_accumulate":
        return roofline.hist_s(*call)
    if wrapper == "split_scan":
        return roofline.scan_s(*call)
    rounds, elements, n_pad = call
    return roofline.row_weights_s(rounds, elements, n_pad, shape["mode"],
                                  shape["rate"])


def share(rec, wrapper):
    calls = rec["calls"].get(wrapper) or []
    device_s = sum(v[0] for k, v in rec["trace"]["kernels"].items()
                   if any(n in k for n in KERNELS[wrapper]))
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(least_s(wrapper, c, rec["shape"]) for c in calls) \
        / device_s
