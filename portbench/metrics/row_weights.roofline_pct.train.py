"""`row_weights`'s share of its roofline over the traced fits
(`_kernel_share.py`)."""

from portbench.metrics._kernel_share import share


def read(rec):
    return share(rec, "row_weights")
