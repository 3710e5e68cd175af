"""Kernel launches (the host's runtime-API launch calls in the traced
window) over the tree levels the traced fits grew (trees x depth a fit)."""


def read(rec):
    levels = sum(f["trees"] * f["depth"] for f in rec["fits"])
    launches = rec["trace"]["launches"]
    if levels <= 0 or launches <= 0:
        return None
    return launches / levels
