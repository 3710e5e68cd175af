"""The whole fit's share of the card's peak: the least time of a fit's
necessary work (`roofline.fit_s`, from the cell's shapes alone) over the
traced fits' mean wall. It stays put when a change fuses or drops a
kernel, and bounds what any kernel's share can gain end to end."""

from portbench import roofline


def read(rec):
    fits = rec["fits"]
    if not fits:
        return None
    s = rec["shape"]
    wall = sum(f["wall_s"] for f in fits) / len(fits)
    need = roofline.fit_s(s["n"], s["F"], s["B"], s["D"], s["T"],
                          s["boosting"], s["mode"] != "ones")
    return 100.0 * need / wall
