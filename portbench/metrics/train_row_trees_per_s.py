"""Training rows times trees of every fit completed in the window, over
the time from the window's start to the end of the last of them."""


def read(rec):
    fits = rec["fits"]
    if not fits:
        return None
    return sum(f["rows"] * f["trees"] for f in fits) / fits[-1]["end"]
