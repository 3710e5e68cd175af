"""The seconds from the process's start to the window's: imports, the
data made from the seed, the warm-up (with any build of the kernels)."""


def read(rec):
    return rec["setup_s"]
