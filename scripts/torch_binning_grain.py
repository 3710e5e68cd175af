"""Times the port's host binning under several thread grains.

    python3 scripts/torch_binning_grain.py [--calls N]

Builds `csrc/binning.cc` once with its default grain and once for each
of `GRAINS` (the least cells a worker thread takes, the macro
`SML_BIN_CELLS_PER_WORKER`), and prints, for the search of `bin_with`
on the ML 11 model of `chip_smoke.py` at 64, 4,096, 20,000 and 100,000
fresh rows, the median host time of one `_bin_columns` call under each
build beside `_bin_columns_plain` (NumPy), twice in turns, with the
machine's name, its CPU count and, where there is a card, the card's
name and power limit. Every build's bins equal NumPy's.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAINS = (1 << 10, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16)
ROWS = (64, 4096, 20_000, 100_000)


def kernels(lib) -> dict:
    fns = {}
    for name in ("sml_bin_matrix", "sml_bin_matrix_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = None
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=21)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke
    from sml_tpu_torch.ml import tree_impl
    from sml_tpu_torch.native import binning, build
    card = (chip_smoke.card_line() if shutil.which("nvidia-smi")
            else "no card")
    print(f"{os.cpu_count()} CPUs; card {card}")
    builds = {"default": kernels(build.load("binning"))}
    for g in GRAINS:
        builds[str(g)] = kernels(build.load(
            "binning", (f"SML_BIN_CELLS_PER_WORKER={g}",)))
    model, cats = chip_smoke.ml11_model(0)
    bn = model._spec.binning
    edges, dtype = tree_impl.binning_edges_and_dtype(bn)
    for n in ROWS:
        X, _ = chip_smoke.ml11_rows(np.random.default_rng([0, 14, n]), n,
                                    cats)
        res = {}
        for _ in range(2):
            for name, fns in builds.items():
                binning._fns = fns
                ms, got = chip_smoke._median_ms(
                    lambda: tree_impl._bin_columns(
                        X, edges, bn.cat_remap, dtype), args.calls)
                res.setdefault(name, []).append(ms)
            ms, want = chip_smoke._median_ms(
                lambda: tree_impl._bin_columns_plain(
                    X, edges, bn.cat_remap, dtype), args.calls)
            res.setdefault("numpy", []).append(ms)
            if not np.array_equal(got, want):
                raise AssertionError(f"bins differ at {n} rows")
        print(f"rows={n}: " + ", ".join(
            f"{k} {v}" for k, v in res.items()) + " ms (host clock, median "
            f"of {args.calls} calls, two turns)")
    binning._fns = {}
    return 0


if __name__ == "__main__":
    sys.exit(main())
