"""Times one checkout's port wrappers and traversal kernel, on one card.

    python3 scripts/torch_wrapper_host_time.py [ROOT] [--reps N]

Imports `sml_tpu_torch` from ROOT (a checkout of the repository; the
repository itself by default), builds its kernels, and prints beside the
card's name and power limit:

- the median host time of one `hist_accumulate` call (ML 11: 80,000
  rows, F=10, B=64, uint8, S=16) and one `split_scan` call (ML 11:
  W=32), perf_counter around each call with no synchronise
  (`chip_smoke.wrapper_host_us`);
- `forest_traverse` at the ML 11 shape (40 trees, depth 6, 10 features,
  uint8 bins) at 64, 4,096 and 100,000 rows, on the operands
  `chip_smoke.py` phase 5 times: the CUDA-event median of one call and
  the device time of the kernel's own launches by `torch.profiler`, over
  N calls (`chip_smoke.traverse_ms`).

Run it on two checkouts in one call to compare them: parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAVERSE_ROWS = (64, 4096, 100_000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)   # the sml_tpu_torch under test
    import torch
    if not torch.cuda.is_available():
        print("torch_wrapper_host_time: no CUDA device", file=sys.stderr)
        return 2
    # this repository's chip_smoke, whatever ROOT holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import sml_tpu_torch
    pkg = os.path.dirname(os.path.abspath(sml_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"imported {pkg}, not the package under {root}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    host = chip_smoke.wrapper_host_us(device)
    traverse = {}
    for n_rows in TRAVERSE_ROWS:
        ops = chip_smoke.ml11_operands(args.seed, n_rows, device)
        k_ms, d_ms = chip_smoke.traverse_ms(ops, args.reps)
        traverse[n_rows] = {"event_ms": k_ms, "device_ms": d_ms}
    print(json.dumps({"root": root, "host_us": host,
                      "forest_traverse": traverse,
                      "card": chip_smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
