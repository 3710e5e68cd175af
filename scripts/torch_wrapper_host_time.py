"""Host time of one call of the port's fit-kernel wrappers, on one card.

    python3 scripts/torch_wrapper_host_time.py [ROOT]

Imports `sml_tpu_torch` from ROOT (a checkout of the repository; the
repository itself by default), builds its kernels, and prints the median
host time of one `hist_accumulate` call (ML 11: 80,000 rows, F=10, B=64,
uint8, S=16) and one `split_scan` call (ML 11: W=32), perf_counter around
each call with no synchronise (`chip_smoke.wrapper_host_us`), beside the
card's name and power limit. Run it on two checkouts in one call to
compare their wrappers: parent, change, change, parent.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else HERE)
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
    host = chip_smoke.wrapper_host_us(torch.device("cuda", 0))
    print(json.dumps({"root": root, "host_us": host,
                      "card": chip_smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
