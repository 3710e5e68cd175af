"""Where the port's `forest_traverse` kernel spends a launch, on one card.

    python3 scripts/torch_traverse_phases.py [--plans]

Builds `sml_tpu_torch/csrc/forest_traverse.cu` with -DSML_TRAVERSE_STAMPS
(thread 0 of each block records `clock64()` at the end of each phase;
`STAMP` in the source) into `sml_tpu_torch/native/build/` (gitignored),
and launches it at the ML 11 shape (40 trees, depth 6, 10 features,
uint8 bins; `chip_smoke.SHAPES[0]`) at 64, 4,096 and 100,000 rows with
the plan `traverse_plan` gives. It checks each result bit for bit
against `forest_margin_plain` and prints, per row count, the median over
blocks of the SM cycles of each phase (`PHASES`, in the order of the
source's stamps). With --plans it also prints the device time
(`chip_smoke.device_ms`) of the kernel built without stamps under other
tile sizes and tree groups at those row counts. The card's name, power
limit and its most SM clock are printed beside the numbers.
"""

from __future__ import annotations

# torchlint: disable-file=kernel-launch-outside-native -- a measurement script: it builds the traversal kernel with its phase stamps (-D SML_TRAVERSE_STAMPS) and reads them from a direct launch

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (64, 4096, 100_000)
#: (tile rows, tree groups) timed beside the plan's own, with --plans
OTHER_PLANS = {64: ((32, 16), (64, 1)), 4096: ((64, 16), (32, 1)),
               100_000: ((384, 2), (256, 4), (1024, 1))}
#: the phases that end at stamps 1, 2, ... of the source (stamp 0 is the
#: kernel's start)
PHASES = ("load and pack the tables", "complete early leaves",
          "first bins and every warp", "descend tile 0", "rest")
#: blocks and stamps a block of the source's stamp array
STAMP_BLOCKS, STAMPS = 256, 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_traverse_phases: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from sml_tpu_torch.native import build
    from sml_tpu_torch.native import traverse_kernel as tk

    lib = build.load("forest_traverse", ("SML_TRAVERSE_STAMPS",))
    fn = lib.sml_forest_traverse
    fn.argtypes = tk._kernel().argtypes
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card {cs.card_line()}, most SM clock {clock}")
    stamps = np.zeros(STAMP_BLOCKS * STAMPS, np.int64)

    def launch(f, p, ops, out):
        binned, sf, sb, lv, w, depth = ops
        err = f(1, binned.data_ptr(), sf.data_ptr(), sb.data_ptr(),
                lv.data_ptr(), w.data_ptr(), out.data_ptr(), binned.shape[0],
                binned.shape[1], sf.shape[0], sf.shape[1], depth, 1,
                p.tile_rows, p.groups, p.threads, p.chunk, p.grid, p.stage_x,
                None, 0.0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err} ({p})")

    for n in ROWS:
        rng = np.random.default_rng([0, 0, n])
        ops = cs.shape_operands(rng, cs.SHAPES[0], n, dev)
        want = tk.forest_margin_plain(*ops[:5], ops[5])
        plan = tk.traverse_plan(n, cs.N_FEAT, 1, *ops[1].shape, ops[5])
        out = torch.empty(n, device=dev)
        for _ in range(5):
            launch(fn, plan, ops, out)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"instrumented kernel differs at {n} rows")
        host = ctypes.c_void_p(stamps.ctypes.data)
        if lib.sml_forest_traverse_stamps(host):
            raise RuntimeError("could not read the stamps")
        last = len(PHASES)
        d = stamps.reshape(STAMP_BLOCKS, STAMPS)[:min(plan.grid,
                                                      STAMP_BLOCKS), :last + 1]
        cycles = np.median(np.diff(d, axis=1), axis=0)
        print(f"rows={n} {plan}: cycles per phase (median over blocks) "
              + ", ".join(f"{k} {float(v)!r}" for k, v in zip(PHASES, cycles))
              + f"; total {float(np.median(d[:, last] - d[:, 0]))!r}")
        if not args.plans:
            continue
        real = tk._kernel()
        for rows, groups in ((plan.tile_rows, plan.groups),) \
                + OTHER_PLANS[n]:
            tiles = -(-n // rows)
            p = plan._replace(
                tile_rows=rows, groups=groups, threads=rows * groups,
                grid=min(tiles, tk._SMS),
                stage_x=int(4 * (cs.N_FEAT + 1) * rows <= tk._STAGE_X_BYTES))
            launch(real, p, ops, out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"plan {p} differs at {n} rows")
            ms = cs.device_ms(lambda: launch(real, p, ops, out), 200,
                              ("forest_traverse",))
            print(f"  plan rows={n} tile_rows={rows} groups={groups} "
                  f"threads={rows * groups} grid={p.grid}: device "
                  f"{cs.fmt_ms(ms)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
