"""Time each device op of one IRLS step of the port's linear programs.

    python3 scripts/torch_irls_ops.py [--rows N] [--width D]

At the compact chain's scale (4,194,304 rows, 49 slots + the intercept,
float64) it times, with CUDA events (median of 5 after a warm-up), each
op of `linear_impl._newton_pass`, the cross products through
`linear_impl._cross` and as one matmul, `_solve_spd`, a whole Newton
pass, the whole-fit `_irls_steps` (12 steps) and the copy of the
compact and materialized blocks to the card; and prints them beside the
card's name and power limit. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sml_tpu_torch.ml import linear_impl as L  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def timed(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4_194_304)
    ap.add_argument("--width", type=int, default=49)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    n, d = args.rows, args.width
    rng = np.random.default_rng(0)
    num = rng.normal(size=(n, 7)).astype(np.float32)
    codes = np.stack([rng.integers(0, w + 1, n) for w in (35, 2, 5)],
                     axis=1).astype(np.int32)
    layout = tuple([("oh", 0, 35), ("oh", 1, 2), ("oh", 2, 5)]
                   + [("num", j) for j in range(7)])
    y = (rng.random(n) < 0.5).astype(np.float32)
    X32 = np.ascontiguousarray(np.concatenate(
        [np.eye(36, 35, dtype=np.float32)[codes[:, 0]],
         np.eye(3, 2, dtype=np.float32)[codes[:, 1]],
         np.eye(6, 5, dtype=np.float32)[codes[:, 2]], num], axis=1))
    got = {}
    got["copy compact (num + codes) ms"] = timed(lambda: (
        torch.from_numpy(num).to(dev), torch.from_numpy(codes).to(dev)))
    got["copy materialized X f32 ms"] = timed(
        lambda: torch.from_numpy(X32).to(dev))
    num_d = torch.from_numpy(num).to(dev)
    codes_d = torch.from_numpy(codes).to(dev)
    Xa = L._expand(num_d, codes_d, layout)
    yd = torch.from_numpy(y).to(dev).to(torch.float64)
    w = torch.zeros(Xa.shape[1], dtype=torch.float64, device=dev)
    got["expand ms"] = timed(lambda: L._expand(num_d, codes_d, layout))
    eta = Xa @ w
    p = torch.sigmoid(eta)
    Wd = torch.clamp_min(p * (1 - p), 1e-6)
    got["eta = Xa @ w ms"] = timed(lambda: Xa @ w)
    got["sigmoid ms"] = timed(lambda: torch.sigmoid(eta))
    got["weighted rows Xa * W ms"] = timed(lambda: Xa * Wd[:, None])
    XW = Xa * Wd[:, None]
    got["hess _cross ms"] = timed(lambda: L._cross(XW, Xa))
    got["hess one matmul ms"] = timed(lambda: XW.T @ Xa)
    got["grad _cross ms"] = timed(lambda: L._cross(Xa, (p - yd)[:, None]))
    got["grad one matmul ms"] = timed(lambda: Xa.T @ (p - yd))
    got["log-likelihood ms"] = timed(lambda: torch.sum(
        yd * torch.nn.functional.logsigmoid(eta)
        + (1 - yd) * torch.nn.functional.logsigmoid(-eta)))
    H = L._cross(XW, Xa)
    g = L._cross(Xa, (p - yd)[:, None])[:, 0]
    got["_solve_spd ms"] = timed(lambda: L._solve_spd(H, g))
    got["_newton_pass ms"] = timed(lambda: L._newton_pass(Xa, yd, w))
    got["_irls_steps 12 ms"] = timed(lambda: L._irls_steps(Xa, yd, 12, 1e-6),
                                     reps=3)
    print(f"rows {n}, width {d} + 1, float64; {card()}")
    for k, v in got.items():
        print(f"  {k}: {v!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
