"""The sampled fits' two draw kernels: a round's row weights and a tree
level's feature subspace.

`row_weights` and `feature_mask` wrap the CUDA kernels of
`sml_tpu_torch/csrc/threefry.cu`, which replace the `jax.random` calls
that XLA compiles into the JAX package's fit program
(`sml_tpu/ml/tree_impl.py:551-553` and `:785-796`). Both give jax 0.9.0's
bits (`utils/prng.py`), except that a Poisson count may differ from
jax's where a row's f32 log-sum lies within an ulp or two of -rate (the
port takes the log in float64 and rounds it to f32).

A key is a host pair `(k1, k2)`: keys are derived on the host
(`prng.fold_in`) and passed to the launch by value. The operands are
shapes, so `device` decides where a draw runs: "cpu" runs the plain
PyTorch version (`row_weights_plain`, `feature_mask_plain`), a CUDA
device launches the kernel on its current stream or raises. Nothing
falls back. The launch plans (`draw_plan`, `mask_plan`) come from the
shapes alone.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..utils import prng
from . import build

#: kernel launches made by each wrapper in this process
LAUNCHES = {"row_weights": 0, "feature_mask": 0}
_count_lock = threading.Lock()
_fns = {}

#: the row-weight samplers, by their code in the kernel
MODES = {"bernoulli": 0, "poisson": 1}
#: threads of a row-weights block
_DRAW_THREADS = 256
#: the most threads of a feature-mask block, and its shared memory (one
#: f32 uniform a feature, within the 48 KB a block has without opting in)
_MASK_MAX_THREADS = 256
_MASK_SMEM = 48 * 1024


class DrawPlan(NamedTuple):
    threads: int      # per block, one row each
    blocks: int


class MaskPlan(NamedTuple):
    threads: int      # per block (node), over its features
    smem: int         # dynamic shared memory of a block, in bytes


def draw_plan(n: int) -> DrawPlan:
    """The launch of `row_weights` over n rows: blocks of 256 threads."""
    return DrawPlan(_DRAW_THREADS, max(1, -(-n // _DRAW_THREADS)))


def mask_plan(n_features: int) -> MaskPlan:
    """The launch of `feature_mask`: one block per node with a warp's
    multiple of threads up to 256 over its features, and a uniform a
    feature in shared memory. Raises ValueError past 12,288 features."""
    smem = 4 * n_features
    if smem > _MASK_SMEM:
        raise ValueError(f"feature_mask holds a node's uniforms in 48 KB of "
                         f"shared memory: at most {_MASK_SMEM // 4} "
                         f"features, got {n_features}")
    return MaskPlan(min(_MASK_MAX_THREADS, -(-n_features // 32) * 32), smem)


# ------------------------------------------------------------ plain
def row_weights_plain(key, n: int, mode: str, rate: float,
                      device) -> torch.Tensor:
    """The (n,) f32 weights of one round: Bernoulli(rate) as 0/1, or
    Poisson(rate) counts (`prng.bernoulli`, `prng.poisson_knuth`)."""
    if mode == "bernoulli":
        w = prng.bernoulli(key, rate, n, device)
    else:
        w = prng.poisson_knuth(key, rate, n, device)
    return w.to(torch.float32)


def feature_mask_plain(key, width: int, n_features: int, k: int,
                       device) -> torch.Tensor:
    """The (width, F) f32 mask of a level: 1 where a feature's rank
    among its node's uniforms is below k (`prng.feature_mask`)."""
    return prng.feature_mask(key, width, n_features, k, device) \
        .to(torch.float32)


# ------------------------------------------------------------ launches
_ARGTYPES = {
    "row_weights": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "feature_mask": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                     ctypes.c_int, ctypes.c_void_p],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("threefry"), f"sml_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _device(device, name: str) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


def row_weights(key, n: int, mode: str, rate: float,
                device) -> torch.Tensor:
    """The (n,) f32 row weights of one round under `key`, on `device`:
    `mode` "bernoulli" (1 where the row's uniform is below `rate`) or
    "poisson" (a Knuth count, `rate` in [0, 10)).

    On a CUDA device one thread per row draws its weight (a Poisson row
    walks its own key chain); on the CPU `row_weights_plain` runs."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"row count must be in [0, 2^31), got {n}")
    if mode == "poisson" and not 0.0 <= rate < prng.KNUTH_MAX_RATE:
        raise ValueError(f"Poisson rates are drawn by Knuth's loop only in "
                         f"[0, {prng.KNUTH_MAX_RATE}), got {rate}")
    key = prng.as_key(key)
    dev = _device(device, "row_weights")
    if dev.type == "cpu":
        return row_weights_plain(key, n, mode, rate, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    plan = draw_plan(n)
    err = build.launch_on_stream(
        dev, _kernel("row_weights"), out.data_ptr(), n, MODES[mode], key[0],
        key[1], float(rate), plan.threads, plan.blocks)
    if err != 0:
        raise RuntimeError(f"row_weights launch failed: CUDA error {err} "
                           f"(n={n}, mode={mode}, rate={rate}, {plan})")
    _count("row_weights")
    return out


def feature_mask(key, width: int, n_features: int, k: int,
                 device) -> torch.Tensor:
    """The (width, n_features) f32 feature mask of one tree level under
    `key`, on `device`: 1 where a feature's rank among its node's
    uniforms (ties to the lower index) is below k.

    On a CUDA device one block per node draws and ranks its features; on
    the CPU `feature_mask_plain` runs."""
    if width < 1 or n_features < 1 or width * n_features >= 2 ** 31:
        raise ValueError(f"empty or oversized mask ({width}, {n_features})")
    key = prng.as_key(key)
    dev = _device(device, "feature_mask")
    if dev.type == "cpu":
        return feature_mask_plain(key, width, n_features, k, dev)
    plan = mask_plan(n_features)
    out = torch.empty((width, n_features), dtype=torch.float32, device=dev)
    err = build.launch_on_stream(
        dev, _kernel("feature_mask"), out.data_ptr(), width, n_features,
        int(k), key[0], key[1], plan.threads)
    if err != 0:
        raise RuntimeError(f"feature_mask launch failed: CUDA error {err} "
                           f"(W={width}, F={n_features}, k={k}, {plan})")
    _count("feature_mask")
    return out
