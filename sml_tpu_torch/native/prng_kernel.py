"""The sampled fits' two draw kernels: a round's row weights and a tree
level's feature subspace, for E elements at once.

`row_weights` and `feature_mask` wrap the CUDA kernels of
`sml_tpu_torch/csrc/threefry.cu`, which replace the `jax.random` calls
that XLA compiles into the JAX package's fit program
(`sml_tpu/ml/tree_impl.py:551-553` and `:785-796`, and the grid-fused
program's `:1318-1350`). Both give jax 0.9.0's bits (`utils/prng.py`),
except that a Poisson count may differ from jax's where a row's f32
log-sum lies within an ulp or two of -rate (the port takes the log in
float64 and rounds it to f32).

A draw serves the E elements of a fit (the (grid point x fold) fits of a
fused tuning fit; a sequential fit is E = 1): an (E, 2) uint32 tensor of
keys, derived on the host (`prng.fold_in_keys`) and copied to the device
with the fit's other keys, and per element a mode, rate and row count
(`weight_table`) or a feature count k. Element e draws over its own flat
indices, so its values are those of its own one-element draw. The
operands' device decides where a draw runs: the CPU runs the plain
PyTorch version (`row_weights_plain`, `feature_mask_plain`), a CUDA
device launches the kernel on its current stream or raises. Nothing
falls back. The launch plans (`draw_plan`, `mask_plan`) come from the
shapes alone.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence

import torch

from ..utils import prng
from . import build

#: kernel launches made by each wrapper in this process
LAUNCHES = {"row_weights": 0, "feature_mask": 0}
_count_lock = threading.Lock()
_fns = {}

#: the row-weight samplers, by their code in the kernel
MODES = {"bernoulli": 0, "poisson": 1, "ones": 2}
#: threads of a row-weights block
_DRAW_THREADS = 256
#: the most threads of a feature-mask block, and its shared memory (one
#: f32 uniform a feature, within the 48 KB a block has without opting in)
_MASK_MAX_THREADS = 256
_MASK_SMEM = 48 * 1024


class DrawPlan(NamedTuple):
    threads: int      # per block, one row each
    blocks: int       # per element


class MaskPlan(NamedTuple):
    threads: int      # per block (node), over its features
    smem: int         # dynamic shared memory of a block, in bytes


def draw_plan(n: int) -> DrawPlan:
    """The launch of `row_weights` over an element's n rows: blocks of
    256 threads (and a row of such blocks per element)."""
    return DrawPlan(_DRAW_THREADS, max(1, -(-n // _DRAW_THREADS)))


def mask_plan(n_features: int) -> MaskPlan:
    """The launch of `feature_mask`: one block per (element, node) with a
    warp's multiple of threads up to 256 over its features, and a uniform
    a feature in shared memory. Raises ValueError past 12,288 features."""
    smem = 4 * n_features
    if smem > _MASK_SMEM:
        raise ValueError(f"feature_mask holds a node's uniforms in 48 KB of "
                         f"shared memory: at most {_MASK_SMEM // 4} "
                         f"features, got {n_features}")
    return MaskPlan(min(_MASK_MAX_THREADS, -(-n_features // 32) * 32), smem)


def weight_table(modes: Sequence[str], rates: Sequence[float],
                 counts: Sequence[int], device):
    """The per-element operands of `row_weights` on `device`, checked on
    the host and copied once: (modes int32, rates f32, counts int32).
    `modes` are "ones", "bernoulli" (1 where the row's uniform is below
    the rate) or "poisson" (a Knuth count, rate in [0, 10)); an element's
    rows at or past its count weigh 0."""
    if not len(modes) == len(rates) == len(counts) >= 1:
        raise ValueError("one mode, rate and row count an element")
    for mode, rate, n in zip(modes, rates, counts):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                             f"{mode!r}")
        if mode == "poisson" and not 0.0 <= rate < prng.KNUTH_MAX_RATE:
            raise ValueError(f"Poisson rates are drawn by Knuth's loop only "
                             f"in [0, {prng.KNUTH_MAX_RATE}), got {rate}")
        if not 0 <= n < 2 ** 31:
            raise ValueError(f"row count must be in [0, 2^31), got {n}")
    dev = _device(device, "row_weights")
    return (torch.tensor([MODES[m] for m in modes], dtype=torch.int32,
                         device=dev),
            torch.tensor(list(rates), dtype=torch.float32, device=dev),
            torch.tensor(list(counts), dtype=torch.int32, device=dev))


# ------------------------------------------------------------ plain
def row_weights_plain(keys: torch.Tensor, modes: torch.Tensor,
                      rates: torch.Tensor, counts: torch.Tensor,
                      n_pad: int) -> torch.Tensor:
    """The (E * n_pad,) f32 weights of one round, element by element:
    ones, Bernoulli(rate) as 0/1 or Poisson(rate) counts
    (`prng.bernoulli`, `prng.poisson_knuth`) over the element's n_pad
    rows, 0 past its row count."""
    dev = keys.device
    out = []
    for key, mode, rate, n in zip(keys.tolist(), modes.tolist(),
                                  rates.tolist(), counts.tolist()):
        if mode == MODES["ones"]:
            w = torch.ones(n_pad, dtype=torch.float32, device=dev)
        elif mode == MODES["bernoulli"]:
            w = prng.bernoulli(key, rate, n_pad, dev).to(torch.float32)
        else:
            w = prng.poisson_knuth(key, rate, n_pad, dev).to(torch.float32)
        w[n:] = 0.0
        out.append(w)
    return torch.cat(out)


def feature_mask_plain(keys: torch.Tensor, ks: torch.Tensor, width: int,
                       n_features: int) -> torch.Tensor:
    """The (E * width, F) f32 mask of a level, element by element: 1
    where a feature's rank among its node's uniforms is below the
    element's k (`prng.feature_mask`)."""
    return torch.cat([
        prng.feature_mask(key, width, n_features, k, keys.device)
        for key, k in zip(keys.tolist(), ks.tolist())]).to(torch.float32)


# ------------------------------------------------------------ launches
_ARGTYPES = {
    "row_weights": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "feature_mask": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
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


def _check_keys(keys: torch.Tensor, name: str, *per_elem) -> int:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.uint32:
        raise TypeError(f"{name} keys must be an (E, 2) uint32 tensor, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    E = keys.shape[0]
    for t, dtype in per_elem:
        if tuple(t.shape) != (E,) or t.dtype != dtype:
            raise TypeError(f"{name}: per-element operands must be ({E},) "
                            f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    ts = [keys] + [t for t, _ in per_elem]
    if len({t.device for t in ts}) != 1 or not all(t.is_contiguous()
                                                   for t in ts):
        raise ValueError(f"{name} operands must be contiguous, on one device")
    _device(keys.device, name)
    if not 1 <= E <= 65535:
        raise ValueError(f"{name} draws for 1 to 65535 elements, got {E}")
    return E


def row_weights(keys: torch.Tensor, modes: torch.Tensor,
                rates: torch.Tensor, counts: torch.Tensor,
                n_pad: int) -> torch.Tensor:
    """The (E * n_pad,) f32 row weights of one round of E elements, on
    the operands' device: element e's rows from e * n_pad, drawn under
    `keys[e]` by `modes[e]` at `rates[e]` (`weight_table` makes and
    checks the per-element operands), 0 at or past `counts[e]`.

    On a CUDA device one thread per (element, row) draws its weight (a
    Poisson row walks its own key chain); on the CPU `row_weights_plain`
    runs."""
    E = _check_keys(keys, "row_weights", (modes, torch.int32),
                    (rates, torch.float32), (counts, torch.int32))
    if not 0 <= n_pad < 2 ** 31 or E * n_pad >= 2 ** 31:
        raise ValueError(f"row count must be in [0, 2^31), got {E} x "
                         f"{n_pad}")
    dev = keys.device
    if dev.type == "cpu":
        return row_weights_plain(keys, modes, rates, counts, n_pad)
    out = torch.empty(E * n_pad, dtype=torch.float32, device=dev)
    if n_pad == 0:
        return out
    plan = draw_plan(n_pad)
    err = build.launch_on_stream(
        dev, _kernel("row_weights"), out.data_ptr(), keys.data_ptr(),
        modes.data_ptr(), rates.data_ptr(), counts.data_ptr(), E, n_pad,
        plan.threads, plan.blocks)
    if err != 0:
        raise RuntimeError(f"row_weights launch failed: CUDA error {err} "
                           f"(E={E}, n_pad={n_pad}, {plan})")
    _count("row_weights")
    return out


def feature_mask(keys: torch.Tensor, ks: torch.Tensor, width: int,
                 n_features: int) -> torch.Tensor:
    """The (E * width, n_features) f32 feature mask of one tree level of
    E elements, on the operands' device: row e * width + j is node j of
    element e, 1 where a feature's rank among the node's uniforms under
    `keys[e]` (ties to the lower index) is below `ks[e]`.

    On a CUDA device one block per (element, node) draws and ranks its
    features; on the CPU `feature_mask_plain` runs."""
    E = _check_keys(keys, "feature_mask", (ks, torch.int32))
    if width < 1 or n_features < 1 or E * width * n_features >= 2 ** 31:
        raise ValueError(f"empty or oversized mask ({E} x {width}, "
                         f"{n_features})")
    dev = keys.device
    if dev.type == "cpu":
        return feature_mask_plain(keys, ks, width, n_features)
    plan = mask_plan(n_features)
    out = torch.empty((E * width, n_features), dtype=torch.float32,
                      device=dev)
    err = build.launch_on_stream(
        dev, _kernel("feature_mask"), out.data_ptr(), keys.data_ptr(),
        ks.data_ptr(), E, width, n_features, plan.threads)
    if err != 0:
        raise RuntimeError(f"feature_mask launch failed: CUDA error {err} "
                           f"(E={E}, W={width}, F={n_features}, {plan})")
    _count("feature_mask")
    return out
