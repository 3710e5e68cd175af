"""Build the port's native sources and load them with `ctypes`.

Each `csrc/<name>.cu` is a CUDA kernel source with a plain C interface
(every pointer and the stream a `void*`, sizes as `int`, a `cudaError_t`
returned as `int`), so `nvcc` compiles it in seconds without PyTorch's
headers. Each `csrc/<name>.cc` is C++ for the host (the binning), built
with `g++` (`-ffp-contract=off`: the host traversal's f32 products and
sums must round apart, as the card's do). The shared library goes to `sml_tpu_torch/native/build/` at
first use, one per source, keyed by the source's content hash so an
edited source rebuilds; it is written under a temporary name and renamed
into place, so processes that build at once each load a whole library.

Unlike the JAX package's g++ build (`sml_tpu/native/build.py`), which
returns None and lets the caller fall back, a failed build RAISES: a
card without its kernel, or a host without its binning, is a broken
install, not a slower path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """`nvcc` or `g++` is missing or refused a source."""


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH,
    else the toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from sml_tpu_torch/csrc at first use")


def _source(name: str) -> str:
    """`csrc/<name>.cu`, else `csrc/<name>.cc`."""
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR, f"{name}.cc")


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> str:
    src = _source(name)
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    if defines:
        h.update(repr(defines).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str, out: str, defines: Tuple[str, ...] = ()) -> None:
    src = _source(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    if src.endswith(".cu"):
        cc, flags = nvcc_path(), NVCC_FLAGS
    else:
        cc, flags = shutil.which("g++"), GXX_FLAGS
        if cc is None:
            raise KernelBuildError(f"g++ not found: {src} is built from "
                                   f"source at first use")
    cmd = [cc, *flags, *(f"-D{d}" for d in defines), "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise KernelBuildError(f"{cmd[0]} could not run on {src}: {e}")
    if proc.returncode != 0:
        raise KernelBuildError(
            f"{os.path.basename(cc)} failed on {src} (exit "
            f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}"
            f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    # a build is the port's program-cache miss: engine.compile_programs
    from ..obs import note_compile
    note_compile(name)


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, all
    compiler processes started together. Raises KernelBuildError."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not os.path.exists(p)]
    errors = []
    threads = []
    for n, p in todo:
        def run(n=n, p=p):
            try:
                _compile(n, p)
            except KernelBuildError as e:
                errors.append(e)
        t = threading.Thread(target=run, name=f"build-{n}")
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use; with
    `defines` (macro names passed as -D), a build of its own."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = _lib_path(name, key[1])
            if not os.path.exists(path):
                if key[1]:
                    _compile(name, path, key[1])
                else:
                    build([name])
            lib = ctypes.CDLL(path)
            _libs[key] = lib
        return lib


def kernel_sources() -> list:
    """Names of every kernel source under `csrc/`."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def host_sources() -> list:
    """Names of every host C++ source under `csrc/`."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cc"))


def launch_on_stream(dev: torch.device, fn, *args, record=None) -> int:
    """`fn(*args, stream)` on the current stream of `dev`, with `dev` the
    current device (the launch goes to the current one); switches device
    only when it is not already current. `record`, the wrapper's
    signature `(kernel, plan, tensor operands, keyword arguments)`, goes
    into the prewarm manifest (`parallel/prewarm.record_launch`) once the
    launch has returned 0."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if record is not None and err == 0:
        from ..parallel.prewarm import record_launch
        record_launch(dev, *record)
    return err
