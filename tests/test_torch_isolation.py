"""The port stands alone: importing every module of `sml_tpu_torch` loads
neither JAX nor the JAX package, and without a CUDA device the entry
points (scoring and fitting) raise rather than carry on on the CPU (each
check runs in a fresh interpreter with no CUDA device visible)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=REPO, args=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable] + (args if args is not None else ["-c", code])
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


IMPORT_ALL = """
import importlib, pkgutil, sys
import sml_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sml_tpu_torch.__path__,
                                                "sml_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "sml_tpu"))
print(len(names), bad)
"""


def test_importing_the_whole_port_loads_no_jax_and_no_sml_tpu():
    proc = _run(IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 16
    assert bad == "[]"


def test_the_fit_modules_are_among_the_imported():
    proc = _run(IMPORT_ALL.replace("print(len(names), bad)",
                                   "print(sorted(names))"))
    assert proc.returncode == 0, proc.stderr
    for name in ("sml_tpu_torch.native.hist_kernel",
                 "sml_tpu_torch.native.prng_kernel",
                 "sml_tpu_torch.utils.prng",
                 "sml_tpu_torch.ml.tree_impl", "sml_tpu_torch.ml._tree_models",
                 "sml_tpu_torch.xgboost"):
        assert name in proc.stdout


FIT_WITHOUT_DEVICE = """
import numpy as np
from sml_tpu_torch.xgboost import XgboostRegressor
rng = np.random.default_rng(0)
X = rng.normal(size=(300, 4))
y = X[:, 0] + 0.1 * rng.normal(size=300)
model = XgboostRegressor(n_estimators=3, max_depth=3, max_bins=16).fit(
    X, y, device="cpu")
print(model.getNumTrees(), model.predict(X[:2], device="cpu").shape)
try:
    XgboostRegressor().fit(X, y)
except RuntimeError as e:
    print("raised:", e)
else:
    print("no error")
"""


def test_fit_without_device_raises_when_cuda_is_absent():
    proc = _run(FIT_WITHOUT_DEVICE)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "3 (2,)"
    assert lines[1].startswith("raised: no CUDA device")


SCORER_WITHOUT_DEVICE = """
import types
import numpy as np
from sml_tpu_torch.ml._tree_models import _EnsembleSpec
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.ml.tree_impl import Binning, FittedTree
n = 7
tree = FittedTree(np.full(n, -1, np.int32), np.zeros(n, np.int32),
                  np.ones(n, np.float32), np.zeros(n, np.float32),
                  np.zeros(n, np.float32))
spec = _EnsembleSpec([tree], 2, Binning(np.full((2, 3), np.inf, np.float32),
                                        {}), None, 0.0, 2, "regression")
model = types.SimpleNamespace(_spec=spec)
print(DeviceScorer(model, device="cpu").score_block(np.zeros((3, 2))))
try:
    DeviceScorer(model)
except RuntimeError as e:
    print("raised:", e)
else:
    print("no error")
"""


def test_scorer_without_device_raises_when_cuda_is_absent():
    proc = _run(SCORER_WITHOUT_DEVICE)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "[1. 1. 1.]"
    assert lines[1].startswith("raised: no CUDA device")


@pytest.mark.parametrize("device, ok", [("cpu", True), ("cuda", False),
                                        (None, False)])
def test_resolve_device_without_cuda(device, ok):
    proc = _run(f"from sml_tpu_torch.device import resolve_device\n"
                f"print(resolve_device({device!r}))")
    assert (proc.returncode == 0) == ok, proc.stderr
    if ok:
        assert proc.stdout.strip() == "cpu"
    else:
        assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_without_cuda():
    proc = _run(None, args=[os.path.join(REPO, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(None, cwd=str(tmp_path),
                args=[str(tmp_path / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
