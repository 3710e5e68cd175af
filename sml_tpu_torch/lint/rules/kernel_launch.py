"""kernel-launch-outside-native: kernel libraries are built, loaded and
launched only in `sml_tpu_torch/native/`.

Every launch in the port goes through a kernel wrapper of
`sml_tpu_torch/native/`: the wrapper counts it (`LAUNCHES`, the chip
check's proof that a path ran its kernels), records its signature for
prewarm (`build.launch_on_stream`), and runs the plain version for a
CPU tensor. A library loaded or a kernel launched anywhere else is a
launch none of that sees. Flagged:

- outside `sml_tpu_torch/native/`: `build.load(...)` (and its re-export
  `load_library`), `launch_on_stream(...)`, `ctypes.CDLL(...)` /
  `ctypes.cdll.LoadLibrary(...)`, and
  `torch.utils.cpp_extension.load*(...)` (any spelling, from-imports
  included);
- a call of the traversal kernel's wrapper, `forest_traverse(...)`,
  outside its sanctioned glue (`ALLOWED_TRAVERSE`: the scoring paths of
  `ml/inference.py` and the boosted fits' margin replay in
  `ml/tree_impl.py`) and `native/`, which every traversal goes through
  for its routing and counters;
- anywhere: `torch.compile`, `torch.jit.script` and `torch.jit.trace`
  (call or decorator), the port's counterpart of a bare `jax.jit`: a
  compile that obs never sees and a device program that is not a
  hand-written kernel.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..core import Violation, rule
from ..project import Project, call_target_name, dotted

RULE = "kernel-launch-outside-native"
NATIVE_PREFIX = "sml_tpu_torch/native/"
#: files whose functions may call the traversal kernel's wrapper
ALLOWED_TRAVERSE = {
    "sml_tpu_torch/ml/inference.py": "the scoring paths: every launch "
                                     "is routed and counted there",
    "sml_tpu_torch/ml/tree_impl.py": "the boosted fits' margin replay "
                                     "(warm start)",
}
COMPILES = ("torch.compile", "torch.jit.script", "torch.jit.trace",
            "jit.script", "jit.trace")


def _from_imports(f, module_suffix: str) -> Set[str]:
    """Local names bound by `from <...module_suffix> import name`."""
    out: Set[str] = set()
    for node in f.nodes:
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith(module_suffix):
            for a in node.names:
                out.add(a.asname or a.name)
    return out


def _loader_label(call: ast.Call, cpp_names: Set[str],
                  build_names: Set[str]) -> Optional[str]:
    text = dotted(call.func)
    name = call_target_name(call.func)
    if text.endswith("build.load") or name in ("load_library",
                                               "launch_on_stream"):
        return text or name
    if isinstance(call.func, ast.Name) and name in build_names \
            and name == "load":
        return name
    if name == "CDLL" or text.endswith("cdll.LoadLibrary"):
        return text or name
    if "cpp_extension." in text or (isinstance(call.func, ast.Name)
                                    and name in cpp_names):
        return text or name
    return None


def _compile_label(expr: ast.expr) -> Optional[str]:
    target = expr.func if isinstance(expr, ast.Call) else expr
    text = dotted(target)
    if text in COMPILES:
        return text
    return None


@rule(RULE,
      "kernel libraries load and launch only in sml_tpu_torch/native/; "
      "forest_traverse only from its glue; no torch.compile/torch.jit")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for f in project.files:
        if f.tree is None:
            continue
        native = f.rel.startswith(NATIVE_PREFIX)
        cpp_names = _from_imports(f, "cpp_extension")
        build_names = _from_imports(f, "build")
        decorators = set()
        for node in f.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                for dec in node.decorator_list:
                    label = _compile_label(dec)
                    if label is not None:
                        decorators.add(id(dec))
                        out.append(Violation(
                            RULE, f.rel, dec.lineno,
                            f"`@{label}` compiles a program obs never "
                            f"sees: write the kernel by hand under "
                            f"sml_tpu_torch/csrc/ with its wrapper in "
                            f"native/"))
        for node in f.nodes:
            if not isinstance(node, ast.Call) or id(node) in decorators:
                continue
            label = _compile_label(node)
            if label is not None:
                out.append(Violation(
                    RULE, f.rel, node.lineno,
                    f"`{label}(...)` compiles a program obs never sees: "
                    f"write the kernel by hand under sml_tpu_torch/csrc/ "
                    f"with its wrapper in native/"))
                continue
            if native:
                continue
            label = _loader_label(node, cpp_names, build_names)
            if label is not None:
                out.append(Violation(
                    RULE, f.rel, node.lineno,
                    f"`{label}(...)` outside sml_tpu_torch/native/ loads "
                    f"or launches a kernel library no wrapper counts or "
                    f"records: call the kernel's wrapper in native/"))
                continue
            if call_target_name(node.func) == "forest_traverse" \
                    and f.rel not in ALLOWED_TRAVERSE:
                fn = project.enclosing_function(f.rel, node.lineno)
                qual = fn.qualname if fn else "<module>"
                out.append(Violation(
                    RULE, f.rel, node.lineno,
                    f"direct `forest_traverse` call in `{qual}` bypasses "
                    f"the scoring glue (ml/inference.py routes and counts "
                    f"every traversal): score through DeviceScorer / "
                    f"predict_forest_sharded"))
    return out
