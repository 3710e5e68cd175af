"""obs-taxonomy: the port's span, counter, event and kernel-launch names
against its registry, `sml_tpu_torch/obs/taxonomy.py`.

Every `PROFILER.span(...)` / `PROFILER.count(...)`,
`RECORDER.emit/counter/gauge(...)` (also as `_OBS`) and
`METRICS.observe(...)` (also as `_METRICS`) call site under
`sml_tpu_torch/` names a registered name, so a name cannot drift
between the modules that emit it and the report, exporter and
autologger that read it:

- a literal name is registered (exactly, or under a `prefix.*`
  wildcard);
- an f-string's literal prefix (up to the first interpolation) sits
  under a registered wildcard: dynamic suffixes are legal only for
  registered families;
- any other (computed) name is a violation OUTSIDE `sml_tpu_torch/obs/`
  and `utils/profiler.py`, which forward names checked where they
  start.

And the kernel wrappers' launch counters (`LAUNCHES` in
`sml_tpu_torch/native/`: a dict literal's keys, or, for an int counter,
the function that increments it) equal the registry's
`KERNEL_LAUNCHES`: each counter is registered, and each registered
kernel is counted.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from ..core import Violation, rule
from ..project import Project

# receiver name -> {method -> (arg index of the NAME, taxonomy kind)}
TARGETS = {
    "PROFILER": {"span": (0, "span"), "count": (0, "count")},
    "RECORDER": {"emit": (1, "emit"), "counter": (0, "counter"),
                 "gauge": (0, "gauge")},
    "_OBS": {"emit": (1, "emit"), "counter": (0, "counter"),
             "gauge": (0, "gauge")},
    "METRICS": {"observe": (0, "observe")},
    "_METRICS": {"observe": (0, "observe")},
}

_HERE = os.path.dirname(os.path.abspath(__file__))
#: .../sml_tpu_torch/lint/rules -> the repo root
REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
TAXONOMY_REL = "sml_tpu_torch/obs/taxonomy.py"
NATIVE_PREFIX = "sml_tpu_torch/native/"


def _receiver_name(node: ast.expr) -> str:
    """The identifier a method is called on: PROFILER.span -> "PROFILER",
    obs.RECORDER.emit -> "RECORDER"."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _joined_prefix(node: ast.JoinedStr) -> str:
    """Literal prefix of an f-string up to the first interpolation."""
    prefix = ""
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            prefix += part.value
        else:
            break
    return prefix


def is_obs_internal(rel: str) -> bool:
    """The event bus itself (obs/) and its front end (utils/profiler.py)
    forward names that were checked at their originating call sites."""
    rel = rel.replace("\\", "/")
    return "/obs/" in f"/{rel}" or rel.endswith("utils/profiler.py")


def check_source(text: str, rel: str, taxonomy, in_obs: bool,
                 nodes=None) -> List[Tuple[str, int, str]]:
    """(rel, line, message) for every bad name in one source text
    (`nodes`: its walked tree, when the caller has it)."""
    if nodes is None:
        try:
            nodes = ast.walk(ast.parse(text, filename=rel))
        except SyntaxError as e:
            return [(rel, e.lineno or 0, f"syntax error: {e.msg}")]
    out: List[Tuple[str, int, str]] = []
    for node in nodes:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        methods = TARGETS.get(_receiver_name(node.func.value))
        if methods is None or node.func.attr not in methods:
            continue
        arg_idx, kind = methods[node.func.attr]
        if len(node.args) <= arg_idx:
            continue  # name passed by keyword: obs-internal style only
        arg = node.args[arg_idx]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if not taxonomy.is_registered(kind, arg.value):
                out.append((rel, node.lineno,
                            f"unregistered {kind} name {arg.value!r}"))
        elif isinstance(arg, ast.JoinedStr):
            prefix = _joined_prefix(arg)
            if not taxonomy.prefix_registered(kind, prefix):
                out.append((rel, node.lineno,
                            f"unregistered dynamic {kind} family "
                            f"(literal prefix {prefix!r} matches no "
                            f"wildcard entry)"))
        elif not in_obs:
            out.append((rel, node.lineno,
                        f"computed {kind} name (only literals and "
                        f"f-strings can be checked; computed names are "
                        f"reserved to sml_tpu_torch/obs/)"))
    return out


def load_taxonomy(repo: str = REPO):
    """The port's registry, loaded by path: it is pure data, and the
    lint must not import the port (or torch) to read it."""
    import importlib.util
    path = os.path.join(repo, TAXONOMY_REL)
    spec = importlib.util.spec_from_file_location("_torchlint_taxonomy",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_counters(project: Project) -> Dict[str, Tuple[str, int]]:
    """kernel name -> (rel, line) of the `LAUNCHES` counter that counts
    it, over the native modules: a module-level dict literal's keys, or,
    for an int counter, the functions whose `LAUNCHES += 1` counts it."""
    out: Dict[str, Tuple[str, int]] = {}
    for f in project.files:
        if f.tree is None or not f.rel.startswith(NATIVE_PREFIX):
            continue
        counter = None
        for node in f.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "LAUNCHES":
                counter = node
        if counter is None:
            continue
        if isinstance(counter.value, ast.Dict):
            for k in counter.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.setdefault(k.value, (f.rel, counter.lineno))
            continue
        for node in f.nodes:
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id == "LAUNCHES":
                fn = project.enclosing_function(f.rel, node.lineno)
                if fn is not None:
                    out.setdefault(fn.name, (f.rel, counter.lineno))
    return out


def _registry_line(project: Project) -> int:
    sf = project.by_rel.get(TAXONOMY_REL)
    if sf is None or sf.tree is None:
        return 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "KERNEL_LAUNCHES"
                for t in node.targets):
            return node.lineno
    return 0


@rule("obs-taxonomy",
      "PROFILER/RECORDER/METRICS names and the kernels' launch counters "
      "must be registered in sml_tpu_torch/obs/taxonomy.py")
def check(project: Project) -> List[Violation]:
    root = project.root if os.path.isfile(
        os.path.join(project.root, TAXONOMY_REL)) else REPO
    taxonomy = load_taxonomy(root)
    out: List[Violation] = []
    for f in project.files:
        if not f.rel.startswith("sml_tpu_torch/") \
                or f.rel.startswith("sml_tpu_torch/lint/"):
            continue
        if f.tree is None:
            continue
        for rel, line, msg in check_source(f.text, f.rel, taxonomy,
                                           is_obs_internal(f.rel),
                                           f.nodes):
            out.append(Violation("obs-taxonomy", rel, line, msg))
    counted = launch_counters(project)
    registered = set(getattr(taxonomy, "KERNEL_LAUNCHES", ()))
    for name, (rel, line) in sorted(counted.items()):
        if name not in registered:
            out.append(Violation(
                "obs-taxonomy", rel, line,
                f"kernel launch counter {name!r} is not in the "
                f"registry's KERNEL_LAUNCHES"))
    line = _registry_line(project)
    if line:
        for name in sorted(registered - set(counted)):
            out.append(Violation(
                "obs-taxonomy", TAXONOMY_REL, line,
                f"registered kernel {name!r} has no LAUNCHES counter in "
                f"sml_tpu_torch/native/"))
    return out
