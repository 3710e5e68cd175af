"""Project index shared by the rules: parsed sources, the conf-key
registry, per-function call records, and the dispatch-hot call graph.

A `Project` is built either from the repo (`from_root`) or from an
in-memory `{relpath: source}` mapping (`from_sources`), so rule fixtures
in tests need no temporary checkouts.

The lint targets are the port (`sml_tpu_torch/`), its chip check
(`chip_smoke.py`) and its scripts (`scripts/torch_*.py`). The port's
tests (`tests/test_torch_*.py`) are parsed for call-site evidence only
(a conf key that only tests exercise is not dead), and rules never
report violations in them.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from typing import Dict, Iterable, List, Optional, Tuple

from .core import SourceFile

#: what the runner lints (the lint package lints itself, under
#: sml_tpu_torch/lint/)
DEFAULT_LINT_TARGETS = ("sml_tpu_torch", "chip_smoke.py",
                        "scripts/torch_*.py")
#: parsed for conf-key call-site evidence only, never linted
DEFAULT_EXTRA_TARGETS = ("tests/test_torch_*.py",)

#: the port's conf module, relative to the root
CONF_REL = "sml_tpu_torch/conf.py"


def _iter_py(root: str, target: str) -> Iterable[str]:
    """The .py files of one target: a file, a directory (walked), or a
    file pattern (`dir/name_*.py`, matched in that directory only)."""
    if any(c in target for c in "*?["):
        folder, pattern = os.path.split(target)
        path = os.path.join(root, folder)
        if os.path.isdir(path):
            for f in sorted(os.listdir(path)):
                if f.endswith(".py") and fnmatch.fnmatch(f, pattern):
                    yield os.path.join(path, f)
        return
    path = os.path.join(root, target)
    if os.path.isfile(path):
        if path.endswith(".py"):
            yield path
        return
    for dirpath, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


class FunctionInfo:
    """One function or method definition and the simple names it calls."""

    def __init__(self, rel: str, qualname: str, node: ast.AST):
        self.rel = rel
        self.qualname = qualname
        self.name = qualname.rsplit(".", 1)[-1]
        self.node = node
        self.lineno = node.lineno
        self.calls: List[str] = []  # simple call-target names, body order
        #: (form, name) per call: form is "name" (`f(...)`), "self"
        #: (`self.f(...)` / `cls.f(...)`), or "attr" (`obj.f(...)`); the
        #: thread-role propagation (lint/threads.py) resolves each form
        #: differently to avoid false call-graph edges
        self.call_forms: List[Tuple[str, str]] = []

    def params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<fn {self.rel}:{self.qualname}>"


def call_target_name(func: ast.expr) -> Optional[str]:
    """The simple name a call resolves through: `f(...)` -> "f",
    `mod.f(...)` / `self.f(...)` -> "f", `g(...)(...)` -> "g"."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Call):
        return call_target_name(func.func)
    return None


def dotted(expr: ast.expr) -> str:
    """`a.b.c` as text ("" when the chain holds anything but names)."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return ""
    parts.append(expr.id)
    return ".".join(reversed(parts))


class _FunctionCollector(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.stack: List[str] = []
        self.out: List[FunctionInfo] = []
        self._current: List[FunctionInfo] = []

    def _visit_def(self, node) -> None:
        qual = ".".join(self.stack + [node.name])
        info = FunctionInfo(self.rel, qual, node)
        self.out.append(info)
        self.stack.append(node.name)
        self._current.append(info)
        self.generic_visit(node)
        self._current.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_Call(self, node) -> None:
        if self._current:
            name = call_target_name(node.func)
            if name:
                self._current[-1].calls.append(name)
                if isinstance(node.func, ast.Attribute):
                    form = "self" if (
                        isinstance(node.func.value, ast.Name)
                        and node.func.value.id in ("self", "cls")) \
                        else "attr"
                else:
                    form = "name"
                self._current[-1].call_forms.append((form, name))
        self.generic_visit(node)


class Project:
    def __init__(self, root: str, files: List[SourceFile],
                 extra_files: Optional[List[SourceFile]] = None):
        self.root = root
        self.files = files
        self.extra_files = extra_files or []
        self.by_rel = {f.rel: f for f in files}
        self._fn_index: Optional[Dict[str, List[FunctionInfo]]] = None
        self._by_name: Optional[Dict[str, List[FunctionInfo]]] = None
        self._line_index: Dict[str, Dict[int, FunctionInfo]] = {}
        self._conf_registry: Optional[Dict[str, Tuple[str, int]]] = None
        self._conf_aliases: Optional[Dict[str, str]] = None

    # ------------------------------------------------------------ builders
    @classmethod
    def from_root(cls, root: str,
                  targets: Tuple[str, ...] = DEFAULT_LINT_TARGETS,
                  extra_targets: Tuple[str, ...] = DEFAULT_EXTRA_TARGETS
                  ) -> "Project":
        def load(target_list):
            out = []
            for target in target_list:
                for path in _iter_py(root, target):
                    rel = os.path.relpath(path, root).replace(os.sep, "/")
                    with open(path, encoding="utf-8") as fh:
                        out.append(SourceFile(rel, fh.read(), path=path))
            return out
        return cls(root, load(targets), load(extra_targets))

    @classmethod
    def from_sources(cls, sources: Dict[str, str],
                     extra: Optional[Dict[str, str]] = None,
                     root: str = "/virtual") -> "Project":
        files = [SourceFile(rel, text) for rel, text in sources.items()]
        extra_files = [SourceFile(rel, text)
                       for rel, text in (extra or {}).items()]
        return cls(root, files, extra_files)

    # ------------------------------------------------------- function index
    def function_index(self) -> Dict[str, List[FunctionInfo]]:
        """rel -> [FunctionInfo] for every linted file."""
        if self._fn_index is None:
            idx: Dict[str, List[FunctionInfo]] = {}
            for f in self.files:
                if f.tree is None:
                    idx[f.rel] = []
                    continue
                col = _FunctionCollector(f.rel)
                col.visit(f.tree)
                idx[f.rel] = col.out
            self._fn_index = idx
        return self._fn_index

    def functions_by_name(self) -> Dict[str, List[FunctionInfo]]:
        """simple name -> every function of the project bearing it."""
        if self._by_name is None:
            by_name: Dict[str, List[FunctionInfo]] = {}
            for fns in self.function_index().values():
                for fn in fns:
                    by_name.setdefault(fn.name, []).append(fn)
            self._by_name = by_name
        return self._by_name

    def enclosing_function(self, rel: str,
                           lineno: int) -> Optional[FunctionInfo]:
        """The innermost function containing `lineno` (None = module)."""
        by_line = self._line_index.get(rel)
        if by_line is None:
            # functions come in source order, so an inner def overwrites
            # the lines of the def around it
            by_line = {}
            for info in self.function_index().get(rel, []):
                end = getattr(info.node, "end_lineno", info.lineno)
                for ln in range(info.lineno, end + 1):
                    by_line[ln] = info
            self._line_index[rel] = by_line
        return by_line.get(lineno)

    def resolve_callees(self, info: FunctionInfo) -> List[FunctionInfo]:
        """Call-graph edges out of one function, by simple name.

        Resolution is deliberately conservative: a called name binds to
        same-module definitions first; cross-module only when exactly ONE
        function in the whole project bears that name (common method
        names such as get, fit, append resolve nowhere and add no edge).
        """
        by_name = self.functions_by_name()
        out: List[FunctionInfo] = []
        local = {fn.name: fn for fn in self.function_index().get(info.rel,
                                                                 [])}
        for name in info.calls:
            if name in local:
                out.append(local[name])
                continue
            cands = by_name.get(name, [])
            if len(cands) == 1:
                out.append(cands[0])
        return out

    # --------------------------------------------------- conf-key registry
    def conf_registry(self) -> Dict[str, Tuple[str, int]]:
        """key -> (rel, line) of its `_register(...)` call.

        The AST union of every `_register("key", ...)` over the linted
        tree (conf.py and the late registrars: ct/, fleet/, loadgen/,
        obs/_watchdog.py, parallel/dispatch.py, parallel/prewarm.py),
        cross-checked against the programmatic dump
        (`conf.registered_keys()`) when the port's conf.py loads by path:
        the lint must not drift from what the running port registers.
        """
        if self._conf_registry is not None:
            return self._conf_registry
        reg: Dict[str, Tuple[str, int]] = {}
        for f in self.files:
            if f.tree is None:
                continue
            for node in f.nodes:
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "_register"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    reg.setdefault(node.args[0].value, (f.rel, node.lineno))
        conf_mod = self.load_conf_module()
        if conf_mod is not None and hasattr(conf_mod, "registered_keys"):
            for key in conf_mod.registered_keys():
                reg.setdefault(key, (CONF_REL, 0))
        self._conf_registry = reg
        return reg

    def conf_aliases(self) -> Dict[str, str]:
        """The spark.* <-> sml.* alias map (AST parse of `_ALIASES`)."""
        if self._conf_aliases is not None:
            return self._conf_aliases
        aliases: Dict[str, str] = {}
        conf = self.by_rel.get(CONF_REL)
        if conf is not None and conf.tree is not None:
            for node in ast.walk(conf.tree):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == "_ALIASES"
                        and isinstance(node.value, ast.Dict)):
                    for k, v in zip(node.value.keys, node.value.values):
                        if (isinstance(k, ast.Constant)
                                and isinstance(v, ast.Constant)):
                            aliases[k.value] = v.value
        self._conf_aliases = aliases
        return aliases

    def load_conf_module(self):
        """The port's conf.py loaded by PATH (it is stdlib-only): the
        programmatic `registered_keys()` dump. None when unavailable
        (in-memory fixture projects)."""
        path = os.path.join(self.root, CONF_REL)
        if not os.path.isfile(path):
            return None
        import importlib.util
        try:
            spec = importlib.util.spec_from_file_location("_torchlint_conf",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
        except Exception:
            return None

    # ------------------------------------------------------- hot-path set
    def hot_functions(self, entry_calls: Iterable[str]) -> Dict[str, str]:
        """qualkey -> entry provenance, for every function reachable from
        a dispatch entry point (a function calling one of `entry_calls`).
        qualkey is "rel::qualname"."""
        entry_calls = set(entry_calls)
        index = self.function_index()
        seeds: List[Tuple[FunctionInfo, str]] = []
        for fns in index.values():
            for fn in fns:
                if entry_calls & set(fn.calls):
                    seeds.append((fn, fn.qualname))
        hot: Dict[str, str] = {}
        work = list(seeds)
        while work:
            fn, origin = work.pop()
            key = f"{fn.rel}::{fn.qualname}"
            if key in hot:
                continue
            hot[key] = origin
            for callee in self.resolve_callees(fn):
                work.append((callee, origin))
        return hot
