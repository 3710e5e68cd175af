"""torchlint primitives: violations, the rule registry, parsed sources.

Everything in this package is stdlib-only and importable without torch,
jax, `sml_tpu` or the rest of `sml_tpu_torch`: `scripts/torch_lint.py`
loads it standalone by path, so a lint run starts from a cold
interpreter in well under a second. Keep imports relative and
stdlib-only.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class Violation:
    """One finding. `snippet` is the stripped source line at `line`: the
    line-number-independent fingerprint baseline entries match on."""
    rule: str
    path: str          # repo-relative, "/"-separated
    line: int
    message: str
    snippet: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    check: Callable  # (Project) -> List[Violation]


#: name -> Rule; filled by the @rule decorator when `rules/` imports.
RULES: Dict[str, Rule] = {}

#: rule names the engine itself emits (pragma and baseline hygiene,
#: parse errors). They cannot be suppressed and are not active rules.
META_RULES = ("torchlint-pragma", "torchlint-baseline", "syntax-error")


def rule(name: str, doc: str):
    """Register a rule function `(project) -> [Violation]` under `name`."""
    def deco(fn):
        RULES[name] = Rule(name, doc, fn)
        return fn
    return deco


class SourceFile:
    """One file under lint: raw text, physical lines, parsed AST.

    `tree` is None when the file does not parse; the engine reports that
    as a `syntax-error` violation instead of crashing the run.
    """

    def __init__(self, rel: str, text: str, path: Optional[str] = None):
        self.rel = rel.replace("\\", "/")
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self._nodes: Optional[List[ast.AST]] = None
        self._calls: Optional[Dict[str, List[ast.Call]]] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(text, filename=rel)
            self.parse_error: Optional[SyntaxError] = None
        except SyntaxError as e:
            self.tree = None
            self.parse_error = e

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree in `ast.walk` order, walked once."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree)) \
                if self.tree is not None else []
        return self._nodes

    def calls_named(self, name: str) -> List[ast.Call]:
        """The calls whose simple target name is `name`."""
        if self._calls is None:
            self._calls = {}
            for node in self.nodes:
                if isinstance(node, ast.Call):
                    func = node.func
                    while isinstance(func, ast.Call):
                        func = func.func
                    key = func.id if isinstance(func, ast.Name) else \
                        func.attr if isinstance(func, ast.Attribute) \
                        else None
                    if key is not None:
                        self._calls.setdefault(key, []).append(node)
        return self._calls.get(name, [])

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""
