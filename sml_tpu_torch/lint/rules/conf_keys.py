"""conf-key-registry: the port's `conf.py` registry is the contract
between the keys' producers and their readers. Two faults, both flagged:

- an UNREGISTERED literal at a call site: `get/getInt/getBool/set/
  unset/on_set("sml.*" | "spark.*")` whose key no `_register(...)`
  declares. On a fresh conf the port's `get` raises `KeyError` for such
  a key where the reference returns its default, and `asDict()` (the
  black-box bundle's conf dump) leaves it out;
- a DEAD key: registered, with no literal call site anywhere under the
  linted tree or the port's tests (tests count as evidence of life:
  some keys exist for test control). A registered key nobody reads is
  documentation lying about what the port honours.

The registry is the AST union of every `_register("key", ...)` in the
linted tree (`conf.py` and the late registrars), cross-checked with
`conf.registered_keys()` when `sml_tpu_torch/conf.py` loads by path
(`Project.conf_registry`). `spark.* <-> sml.*` alias pairs
(`conf._ALIASES`) count as one key for liveness.
"""

from __future__ import annotations

import ast
import difflib
from typing import List, Set, Tuple

from ..core import SourceFile, Violation, rule
from ..project import Project

CONF_METHODS = {"get", "getInt", "getBool", "set", "unset", "on_set"}
KEY_PREFIXES = ("sml.", "spark.")


def _literal_key_sites(sf: SourceFile) -> List[Tuple[str, int]]:
    """(key, line) for every conf-method call with a literal key."""
    out: List[Tuple[str, int]] = []
    if sf.tree is None:
        return out
    for node in sf.nodes:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in CONF_METHODS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        key = node.args[0].value
        if key.startswith(KEY_PREFIXES):
            out.append((key, node.lineno))
    return out


@rule("conf-key-registry",
      "every sml.*/spark.* conf literal must resolve against the port's "
      "conf registry; registered keys with no call site are dead")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    registry = project.conf_registry()
    aliases = project.conf_aliases()

    live: Set[str] = set()
    for sf in list(project.files) + list(project.extra_files):
        linted = sf.rel in project.by_rel
        for key, line in _literal_key_sites(sf):
            live.add(key)
            if linted and key not in registry:
                near = difflib.get_close_matches(key, registry, n=3,
                                                 cutoff=0.6)
                hint = (" - did you mean: " + ", ".join(near)
                        if near else "")
                out.append(Violation(
                    "conf-key-registry", sf.rel, line,
                    f"conf key {key!r} is not registered (no "
                    f"_register(...) in conf.py or a late registrar): a "
                    f"fresh conf's get raises KeyError for it{hint}"))

    for key, (rel, line) in sorted(registry.items()):
        group = {key, aliases.get(key, key)}
        if group & live:
            continue
        out.append(Violation(
            "conf-key-registry", rel, line,
            f"registered conf key {key!r} has no literal call site under "
            f"the linted tree or the port's tests: dead key; wire it up "
            f"or delete the registration"))
    return out
