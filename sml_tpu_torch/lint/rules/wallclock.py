"""no-wallclock-in-engine: one clock.

The flight recorder's timeline and the dispatch audit's walls are whole
only if every timing in the port goes through ONE clock:
`sml_tpu_torch/utils/profiler.py` (spans, `now()`, `wallclock()`). A
module-private `time.time()` / `time.perf_counter()` makes timestamps
the recorder can never line up with its events.

Flags `time.time()` and `time.perf_counter()` calls (attribute form, or
names imported `from time import ...`) everywhere in the linted tree
EXCEPT `sml_tpu_torch/utils/profiler.py` and `sml_tpu_torch/obs/` (the
clock's owners). `time.monotonic()` is exempt: an ageing clock for
arithmetic, never a timestamp in a timeline.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..core import Violation, rule
from ..project import Project

BANNED = {"time", "perf_counter"}
EXEMPT_PREFIXES = ("sml_tpu_torch/obs/",)
EXEMPT_FILES = ("sml_tpu_torch/utils/profiler.py",)


@rule("no-wallclock-in-engine",
      "time.time()/perf_counter() outside utils/profiler.py and obs/ "
      "must go through the profiler clock")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for f in project.files:
        if f.tree is None or f.rel in EXEMPT_FILES \
                or f.rel.startswith(EXEMPT_PREFIXES):
            continue
        # names bound by `from time import time, perf_counter [as x]`
        local_banned: Set[str] = set()
        for node in f.nodes:
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in BANNED:
                        local_banned.add(alias.asname or alias.name)
        for node in f.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            hit = None
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "time" and fn.attr in BANNED):
                hit = f"time.{fn.attr}()"
            elif isinstance(fn, ast.Name) and fn.id in local_banned:
                hit = f"{fn.id}()"
            if hit:
                out.append(Violation(
                    "no-wallclock-in-engine", f.rel, node.lineno,
                    f"`{hit}` outside the profiler: use "
                    f"utils.profiler.now() (monotonic timing) / "
                    f".wallclock() (epoch timestamps) or a PROFILER.span "
                    f"so the flight-recorder timeline stays whole"))
    return out
