"""The torchlint driver: parse once, run every rule, apply pragma and
baseline suppression, report.

`run()` is the one entry used by `scripts/torch_lint.py`,
`chip_smoke.py`'s lint phase (through the runner) and the tests (which
feed it in-memory fixture projects).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import baseline as baseline_mod
from . import pragmas as pragmas_mod
from .core import RULES, Violation
from .project import Project


@dataclass
class Report:
    violations: List[Violation]
    rule_names: List[str]
    n_files: int
    n_suppressed_pragma: int = 0
    n_suppressed_baseline: int = 0
    #: per-rule check() wall time, seconds
    rule_times: Dict[str, float] = field(default_factory=dict)
    #: the suppressed violations with how each was silenced ("pragma" |
    #: "baseline"): the --json per-violation status surface
    suppressed_detail: List[Tuple[Violation, str]] = \
        field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.violations

    def format(self) -> str:
        lines = [v.format() for v in self.violations]
        supp = (f"(suppressed: {self.n_suppressed_pragma} by pragma, "
                f"{self.n_suppressed_baseline} by baseline)")
        if self.violations:
            lines.append(f"torchlint: {len(self.violations)} violation(s) "
                         f"across {self.n_files} files, "
                         f"{len(self.rule_names)} rules {supp}")
        else:
            lines.append(f"torchlint clean: {len(self.rule_names)} rules "
                         f"over {self.n_files} files {supp}")
        return "\n".join(lines)


def run(root: Optional[str] = None, project: Optional[Project] = None,
        rule_names: Optional[Sequence[str]] = None,
        baseline_path: Optional[str] = None,
        use_baseline: bool = True) -> Report:
    """Lint `project` (or build one from `root`). `rule_names` narrows to
    a subset; `baseline_path` defaults to
    <root>/sml_tpu_torch/lint/baseline.json.
    """
    if project is None:
        if root is None:
            raise ValueError("run() needs a root or a project")
        project = Project.from_root(root)

    names = list(rule_names) if rule_names else sorted(RULES)
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)}; "
                       f"known: {', '.join(sorted(RULES))}")

    raw: List[Violation] = []
    for f in project.files:
        if f.parse_error is not None:
            raw.append(Violation(
                "syntax-error", f.rel, f.parse_error.lineno or 0,
                f"file does not parse: {f.parse_error.msg}"))
    rule_times: Dict[str, float] = {}
    for name in names:
        t0 = time.monotonic()
        raw.extend(RULES[name].check(project))
        rule_times[name] = time.monotonic() - t0

    # stamp the snippet fingerprint (rules may leave it empty)
    stamped: List[Violation] = []
    for v in raw:
        if v.snippet or v.path not in project.by_rel:
            stamped.append(v)
        else:
            stamped.append(Violation(
                v.rule, v.path, v.line, v.message,
                project.by_rel[v.path].line_at(v.line)))

    kept, pragma_meta = pragmas_mod.apply(project.files, stamped,
                                          active_rules=names)
    n_pragma = len(stamped) - len(kept)
    kept_ids = {id(v) for v in kept}
    suppressed = [(v, "pragma") for v in stamped if id(v) not in kept_ids]

    base_meta: List[Violation] = []
    n_base = 0
    if use_baseline:
        if baseline_path is None:
            baseline_path = os.path.join(project.root,
                                         baseline_mod.DEFAULT_BASENAME)
        entries = baseline_mod.load(baseline_path)
        before = len(kept)
        after, base_meta = baseline_mod.apply(kept, entries,
                                              active_rules=names)
        n_base = before - len(after)
        after_ids = {id(v) for v in after}
        suppressed.extend((v, "baseline") for v in kept
                          if id(v) not in after_ids)
        kept = after

    final = sorted(kept + pragma_meta + base_meta,
                   key=lambda v: (v.path, v.line, v.rule, v.message))
    suppressed.sort(key=lambda p: (p[0].path, p[0].line, p[0].rule))
    return Report(final, names, len(project.files),
                  n_suppressed_pragma=n_pragma, n_suppressed_baseline=n_base,
                  rule_times=rule_times, suppressed_detail=suppressed)
