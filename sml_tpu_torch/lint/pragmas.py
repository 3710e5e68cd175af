"""Suppression pragmas.

Syntax (in a comment, alone or trailing code):

    # torchlint: disable=<rule>[,<rule2>] -- <reason>
    # torchlint: disable-file=<rule>[,<rule2>] -- <reason>

`disable` suppresses matching violations on its own line, or, when the
line holds only the comment, on the next line (for statements too long
to carry a trailing comment). `disable-file` suppresses the rule for the
whole file, wherever it appears.

The JAX package's linter reads `# graftlint:` pragmas and this one reads
only `# torchlint:` pragmas, so neither linter judges the other's.

Hygiene is enforced: a pragma with no `-- reason`, naming an unknown
rule, or suppressing nothing at all is itself reported (rule
`torchlint-pragma`), so the committed tree cannot gather unexplained or
stale suppressions.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Tuple

from .core import RULES, SourceFile, Violation

_RX = re.compile(
    r"#\s*torchlint:\s*(disable(?:-file)?)="
    r"([A-Za-z0-9_,\-]+)"
    r"(?:\s*--\s*(\S.*))?")


class Pragma:
    def __init__(self, rel: str, line: int, scope: str,
                 rules: List[str], reason: str):
        self.rel = rel
        self.line = line
        self.scope = scope          # "line" | "file"
        self.rules = rules
        self.reason = (reason or "").strip()
        self.used = False

    def covers(self, v: Violation) -> bool:
        if v.path != self.rel or v.rule not in self.rules:
            return False
        return self.scope == "file" or v.line == self.line


def collect(sf: SourceFile) -> List[Pragma]:
    out: List[Pragma] = []
    for i, raw in enumerate(sf.lines, start=1):
        m = _RX.search(raw)
        if not m:
            continue
        scope = "file" if m.group(1) == "disable-file" else "line"
        rules = [r.strip() for r in m.group(2).split(",") if r.strip()]
        line = i
        if scope == "line" and raw.strip().startswith("#"):
            line = i + 1  # comment-only line: the pragma guards the next one
        out.append(Pragma(sf.rel, line, scope, rules, m.group(3) or ""))
    return out


def apply(files: Iterable[SourceFile], violations: List[Violation],
          active_rules: Optional[Iterable[str]] = None
          ) -> Tuple[List[Violation], List[Violation]]:
    """(kept violations, pragma-hygiene violations).

    `active_rules` is the set of rules this run executed (None = all):
    hygiene judges a pragma only against rules that ran, so a partial
    `--rule NAME` run cannot flag another rule's pragmas as unused."""
    active = set(active_rules) if active_rules is not None else set(RULES)
    pragmas: List[Pragma] = []
    for sf in files:
        pragmas.extend(collect(sf))

    kept: List[Violation] = []
    for v in violations:
        hit = None
        for p in pragmas:
            if p.covers(v):
                hit = p
                break
        if hit is not None:
            hit.used = True
        else:
            kept.append(v)

    meta: List[Violation] = []
    for p in pragmas:
        where = p.line if p.scope == "line" else 1
        judged = bool(set(p.rules) & active) \
            or any(r not in RULES for r in p.rules)
        if not p.reason and judged:
            meta.append(Violation(
                "torchlint-pragma", p.rel, where,
                f"pragma disable={','.join(p.rules)} carries no "
                f"'-- reason' justification"))
        for r in p.rules:
            if r not in RULES:  # a typo is never valid, whatever ran
                meta.append(Violation(
                    "torchlint-pragma", p.rel, where,
                    f"pragma names unknown rule {r!r}"))
        # "unused" is judged only when every rule the pragma names ran
        if not p.used and set(p.rules) <= active:
            meta.append(Violation(
                "torchlint-pragma", p.rel, where,
                f"unused pragma (disable={','.join(p.rules)} suppresses "
                f"nothing: delete it or fix the rule name)"))
    return kept, meta
