"""The committed violation baseline.

`sml_tpu_torch/lint/baseline.json` holds the violations that were looked
at and are carried. Each entry names the rule, the file, the offending
source line (stripped: line numbers drift, code lines rarely do), and a
reviewed reason:

    {"entries": [
      {"rule": "host-sync-in-hot-path",
       "file": "sml_tpu_torch/ml/tree_impl.py",
       "code": "host.append(torch.stack(packs, dim=1).cpu().numpy())",
       "reason": "one copy of a segment's packs; ..."}]}

Hygiene mirrors the pragmas: an entry with a missing or TODO reason, an
entry that matches nothing in the tree (fixed code, stale baseline) and
an entry whose `count` exceeds what is left are reported under
`torchlint-baseline`, so the baseline shrinks only through real fixes
and cannot rot silently.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from .core import Violation

#: the baseline's path, relative to the repo root
DEFAULT_BASENAME = "sml_tpu_torch/lint/baseline.json"


def load(path: str) -> List[Dict[str, str]]:
    if not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return list(data.get("entries", []))


def save(path: str, entries: List[Dict[str, str]]) -> None:
    entries = sorted(entries, key=lambda e: (e.get("file", ""),
                                             e.get("rule", ""),
                                             e.get("code", "")))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"entries": entries}, fh, indent=1)
        fh.write("\n")


def _matches(entry: Dict[str, str], v: Violation) -> bool:
    return (entry.get("rule") == v.rule
            and entry.get("file") == v.path
            and entry.get("code", "") == v.snippet)


def apply(violations: List[Violation], entries: List[Dict[str, str]],
          baseline_rel: str = DEFAULT_BASENAME,
          active_rules: Optional[Iterable[str]] = None
          ) -> Tuple[List[Violation], List[Violation]]:
    """(kept violations, baseline-hygiene violations).

    Each entry suppresses at most `count` occurrences (default 1) of its
    (rule, file, code) fingerprint: a second identical violating line
    added later is not blessed by an existing entry. Hygiene (reason,
    stale, over-count) judges only entries whose rule is in
    `active_rules` (None = all), so a partial `--rule NAME` run cannot
    flag another rule's entries as stale."""
    active = set(active_rules) if active_rules is not None else None
    matched = [0] * len(entries)
    kept: List[Violation] = []
    for v in violations:
        hit = None
        for i, e in enumerate(entries):
            if _matches(e, v) and matched[i] < int(e.get("count", 1)):
                hit = i
                break
        if hit is None:
            kept.append(v)
        else:
            matched[hit] += 1

    meta: List[Violation] = []
    for i, e in enumerate(entries):
        if active is not None and e.get("rule") not in active:
            continue
        label = f"{e.get('rule', '?')} @ {e.get('file', '?')}"
        reason = (e.get("reason") or "").strip()
        count = int(e.get("count", 1))
        if not reason or reason.upper().startswith("TODO"):
            meta.append(Violation(
                "torchlint-baseline", baseline_rel, 1,
                f"baseline entry [{label}] has no reviewed reason "
                f"(reason={reason!r}): justify or fix the violation"))
        if matched[i] == 0:
            meta.append(Violation(
                "torchlint-baseline", baseline_rel, 1,
                f"stale baseline entry [{label}] matches nothing in the "
                f"tree: the violation was fixed; delete the entry"))
        elif matched[i] < count:
            meta.append(Violation(
                "torchlint-baseline", baseline_rel, 1,
                f"baseline entry [{label}] carries count={count} but only "
                f"{matched[i]} occurrence(s) remain: shrink the count"))
    return kept, meta


def update(path: str, violations: List[Violation],
           existing: Optional[List[Dict[str, str]]] = None
           ) -> List[Dict[str, str]]:
    """--update-baseline: re-emit entries for the current violations,
    keeping reviewed reasons for entries that still match and stamping
    new ones with a TODO reason (which the lint then flags until it is
    replaced by a reviewed one: an unreviewed baseline never passes)."""
    existing = existing if existing is not None else load(path)
    counts: Dict[tuple, int] = {}
    for v in violations:
        key = (v.rule, v.path, v.snippet)
        counts[key] = counts.get(key, 0) + 1
    out: List[Dict[str, str]] = []
    for (vrule, vpath, vsnippet), n in counts.items():
        reason = "TODO: justify this suppression"
        for e in existing:
            if (e.get("rule") == vrule and e.get("file") == vpath
                    and e.get("code", "") == vsnippet):
                reason = e.get("reason", reason)
                break
        entry: Dict[str, object] = {"rule": vrule, "file": vpath,
                                    "code": vsnippet, "reason": reason}
        if n > 1:
            entry["count"] = n
        out.append(entry)
    save(path, out)
    return out
