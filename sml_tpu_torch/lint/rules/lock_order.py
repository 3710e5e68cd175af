"""lock-order.

Two locks acquired in inconsistent nesting order across call sites is
the classic ABBA deadlock: thread 1 holds A and wants B, thread 2 holds
B and wants A, and the process hangs in a shape no unit test reproduces
on demand. The port's lock population is small and almost flat (the
endpoint's swap and canary locks, the staging caches' locks, the
recorder and metrics locks, the fleet's and the batcher's conditions):
precisely where a single inverted pair slips through review.

The analysis records every `with <lock>:` entered while another known
lock (a `self.<attr>` assigned from `threading.Lock/RLock/Condition/
Semaphore`, or a module-level lock) is held, project-wide, and flags
every (A, B) pair that also appears as (B, A). Lock identity is static:
per (class, attr) or (module, name) — two *instances* of one class
locking against each other collapse to a self-pair and are skipped
(keep instance-pair APIs like `merge(self, other)` single-threaded or
tie-break on `id()`). Nesting is SYNTACTIC and intra-function: a lock
taken inside a callee while the caller holds another (including the
helper-under-lock convention the race rules model) records no pair —
an ABBA built across a call boundary is invisible to this rule.

Fix by picking one global order (document it where the locks are
declared) and re-nesting the minority sites; if a pair is provably
never held concurrently, pragma the site with the proof. The rule is
the JAX package's, over the port's thread model (`lint/threads.py`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .. import threads
from ..core import Violation, rule
from ..project import Project

RULE = "lock-order"


@rule(RULE,
      "two locks acquired in inconsistent nesting order across sites "
      "(ABBA deadlock) — pick one global order and re-nest")
def check(project: Project) -> List[Violation]:
    analysis = threads.analyze(project)
    #: ordered pair -> [(rel, lineno), ...]
    pairs: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
    for outer, inner, rel, lineno in analysis.acquisitions:
        pairs.setdefault((outer, inner), []).append((rel, lineno))
    out: List[Violation] = []
    for (a, b), sites in sorted(pairs.items()):
        if (b, a) not in pairs:
            continue
        # every site of BOTH orders flags (the reversed pair gets its
        # own iteration), each citing one opposite-order site
        other_rel, other_line = pairs[(b, a)][0]
        for rel, lineno in sites:
            out.append(Violation(
                RULE, rel, lineno,
                f"lock `{threads.short_lock(a)}` is held while acquiring "
                f"`{threads.short_lock(b)}` here, but {other_rel}:{other_line} "
                f"acquires them in the opposite order — an ABBA "
                f"deadlock; pick one global order and re-nest"))
    return out
