"""race-unguarded-shared-write.

An instance attribute touched from two thread roles (a flush worker and
the caller, a trigger loop and the caller, a listener callback and the
serving path) is SHARED STATE, and its writes need a discipline the GIL
does not provide:

- **lock-guarded**: every post-`__init__` write happens inside one
  common `with self._lock:` block (readers either hold the same lock or
  take one atomic snapshot — the read side is `race-check-then-use`'s
  jurisdiction);
- **published**: writes come from ONE role only and are plain rebinds,
  and every cross-role reader loads the attribute at most once outside
  the lock (the snapshot idiom: `obj = self._attr`, then use the local).

Anything else is flagged at the write site:

- writes from >=2 different roles with no common lock — lost updates
  (`self.x += 1` from two threads) or torn multi-attribute invariants;
- an unguarded single-role write whose cross-role reader re-reads the
  attribute (>=2 unlocked loads in one method): the writer can swap
  the value between the reader's loads.

Fix by taking the class's lock around the write (and the readers), or
by keeping the single-writer publish pattern and snapshotting every
reader. Happens-before established by other means (an `Event.set` the
reader waits on) is invisible to this analysis: suppress those with a
pragma that names the ordering. The rule is the JAX package's, over the
port's thread model (`lint/threads.py`).
"""

from __future__ import annotations

from typing import List

from .. import threads
from ..core import Violation, rule
from ..project import Project

RULE = "race-unguarded-shared-write"


@rule(RULE,
      "instance attributes written from a thread role and accessed from "
      "another role need a common lock or the single-writer publish + "
      "snapshot-reader discipline")
def check(project: Project) -> List[Violation]:
    analysis = threads.analyze(project)
    out: List[Violation] = []
    for rec in analysis.classes:
        if not threads.participates(analysis, rec):
            continue
        ement = threads.entry_methods(analysis, rec)

        def lk(a):
            return rec.effective_locks(a, ement)

        for attr, accesses in sorted(rec.attr_accesses().items()):
            post = [a for a in accesses if not a.in_init]
            writes = [a for a in post if a.kind in ("write", "mutate")]
            if not writes or not threads.multi_role(analysis, rec, post):
                continue
            common = lk(writes[0])
            for w in writes[1:]:
                common = common & lk(w)
            if common:
                continue    # lock-guarded writes: read side is rule 9's
            rs = {a: threads.roleset_of(analysis, rec, a.method)
                  for a in post}
            writer_sets = {rs[w] for w in writes}
            if len(writer_sets) >= 2:
                flagged = [w for w in writes if not lk(w)] or writes[:1]
                roles = sorted({r for s in writer_sets for r in s}
                               or {"main"})
                for w in flagged:
                    out.append(Violation(
                        RULE, rec.rel, w.lineno,
                        f"`self.{attr}` is written from multiple thread "
                        f"roles ({', '.join(threads.short_role(r) for r in roles)}; "
                        f"methods "
                        f"{', '.join(sorted({x.method for x in writes}))}) "
                        f"with no common lock — guard every write (and "
                        f"read) with one `with self.<lock>:` block"))
                continue
            # single-writer publish: every cross-role reader must be a
            # snapshot (<=1 unlocked load per method)
            wset = next(iter(writer_sets))
            for method in sorted({a.method for a in post
                                  if rs[a] != wset}):
                unlocked = [a for a in post
                            if a.method == method and a.kind == "read"
                            and not lk(a)]
                if len(unlocked) >= 2:
                    w = next((x for x in writes if not lk(x)), writes[0])
                    out.append(Violation(
                        RULE, rec.rel, w.lineno,
                        f"`self.{attr}` is published unguarded from "
                        f"`{w.method}` (role "
                        f"{threads.short_role(wset)}) but "
                        f"`{method}` re-reads it {len(unlocked)} times — "
                        f"snapshot it to a local in `{method}` or guard "
                        f"both sides with a lock"))
                    break
    return out
