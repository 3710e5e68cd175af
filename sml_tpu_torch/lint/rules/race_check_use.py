"""race-check-then-use.

Two legs, both about a reader that checks shared state and then uses
it while another thread role can change it between the two:

1. **Re-load** (the JAX package's rule): a method checks `self._attr`
   (`if self._attr is None: ...`) and then LOADS IT AGAIN to use it,
   while another thread role can rebind the attribute between the two
   loads: the check passes and the use fails. Flagged: >=2 loads of one
   `self.<attr>` in a single method, outside any lock that guards every
   foreign-role write of that attribute, when such a foreign writer
   exists. One load is atomic under the GIL, which is why the fix is the
   snapshot idiom:

       obj = self._attr          # ONE load
       if obj is None: ...       # every later use sees the same object
       obj.transform(X)

   or holding the writers' lock across the whole check and use.

2. **Publish order** (the port's): a thread role publishes two
   attributes unguarded in one method, `self.A` and later `self.B`,
   and a method of another role WAITS on `self.A` (loads it in a
   `while` test). A caller released by that wait can read `self.B`
   (any unlocked load of it in the waiter's role) before the writer
   has published it: the reader sees the new A with the old B. Flagged
   at the write of `self.B`; the fix publishes `self.B` first, so that
   `self.A` is the commit. This is the streaming fault the port had: a
   trigger marked its files processed before it appended their
   progress entry, and `processAllAvailable` (which waits on the
   processed files) returned with the entry missing.

Orderings the analysis cannot see (the value is immutable once set, the
reader is gated on an `Event`) get a pragma naming the ordering.
"""

from __future__ import annotations

from typing import List

from .. import threads
from ..core import Violation, rule
from ..project import Project

RULE = "race-check-then-use"


def _reload(analysis, rec, lk) -> List[Violation]:
    out: List[Violation] = []
    for attr, accesses in sorted(rec.attr_accesses().items()):
        post = [a for a in accesses if not a.in_init]
        writes = [a for a in post if a.kind in ("write", "mutate")]
        if not writes:
            continue
        rs = {a: threads.roleset_of(analysis, rec, a.method) for a in post}
        for method in sorted({a.method for a in post}):
            mset = threads.roleset_of(analysis, rec, method)
            foreign = [w for w in writes
                       if rs[w] != mset and (rs[w] or mset)]
            if not foreign:
                continue
            guard = lk(foreign[0])
            for w in foreign[1:]:
                guard = guard & lk(w)
            loads = [a for a in post
                     if a.method == method and a.kind == "read"
                     and not (lk(a) & guard)]
            if len(loads) < 2:
                continue
            w = foreign[0]
            out.append(Violation(
                RULE, rec.rel, loads[1].lineno,
                f"`self.{attr}` is loaded {len(loads)} times in "
                f"`{method}` while `{w.method}` (role "
                f"{threads.short_role(rs[w])}) can rebind it between the "
                f"loads — snapshot it once (`x = self.{attr}`) and use "
                f"the local, or hold the writers' lock across the "
                f"check and the use"))
    return out


def _publish_order(analysis, rec, lk) -> List[Violation]:
    out: List[Violation] = []
    seen = set()
    post = [a for a in rec.accesses if not a.in_init]
    waits = [a for a in post if a.kind == "read" and a.in_wait
             and not lk(a)]
    if not waits:
        return out
    rs = {a: threads.roleset_of(analysis, rec, a.method) for a in post}
    for writer in sorted({a.method for a in post}):
        wset = threads.roleset_of(analysis, rec, writer)
        if not wset:
            continue        # a caller-thread writer orders its own reads
        first = {}
        for a in post:
            if a.method == writer and a.kind in ("write", "mutate") \
                    and not lk(a):
                if a.attr not in first or a.lineno < first[a.attr].lineno:
                    first[a.attr] = a
        for wait in waits:
            gate = first.get(wait.attr)
            if gate is None or rs[wait] == wset:
                continue
            for attr, w in sorted(first.items()):
                if attr == wait.attr or w.lineno <= gate.lineno:
                    continue
                readers = [a for a in post if a.attr == attr
                           and a.kind == "read" and rs[a] == rs[wait]
                           and not lk(a)]
                if not readers or (w.lineno, wait.attr) in seen:
                    continue
                seen.add((w.lineno, wait.attr))
                out.append(Violation(
                    RULE, rec.rel, w.lineno,
                    f"`self.{attr}` is published after `self.{wait.attr}` "
                    f"in `{writer}` (role {threads.short_role(wset)}), "
                    f"but `{wait.method}` waits on `self.{wait.attr}`: a "
                    f"caller it releases can read `self.{attr}` (in "
                    f"`{readers[0].method}`) before it lands; publish "
                    f"`self.{attr}` first"))
    return out


@rule(RULE,
      "re-reading self.<attr> after a check while a foreign thread role "
      "can rebind it, or waiting on one attribute a writer publishes "
      "before another")
def check(project: Project) -> List[Violation]:
    analysis = threads.analyze(project)
    out: List[Violation] = []
    for rec in analysis.classes:
        if not threads.participates(analysis, rec):
            continue
        ement = threads.entry_methods(analysis, rec)

        def lk(a, rec=rec, ement=ement):
            return rec.effective_locks(a, ement)

        out.extend(_reload(analysis, rec, lk))
        out.extend(_publish_order(analysis, rec, lk))
    return out
