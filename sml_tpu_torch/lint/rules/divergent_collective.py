"""divergent-collective: a collective under a rank-local branch is the
multi-rank deadlock shape.

A collective is a rendezvous: EVERY rank of the group must make the
same calls in the same order. When a branch around a collective tests
a value that can differ between ranks (the rank itself, a mesh's
`.rank` or `.lane`, `row_range`, `os.environ`, `sys.*`, a conf read:
`lint/regions.py` lists them), some ranks make the call and the others
do not, and the ones that did wait forever (or until the group's
timeout) for the ones that did not.

Flagged: a collective site inside an `if` / `while` / ternary whose test
reads a rank-local value, or after an `if` on one whose one arm leaves
the block early (`return`, `raise`, `continue`, `break`), unless the
other arm makes the same collective. Rank-dependent work BEFORE a
collective that every rank reaches is the sanctioned shape: the
lowest-rank checkpoint writer (`ct/_checkpoint._writer`) writes on rank
0 only, then every rank makes one MAX all-reduce of the failure flag.

The wrapper bodies of `parallel/collectives.py` that bear a
collective's name (`ppermute` pairs its sends and receives by rank on
purpose) and `axis_index` (no rendezvous) are exempt.
"""

from __future__ import annotations

from typing import List

from .. import regions
from ..core import Violation, rule
from ..project import Project

RULE = "divergent-collective"


@rule(RULE,
      "no collectives under branches on rank-local values (the rank, "
      "os.environ, sys.*, conf reads) unless both arms make them")
def check(project: Project) -> List[Violation]:
    analysis = regions.analyze(project)
    out: List[Violation] = []
    for site in analysis.collectives:
        if site.divergent is None:
            continue
        if site.fn_name in regions.COLLECTIVE_OPS \
                and regions.in_module(site.rel, regions.COLLECTIVES_MODULE):
            continue
        where = f"`{site.fn_name}`" if site.fn_name else "module level"
        out.append(Violation(
            RULE, site.rel, site.lineno,
            f"collective `{site.op}` in {where} is guarded by a branch on "
            f"{site.divergent}: ranks can disagree on whether they make "
            f"it and deadlock at the rendezvous; make the call on every "
            f"rank (branch on the work before it) or in both arms"))
    return out
