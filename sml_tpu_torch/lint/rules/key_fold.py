"""per-chip-key-fold: a rank's randomness comes from slicing the fit's
draw, never from folding its rank into the key.

The port's contract (ROADMAP §3): each rank draws all of a fit's rows
from the one key and slices its own block (`mesh.row_range`), so a fit
over N ranks consumes the same random streams as a fit on one device
and yields the same trees. Folding a rank-local value into the key
(`prng.fold_in(key, axis_index())`, `fold_in(key, mesh.rank)`) makes
the stream depend on the mesh's layout, and N-rank fits stop matching
one-rank fits.

Flagged: any `fold_in(...)` / `fold_in_keys(...)` call
(`sml_tpu_torch/utils/prng.py`) whose folded operand is rank-local
(`lint/regions.py`'s list, conf reads aside), directly or through a
local assigned from one. Folding a round number, a tree index or a
column id stays fine.
"""

from __future__ import annotations

from typing import List

from .. import regions
from ..core import Violation, rule
from ..project import Project

RULE = "per-chip-key-fold"


@rule(RULE,
      "no fold_in of a rank-local value into a PRNG key; draw from the "
      "fit's key and slice the rank's rows")
def check(project: Project) -> List[Violation]:
    analysis = regions.analyze(project)
    return [Violation(
        RULE, site.rel, site.lineno,
        f"`fold_in` folds {site.detail} into a PRNG key: the random "
        f"stream depends on the mesh's layout and N-rank fits stop "
        f"matching one-rank fits; draw from the fit's key and take this "
        f"rank's rows with a slice (`mesh.row_range`)")
        for site in analysis.fold_sites]
