"""collective-axis-discipline: every collective names an axis the mesh
declares, and runs where a mesh is held.

`coll.psum(x, axis="dtaa")` parses and imports fine and fails only when
a fit reaches it, on every rank at once (`collectives._resolve` raises
on an unknown axis); a collective in code that no mesh reaches either
finds no mesh and raises, or reduces over whatever mesh the thread
happens to hold. Both legs read the models of `lint/regions.py`:

* an axis literal at a collective site (the `axis` argument, or each
  hop's `ici_axis=` / `dcn_axis=` of `psum_hierarchical`) that
  `parallel/mesh.py` does not declare (`DATA_AXIS`, `DCN_AXIS`,
  `ICI_AXIS`, `TRIAL_AXIS`);
* a collective site at module level, or in a function that no mesh
  region reaches (`regions.analyze(...).regions`).

The bodies of `parallel/collectives.py` are exempt (the wrappers compose
each other and make the raw calls by design), as are sites whose axis
stays dynamic (a parameter: the wrapper-default pattern).
"""

from __future__ import annotations

from typing import List

from .. import regions
from ..core import Violation, rule
from ..project import Project

RULE = "collective-axis-discipline"


@rule(RULE,
      "collectives must name axes parallel/mesh.py declares and run in "
      "functions a mesh region reaches")
def check(project: Project) -> List[Violation]:
    analysis = regions.analyze(project)
    out: List[Violation] = []
    declared = analysis.declared_axes
    for site in analysis.collectives:
        if regions.in_module(site.rel, regions.COLLECTIVES_MODULE):
            continue
        if site.axis_kind == "literal" and declared \
                and site.axis not in declared:
            out.append(Violation(
                RULE, site.rel, site.lineno,
                f"collective `{site.op}` names axis '{site.axis}', which "
                f"parallel/mesh.py does not declare (declared: "
                f"{', '.join(sorted(declared))}): use the mesh's axis "
                f"constants instead of a string literal"))
            continue
        if site.fn_key is None:
            out.append(Violation(
                RULE, site.rel, site.lineno,
                f"collective `{site.op}` at module level: no mesh is held "
                f"at import; call it from a function a mesh is handed to"))
        elif site.fn_key not in analysis.regions:
            out.append(Violation(
                RULE, site.rel, site.lineno,
                f"collective `{site.op}` in `{site.fn_name}`, which no "
                f"mesh region reaches (no mesh is obtained there or "
                f"handed to it): it raises without a mesh or reduces "
                f"over whatever mesh the thread holds; pass the mesh in "
                f"(`mesh=`) or obtain it (`get_mesh`, `mesh_for`)"))
    return out
