"""Mesh regions and the distributed-semantics models under the
distributed rules (`collective-axis-discipline`, `divergent-collective`,
`per-chip-key-fold`).

In the JAX package a collective is an operation inside a traced program
over a named mesh axis. In the port it is a host call on a
`torch.distributed` process group: `parallel/collectives.py` resolves
the axis to the group of the calling rank's mesh (`_resolve`) and every
rank of that group must make the same call, in the same order. This
module rebuilds, statically, what the rules need to know about those
calls:

1. **Collective sites** (`collectives`): every call of a wrapper of
   `parallel/collectives.py` (`psum`, `psum_scalars`, `pmean`, `pmax`,
   `pmin`, `all_gather`, `reduce_scatter`, `all_to_all`, `ppermute`,
   `psum_hierarchical`, `masked_count`, `axis_index`,
   `all_gather_object`) and every raw `dist.<collective>(...)` /
   `torch.distributed.<collective>(...)` call (`DIST_COLLECTIVES`,
   `new_group` among them: every member must call it), each with its
   axis argument: a literal, an axis constant or a local alias of one
   (kind "literal"), a parameter (kind "dynamic", judged by no rule),
   none (kind "default", the wrapper's "data"), or a raw call's
   `group=` (kind "group"). `psum_hierarchical` records one site for
   each hop keyword it passes (`ici_axis=`, `dcn_axis=`). A collective
   inside a lambda belongs to the function that holds the lambda.

2. **Declared axes** (`declared_axes`): the module-level `<NAME>_AXIS =
   "literal"` constants of `parallel/mesh.py` (`DATA_AXIS`, `DCN_AXIS`,
   `ICI_AXIS`, `TRIAL_AXIS`), the only axes `_resolve` accepts. Axis
   constants of any module resolve to their literal (`axis_constants`).

3. **Mesh regions** (`regions`): a collective needs a mesh, and a
   function holds one when one is handed to it. Seeds are every
   function that obtains a mesh from the mesh API (`MESH_SOURCES`:
   `get_mesh`, `build_mesh`, `host_mesh`, `trial_mesh`, `submeshes`,
   `mesh_over`, `dispatch.mesh_for`, `_staging.mesh_rows`, or a
   `Mesh(...)` / `Shard(...)` it builds), every function that takes a
   `*mesh` or `shard` parameter, every function a call hands a mesh to
   (a `mesh=` / `shard=` keyword, or a positional argument that is a
   `*mesh` name, a `.mesh` attribute or a mesh-API call), the functions
   handed to `run_placed_trials`, and `elastic_fit`. Regions
   propagate over the project call graph (the form-aware resolution of
   `lint/threads.py`) and into the nested defs of a region function,
   which close over its mesh.

4. **Rank-local values** (`rank_local`): a value that can differ
   between the ranks of one mesh: `dist.get_rank()`, `axis_index`,
   `row_range` / `shard_rows`, a mesh's `.rank` and a trial mesh's
   `.lane` (but not a `.rank is None` membership test), `os.environ` /
   `os.getenv`, the interpreter's state (`sys`), the host's name or
   pid, and conf getters (each process has its own conf), plus
   locals assigned from one (one assignment level deep, two passes,
   tuple targets included). Branches on such a value decide whether a
   rank reaches a collective: the test of an `if` / `while` / ternary
   around the call, and an `if` whose one arm ends the block (`return`,
   `raise`, `continue`, `break`) before it, each unless the other arm
   makes the same collective (`CollectiveSite.divergent`).

5. **Key folds** (`fold_sites`): `fold_in(key, x)` /
   `fold_in_keys(keys, x)` (`utils/prng.py`) whose folded value is
   rank-local (conf reads aside).

Left out, with no counterpart in eager torch: the JAX model's
traced-region inference (nothing here is traced: a collective runs when
the host calls it), the compile-input model (program cache keys, trace
time conf reads and the prewarm-signature join: eager torch compiles
nothing per shape, and the kernels' plans come from shapes on the
host) and buffer donation (torch has none). Deliberate limits: taint is
one assignment level deep; a mesh handed over only through a container
or an attribute of another object is invisible; and the matching of two
arms compares collective names, not their operands or axes.
Everything here is stdlib `ast` only.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .project import FunctionInfo, Project, call_target_name, dotted

#: the `parallel/collectives.py` wrappers: a call through one of these
#: simple names is a collective every rank of the axis group makes
COLLECTIVE_OPS = frozenset({
    "psum", "psum_scalars", "pmean", "pmax", "pmin", "all_gather",
    "reduce_scatter", "all_to_all", "ppermute", "psum_hierarchical",
    "axis_index", "all_gather_object", "masked_count",
})

#: a wrapper that reads a rank's index and makes no rendezvous
NON_RENDEZVOUS = frozenset({"axis_index"})

#: raw `torch.distributed` calls that every rank of the group makes
DIST_COLLECTIVES = frozenset({
    "all_reduce", "broadcast", "barrier", "monitored_barrier",
    "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "broadcast_object_list", "gather", "scatter",
    "reduce", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "new_group",
})

#: the TWO-HOP collective: each hop names its own axis in a keyword, so
#: the discipline is checked per hop
HIERARCHICAL_OPS = {"psum_hierarchical": ("ici_axis", "dcn_axis")}

#: the module that declares the axes `collectives._resolve` accepts
MESH_MODULE = "parallel/mesh.py"
#: the wrapper module: its bodies compose each other by design
COLLECTIVES_MODULE = "parallel/collectives.py"

#: calls that hand the caller a mesh
MESH_SOURCES = frozenset({
    "get_mesh", "build_mesh", "host_mesh", "trial_mesh", "submeshes",
    "mesh_over", "mesh_for", "mesh_rows", "Mesh", "Shard",
})

#: calls whose function argument runs over a mesh: name -> its index
MESH_RUNNERS = {"run_placed_trials": 1}
#: functions that build their own mesh of the default group's ranks
MESH_ENTRIES = frozenset({"elastic_fit"})

#: conf accessor method names: `<obj>.get*("sml.*")` is a conf read
CONF_GETTERS = frozenset({"get", "getInt", "getBool", "getFloat"})

#: calls whose result can differ between the ranks of one mesh
RANK_LOCAL_CALLS = frozenset({
    "get_rank", "axis_index", "row_range", "shard_rows", "getenv",
    "gethostname", "getpid", "rank_device", "host_group_of",
})

#: attributes whose value can differ between the ranks of one mesh
RANK_LOCAL_ATTRS = frozenset({"rank", "lane", "environ"})

#: the PRNG folds (`utils/prng.py`)
FOLD_CALLS = frozenset({"fold_in", "fold_in_keys"})


class CollectiveSite:
    """One collective call in the linted tree."""

    __slots__ = ("rel", "lineno", "op", "axis", "axis_kind", "fn_key",
                 "fn_name", "divergent")

    def __init__(self, rel: str, lineno: int, op: str, axis: Optional[str],
                 axis_kind: str, fn_key: Optional[str],
                 fn_name: Optional[str], divergent: Optional[str]):
        self.rel = rel
        self.lineno = lineno
        self.op = op
        self.axis = axis            # resolved axis literal, or None
        #: "literal" | "default" | "dynamic" | "group"
        self.axis_kind = axis_kind
        self.fn_key = fn_key        # enclosing "rel::qualname" (None=module)
        self.fn_name = fn_name      # enclosing simple name
        self.divergent = divergent  # the rank-local test guarding it

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<coll {self.op}({self.axis_kind}:{self.axis}) @ "
                f"{self.rel}:{self.lineno} in {self.fn_key}>")


class FoldSite:
    """A `fold_in(...)` whose folded value is rank-local."""

    __slots__ = ("rel", "lineno", "detail", "fn_key")

    def __init__(self, rel: str, lineno: int, detail: str,
                 fn_key: Optional[str]):
        self.rel = rel
        self.lineno = lineno
        self.detail = detail
        self.fn_key = fn_key


class RegionAnalysis:
    def __init__(self) -> None:
        #: "rel::qualname" -> origin label of the mesh region it is in
        self.regions: Dict[str, str] = {}
        self.declared_axes: Set[str] = set()
        #: axis-constant name -> literal (merged project-wide)
        self.axis_constants: Dict[str, str] = {}
        self.collectives: List[CollectiveSite] = []
        self.fold_sites: List[FoldSite] = []


def analyze(project: Project) -> RegionAnalysis:
    """Memoized on the project (the three rules share one pass)."""
    cached = getattr(project, "_region_analysis", None)
    if cached is not None:
        return cached
    out = _Analyzer(project).run()
    project._region_analysis = out
    return out


def _fn_key(fn: FunctionInfo) -> str:
    return f"{fn.rel}::{fn.qualname}"


def in_module(rel: str, module: str) -> bool:
    return rel == module or rel.endswith("/" + module)


def _exits(stmts: Sequence[ast.stmt]) -> bool:
    """Whether a block always leaves the enclosing block early."""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


class _Analyzer:
    def __init__(self, project: Project):
        self.project = project
        self.index = project.function_index()
        self.by_name = project.functions_by_name()
        #: (rel, scope qualname or "") -> {name: value expr} from simple
        #: assignments (tuple targets map each name to the whole value),
        #: innermost-scope attributed
        self.assigns: Dict[Tuple[str, str], Dict[str, ast.expr]] = {}
        self.out = RegionAnalysis()

    # ------------------------------------------------------------- helpers
    def _local(self, rel: str) -> Dict[str, FunctionInfo]:
        return {fn.name: fn for fn in self.index.get(rel, [])}

    def _resolve_def(self, rel: str, name: str) -> Optional[FunctionInfo]:
        """Simple-name resolution: same module first, then cross-module
        only when exactly one project function bears the name."""
        local = self._local(rel)
        if name in local:
            return local[name]
        cands = self.by_name.get(name, [])
        if len(cands) == 1:
            return cands[0]
        return None

    def _scope_lookup(self, rel: str, scope: str,
                      name: str) -> Optional[ast.expr]:
        """Walk the lexical scope chain ("a.b.c" -> "a.b" -> "a" -> "")
        for the value expression last assigned to `name`."""
        parts = scope.split(".") if scope else []
        while True:
            got = self.assigns.get((rel, ".".join(parts)), {}).get(name)
            if got is not None:
                return got
            if not parts:
                return None
            parts.pop()

    def _nested_defs(self, fn: FunctionInfo) -> List[FunctionInfo]:
        pref = fn.qualname + "."
        return [c for c in self.index.get(fn.rel, [])
                if c.qualname.startswith(pref)]

    def _callees(self, fn: FunctionInfo) -> List[FunctionInfo]:
        """Form-aware call-graph edges (the lint/threads.py resolution:
        `self.m()` binds only within the class, `obj.m()` only when the
        name is project-unique, a bare `f()` prefers same-module defs)."""
        local = self._local(fn.rel)
        own_cls = fn.qualname.rsplit(".", 1)[0] \
            if "." in fn.qualname else None
        out: List[FunctionInfo] = []
        forms = fn.call_forms or [("name", n) for n in fn.calls]
        for form, name in forms:
            if form == "self":
                if own_cls is not None:
                    for cand in self.index.get(fn.rel, []):
                        if cand.qualname == f"{own_cls}.{name}":
                            out.append(cand)
                            break
                continue
            if form == "name" and name in local:
                out.append(local[name])
                continue
            cands = self.by_name.get(name, [])
            if len(cands) == 1:
                out.append(cands[0])
        return out

    # ------------------------------------------------------ pass 1: tables
    def _collect_tables(self) -> None:
        for f in self.project.files:
            if f.tree is None:
                continue
            for node in f.tree.body:
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    name = node.targets[0].id
                    if name.isupper() and name.endswith("AXIS"):
                        self.out.axis_constants[name] = node.value.value
                        if in_module(f.rel, MESH_MODULE):
                            self.out.declared_axes.add(node.value.value)
            for node in f.nodes:
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = node.targets \
                    if isinstance(node, ast.Assign) else [node.target]
                if node.value is None or len(targets) != 1:
                    continue
                names = [targets[0]] if isinstance(targets[0], ast.Name) \
                    else [e for e in getattr(targets[0], "elts", [])
                          if isinstance(e, ast.Name)]
                encl = self.project.enclosing_function(f.rel, node.lineno)
                scope = encl.qualname if encl is not None else ""
                table = self.assigns.setdefault((f.rel, scope), {})
                for t in names:
                    table[t.id] = node.value

    # ------------------------------------------------------- pass 2: regions
    def _is_mesh_value(self, expr: ast.expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id.endswith("mesh")
        if isinstance(expr, ast.Attribute):
            return expr.attr == "mesh"
        if isinstance(expr, ast.Call):
            return call_target_name(expr.func) in MESH_SOURCES
        return False

    def _seeds(self) -> List[Tuple[FunctionInfo, str]]:
        seeds: List[Tuple[FunctionInfo, str]] = []
        for f in self.project.files:
            if f.tree is None:
                continue
            for node in f.nodes:
                if not isinstance(node, ast.Call):
                    continue
                name = call_target_name(node.func) or ""
                encl = self.project.enclosing_function(f.rel, node.lineno)
                where = f"{f.rel}:{node.lineno}"
                if name in MESH_SOURCES and encl is not None:
                    seeds.append((encl, f"{name}@{where}"))
                pos = MESH_RUNNERS.get(name)
                if pos is not None and pos < len(node.args) \
                        and isinstance(node.args[pos], ast.Name):
                    target = self._resolve_def(f.rel, node.args[pos].id)
                    if target is not None:
                        seeds.append((target, f"{name}@{where}"))
                handed = any(kw.arg in ("mesh", "shard")
                             and not (isinstance(kw.value, ast.Constant)
                                      and kw.value.value is None)
                             for kw in node.keywords) \
                    or any(self._is_mesh_value(a) for a in node.args)
                if handed and name not in COLLECTIVE_OPS:
                    target = self._resolve_def(f.rel, name)
                    if target is not None:
                        seeds.append((target, f"mesh->{name}@{where}"))
        for fns in self.index.values():
            for fn in fns:
                # a function that takes a mesh (or a fit's Shard) is
                # handed one; a MESH_ENTRIES function builds its own
                if fn.name in MESH_ENTRIES or any(
                        p.endswith("mesh") or p == "shard"
                        for p in fn.params()):
                    seeds.append((fn, f"mesh@{_fn_key(fn)}"))
        return seeds

    def _propagate(self, seeds: List[Tuple[FunctionInfo, str]]) -> None:
        regions = self.out.regions
        work = list(seeds)
        while work:
            fn, origin = work.pop()
            key = _fn_key(fn)
            if key in regions:
                continue
            regions[key] = origin
            for callee in self._callees(fn) + self._nested_defs(fn):
                work.append((callee, origin))

    # --------------------------------------------------- pass 3: rank taint
    def _taint(self, expr: ast.expr, tainted: Dict[str, str],
               conf: bool = True) -> Optional[str]:
        """Why an expression's value is rank-local, or None. A test of a
        mesh's `.rank` against None is a membership test (a rank outside
        a submesh has rank None), the same on every rank of the mesh."""
        work = [expr]
        while work:
            sub = work.pop()
            if isinstance(sub, ast.Compare) and len(sub.ops) == 1 \
                    and isinstance(sub.ops[0], (ast.Is, ast.IsNot)) \
                    and isinstance(sub.left, ast.Attribute) \
                    and sub.left.attr == "rank" \
                    and isinstance(sub.comparators[0], ast.Constant) \
                    and sub.comparators[0].value is None:
                work.append(sub.left.value)
                continue
            if isinstance(sub, ast.Call):
                if conf and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in CONF_GETTERS and sub.args \
                        and isinstance(sub.args[0], ast.Constant) \
                        and isinstance(sub.args[0].value, str) \
                        and sub.args[0].value.startswith(("sml.",
                                                          "spark.")):
                    return f"conf read `{sub.args[0].value}`"
                name = call_target_name(sub.func)
                if name in RANK_LOCAL_CALLS:
                    return f"`{name}()`"
            elif isinstance(sub, ast.Attribute):
                if sub.attr in RANK_LOCAL_ATTRS:
                    return f"`{dotted(sub) or '.' + sub.attr}`"
            elif isinstance(sub, ast.Name):
                if sub.id == "sys":
                    return "the interpreter's state (`sys`)"
                if sub.id in tainted:
                    return f"`{sub.id}` ({tainted[sub.id]})"
            work.extend(ast.iter_child_nodes(sub))
        return None

    def _fn_taint(self, fn: FunctionInfo, conf: bool = True
                  ) -> Dict[str, str]:
        """Local names carrying rank-local values (one level deep, two
        passes so later assignments see earlier taint)."""
        tainted: Dict[str, str] = {}
        scoped = self.assigns.get((fn.rel, fn.qualname), {})
        for _ in range(2):
            for name, expr in scoped.items():
                if name in tainted:
                    continue
                reason = self._taint(expr, tainted, conf)
                if reason is not None:
                    tainted[name] = reason
        return tainted

    # ----------------------------------------------------- pass 4: sites
    def _axis_of(self, expr: ast.expr, rel: str, scope: str,
                 depth: int = 0) -> Optional[str]:
        """Resolve an expression to an axis-name literal, or None."""
        if depth > 4:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            if expr.id in self.out.axis_constants:
                return self.out.axis_constants[expr.id]
            assigned = self._scope_lookup(rel, scope, expr.id)
            if assigned is not None:
                return self._axis_of(assigned, rel, scope, depth + 1)
            return None
        if isinstance(expr, ast.Attribute) \
                and expr.attr in self.out.axis_constants:
            return self.out.axis_constants[expr.attr]
        return None

    def _site_axis(self, call: ast.Call, rel: str,
                   scope: str) -> Tuple[Optional[str], str]:
        """(axis literal or None, kind): a keyword axis= / axis_name=
        wins; otherwise the unique axis-resolvable positional argument."""
        for kw in call.keywords:
            if kw.arg in ("axis", "axis_name"):
                axis = self._axis_of(kw.value, rel, scope)
                return (axis, "literal") if axis is not None \
                    else (None, "dynamic")
        cands = [self._axis_of(a, rel, scope) for a in call.args]
        hits = [a for a in cands if a is not None]
        if len(hits) == 1:
            return hits[0], "literal"
        if not hits:
            return None, "default"
        return None, "dynamic"

    @staticmethod
    def _collective_op(call: ast.Call) -> Optional[Tuple[str, bool]]:
        """(op name, raw) when `call` is a collective, else None."""
        text = dotted(call.func)
        for prefix in ("dist.", "torch.distributed."):
            if text.startswith(prefix):
                op = text[len(prefix):]
                if op in DIST_COLLECTIVES:
                    return op, True
                return None
        name = call_target_name(call.func)
        if name in COLLECTIVE_OPS and not isinstance(call.func, ast.Call):
            return name, False
        return None

    def _ops_in(self, stmts: Sequence[ast.AST]) -> Set[str]:
        ops: Set[str] = set()
        for st in stmts:
            for sub in ast.walk(st):
                if isinstance(sub, ast.Call):
                    got = self._collective_op(sub)
                    if got is not None:
                        ops.add(got[0])
        return ops

    def _walk_function(self, f, fn: Optional[FunctionInfo]) -> None:
        """One pass over a function body (or the module's top level),
        skipping nested defs (they get their own walk): collective sites
        with their rank-local guards, and fold sites."""
        rel = f.rel
        fn_key = _fn_key(fn) if fn is not None else None
        fn_name = fn.name if fn is not None else None
        scope = fn.qualname if fn is not None else ""
        tainted = self._fn_taint(fn) if fn is not None else {}
        fold_taint = self._fn_taint(fn, conf=False) if fn is not None \
            else {}
        #: (reason, collective ops of the other arm) of each guard
        Guards = List[Tuple[str, Set[str]]]

        def note(call: ast.Call, guards: Guards) -> None:
            got = self._collective_op(call)
            if got is not None:
                op, raw = got
                divergent = None
                if op not in NON_RENDEZVOUS:
                    for reason, other in guards:
                        if op not in other:
                            divergent = reason
                            break
                self._note_collective(call, rel, op, raw, fn_key, fn_name,
                                      scope, divergent)
            elif call_target_name(call.func) in FOLD_CALLS:
                detail = None
                for arg in call.args[1:] + [kw.value
                                            for kw in call.keywords]:
                    detail = self._taint(arg, fold_taint, conf=False)
                    if detail is not None:
                        break
                if detail is not None:
                    self.out.fold_sites.append(
                        FoldSite(rel, call.lineno, detail, fn_key))

        def expr(node: ast.AST, guards: Guards) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(node, ast.IfExp):
                expr(node.test, guards)
                reason = self._taint(node.test, tainted)
                if reason is None:
                    expr(node.body, guards)
                    expr(node.orelse, guards)
                else:
                    expr(node.body, guards + [(reason,
                                               self._ops_in([node.orelse]))])
                    expr(node.orelse, guards + [(reason,
                                                 self._ops_in([node.body]))])
                return
            if isinstance(node, ast.Call):
                note(node, guards)
            for child in ast.iter_child_nodes(node):
                expr(child, guards)

        def block(stmts: Sequence[ast.stmt], guards: Guards) -> None:
            guards = list(guards)
            for st in stmts:
                stmt(st, guards)
                if isinstance(st, ast.If):
                    reason = self._taint(st.test, tainted)
                    if reason is None:
                        continue
                    if _exits(st.body) and not _exits(st.orelse):
                        guards.append((reason, self._ops_in(st.body)))
                    elif _exits(st.orelse) and not _exits(st.body):
                        guards.append((reason, self._ops_in(st.orelse)))

        def stmt(st: ast.stmt, guards: Guards) -> None:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                return
            if isinstance(st, ast.If):
                expr(st.test, guards)
                reason = self._taint(st.test, tainted)
                if reason is None:
                    block(st.body, guards)
                    block(st.orelse, guards)
                else:
                    block(st.body, guards + [(reason,
                                              self._ops_in(st.orelse))])
                    block(st.orelse, guards + [(reason,
                                                self._ops_in(st.body))])
                return
            if isinstance(st, ast.While):
                expr(st.test, guards)
                reason = self._taint(st.test, tainted)
                inner = guards + [(reason, set())] if reason else guards
                block(st.body, inner)
                block(st.orelse, guards)
                return
            if isinstance(st, (ast.For, ast.AsyncFor)):
                expr(st.iter, guards)
                block(st.body, guards)
                block(st.orelse, guards)
                return
            if isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    expr(item.context_expr, guards)
                block(st.body, guards)
                return
            if isinstance(st, ast.Try):
                block(st.body, guards)
                for h in st.handlers:
                    block(h.body, guards)
                block(st.orelse, guards)
                block(st.finalbody, guards)
                return
            expr(st, guards)

        body = fn.node.body if fn is not None else [
            n for n in f.tree.body
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))]
        block(body, [])

    def _note_collective(self, node: ast.Call, rel: str, op: str, raw: bool,
                         fn_key: Optional[str], fn_name: Optional[str],
                         scope: str, divergent: Optional[str]) -> None:
        def add(axis: Optional[str], kind: str) -> None:
            self.out.collectives.append(CollectiveSite(
                rel, node.lineno, op, axis, kind, fn_key, fn_name,
                divergent))

        if raw:
            add(None, "group")
            return
        if op in HIERARCHICAL_OPS:
            # one site PER HOP keyword: both hop axes must resolve to
            # declared axes; omitted keywords ride the wrapper defaults
            hops = [kw for kw in node.keywords
                    if kw.arg in HIERARCHICAL_OPS[op]]
            if not hops:
                add(None, "default")
            for kw in hops:
                axis = self._axis_of(kw.value, rel, scope)
                add(axis, "literal" if axis is not None else "dynamic")
            return
        add(*self._site_axis(node, rel, scope))

    def _collect_sites(self) -> None:
        """Walk the module level and the functions that hold a
        collective or a fold call (the rest cannot add a site)."""
        names = COLLECTIVE_OPS | DIST_COLLECTIVES | FOLD_CALLS
        for f in self.project.files:
            if f.tree is None:
                continue
            holders: Dict[str, FunctionInfo] = {}
            module = False
            for name in names:
                for call in f.calls_named(name):
                    fn = self.project.enclosing_function(f.rel, call.lineno)
                    if fn is None:
                        module = True
                    else:
                        holders[fn.qualname] = fn
            if module:
                self._walk_function(f, None)
            for fn in holders.values():
                self._walk_function(f, fn)

    # ---------------------------------------------------------------- run
    def run(self) -> RegionAnalysis:
        self._collect_tables()
        self._propagate(self._seeds())
        self._collect_sites()
        return self.out
