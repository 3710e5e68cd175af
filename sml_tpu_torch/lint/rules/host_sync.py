"""host-sync-in-hot-path: no stray device-to-host syncs on the paths the
dispatcher routes.

Each device-to-host read stalls the host until the card's queue drains
to it, and one `.item()` in a fit's level loop costs a full round trip
per level. This rule flags the sync idioms in every function reachable
from a dispatch entry point:

- entry points: functions that call `routed` / `mesh_for` / `decide`
  (`sml_tpu_torch/parallel/dispatch.py`) or `routed_for`
  (`ml/_staging.py`): the boundary where code becomes the hot path;
- reachability: the project call graph, resolved conservatively
  (`Project.resolve_callees`);
- flagged in the hot set:
    * `.item()` and `.cpu()` on anything, and `.synchronize()` (a
      stream's, an event's, `torch.cuda.synchronize()`);
    * `.numpy()` and `.tolist()` of a device tensor;
    * `float(t)` / `int(t)` / `bool(t)` of a device tensor.

"Device tensor" is a per-function local dataflow: names bound from
`.cuda()`, `.to(<device>)` (a `device=` keyword or an argument whose
name holds "dev"), a `torch.*(..., device=...)` factory, the staging
helpers (`stage_*`, `insert_bins_cached`), the kernel wrappers
(`hist_accumulate`, `split_scan`, `fit_row_weights`,
`fit_feature_masks`, `forest_traverse`) and their plain versions, and
any operation on such a name (`t.sum()`, `t[i]`, `t + 1`,
`torch.stack([t])`). `_staging.device_get` is the ONE blessed transfer
(every tensor's copy after one wait, counted as `staging.d2h_bytes`):
its results are host values and reading them is fine, and its own body
is where the sync belongs.
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..core import Violation, rule
from ..project import Project, dotted

RULE = "host-sync-in-hot-path"
ENTRY_CALLS = ("routed", "routed_for", "mesh_for", "decide")
#: the blessed batched transfer: its results are host values
BLESSED = "device_get"

#: staging helpers and kernel wrappers whose results live on the card
DEVICE_FUNCS = {"insert_bins_cached", "hist_accumulate", "split_scan",
                "fit_row_weights", "fit_feature_masks", "forest_traverse",
                "hist_accumulate_plain", "split_scan_plain",
                "fit_row_weights_plain", "fit_feature_masks_plain",
                "forest_margin_plain"}
#: methods that copy to the host (their results are host values)
HOST_METHODS = {"cpu", "numpy", "tolist", "item"}
SYNC_ANY = {"item": "`.item()` is a per-element device-to-host sync",
            "cpu": "`.cpu()` is a blocking device-to-host copy",
            "synchronize": "`.synchronize()` stalls the host on the card"}
SYNC_DEVICE = {"numpy": "`.numpy()` of a device tensor",
               "tolist": "`.tolist()` of a device tensor is a "
                         "device-to-host sync"}


def _mentions_device(e: ast.expr) -> bool:
    text = dotted(e)
    return "dev" in text.rsplit(".", 1)[-1].lower() if text else False


class _FnChecker:
    """Linear (statement-order) device-taint scan of one hot function."""

    def __init__(self, rel: str, qualname: str, origin: str):
        self.rel = rel
        self.qualname = qualname
        self.origin = origin
        self.tracked: Set[str] = set()     # device-resident names
        self.out: List[Violation] = []

    # -------------------------------------------------- device-ness of exprs
    def _is_device(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tracked
        if isinstance(e, (ast.Subscript, ast.Starred, ast.Attribute)):
            return self._is_device(e.value)
        if isinstance(e, ast.BinOp):
            return self._is_device(e.left) or self._is_device(e.right)
        if isinstance(e, ast.UnaryOp):
            return self._is_device(e.operand)
        if isinstance(e, (ast.List, ast.Tuple)):
            return any(self._is_device(x) for x in e.elts)
        if not isinstance(e, ast.Call):
            return False
        f = e.func
        if isinstance(f, ast.Name):
            return f.id.startswith("stage_") or f.id in DEVICE_FUNCS
        if not isinstance(f, ast.Attribute):
            return False
        if f.attr == BLESSED or f.attr in HOST_METHODS:
            return False
        if f.attr.startswith("stage_") or f.attr in DEVICE_FUNCS:
            return True
        if f.attr == "cuda":
            return True
        if f.attr == "to":
            if any(k.arg == "device" for k in e.keywords) \
                    or any(_mentions_device(a) for a in e.args):
                return True
            return self._is_device(f.value)
        if dotted(f).startswith("torch."):
            if any(k.arg == "device" and not (
                    isinstance(k.value, ast.Constant)
                    and k.value.value == "cpu") for k in e.keywords):
                return True
            return any(self._is_device(a) for a in e.args)
        # a method of a device tensor returns a device tensor
        return self._is_device(f.value)

    # ------------------------------------------------------------- flagging
    def _flag(self, node: ast.AST, msg: str) -> None:
        self.out.append(Violation(
            RULE, self.rel, node.lineno,
            f"{msg} inside dispatch-hot `{self.qualname}` (reachable from "
            f"entry `{self.origin}`): move it off the hot path, batch it "
            f"through _staging.device_get, or carry it with a reason"))

    def _scan_expr(self, e: ast.expr) -> None:
        for node in ast.walk(e):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr == "synchronize" or (f.attr in SYNC_ANY
                                               and not node.args):
                    self._flag(node, SYNC_ANY[f.attr])
                elif f.attr in SYNC_DEVICE and not node.args \
                        and self._is_device(f.value):
                    self._flag(node, SYNC_DEVICE[f.attr])
            elif (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
                  and node.args and self._is_device(node.args[0])):
                self._flag(node, f"`{f.id}()` of a device tensor forces a "
                                 f"scalar device-to-host sync")

    # ---------------------------------------------------------- statements
    def _bind_target(self, target: ast.expr, device: bool) -> None:
        if isinstance(target, ast.Name):
            if device:
                self.tracked.add(target.id)
            else:
                self.tracked.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_target(elt, device)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, device)

    def run(self, fn_node: ast.AST) -> List[Violation]:
        for stmt in fn_node.body:
            self._stmt(stmt)
        return self.out

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are separate call-graph nodes
        if isinstance(stmt, ast.Assign):
            self._scan_expr(stmt.value)
            device = self._is_device(stmt.value)
            for t in stmt.targets:
                self._bind_target(t, device)
            return
        if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                self._scan_expr(stmt.value)
                self._bind_target(stmt.target,
                                  self._is_device(stmt.value)
                                  or self._is_device(stmt.target))
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter)
            self._bind_target(stmt.target, self._is_device(stmt.iter))
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, (ast.While, ast.If)):
            self._scan_expr(stmt.test)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars,
                                      self._is_device(item.context_expr))
            for s in stmt.body:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Try):
            for s in (stmt.body + stmt.orelse + stmt.finalbody
                      + [h for hh in stmt.handlers for h in hh.body]):
                self._stmt(s)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._bind_target(t, False)
            return
        # Return / Expr / Assert / Raise / ...: scan every expression
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._scan_expr(node)


@rule(RULE,
      "no .item()/.cpu()/.numpy()/.tolist()/synchronize()/float() device "
      "syncs in functions reachable from dispatch entry points")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    hot = project.hot_functions(ENTRY_CALLS)
    for rel, fns in project.function_index().items():
        for fn in fns:
            origin = hot.get(f"{rel}::{fn.qualname}")
            if origin is None or fn.name == BLESSED:
                continue
            out.extend(_FnChecker(rel, fn.qualname, origin).run(fn.node))
    return out
