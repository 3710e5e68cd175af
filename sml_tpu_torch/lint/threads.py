"""Thread-role inference and per-class shared-state modelling: the
dataflow core under the concurrency rules (`race-unguarded-shared-write`,
`race-check-then-use`, `lock-order`).

The port's threaded surfaces (the serving batcher's flush worker, the
endpoint's shadow pool, the streaming trigger loop, the continuous
trainer, the fleet's autoscaler, the load driver's pool, the stall
watchdog, prewarm's replay pools, the chunked pipeline's prefetch pool,
the kernels' parallel builds and the placed trials' pool) share state
through instance attributes. A racing write and the read it tears
live in different methods, connected only by which THREAD runs each,
so no per-line pattern can see them. This module rebuilds that
connection statically, as the JAX package's lint does:

1. **Thread-role map** (`thread_roles`): entry points are callables
   handed to `threading.Thread(target=...)`, `threading.Timer(..., fn)`,
   an executor's `.submit(fn, ...)` or `.map(fn, ...)` (an executor
   being a name bound from `ThreadPoolExecutor(...)`), callback and
   listener registrations (callee names like `on_*` / `add_*` /
   `register*` / `*_listener` / `*hook*` / `*callback*`), and bound
   methods that ESCAPE into another object (a bare `self._method` in
   non-call position). Each entry seeds a role (`thread:...`,
   `timer:...`, `callback:...`, `escape:...`) that propagates over the
   project's conservative call graph; a function with no role runs only
   on caller ("main") threads. A callable that is a parameter of the
   function handing it over (`pool.map(fn, jobs)` in
   `device.run_placed_trials`) records its entry at that site and is
   bound through the callers: each call site's argument in that
   position seeds the role.

2. **Shared-state model** (`class_records`): per class, every
   `self.<attr>` access (rebind writes, container MUTATIONS such as
   `self.x.append(...)` / `self.x[k] = v`, and reads) with the locks
   held at the access site (`with self._lock:` blocks over attributes
   assigned from `threading.Lock/RLock/Condition/Semaphore`, plus
   module-level locks), and whether a read sits in a `while` test (a
   wait on the attribute). `__init__` is construction time and exempt.
   An attribute is *multi-role* when two accesses carry different role
   sets: the precondition of every race rule.

3. **Lock-acquisition orders** (`acquisitions`): every `with <lock>:`
   entered while another known lock is held, project-wide; the
   `lock-order` rule flags pairs acquired in both nesting orders.

Deliberate limits, as in the JAX package's model (kept so the pass stays
fast and quiet): state shared through module-level globals is not
modelled (module-level locks ARE tracked for lock order); one role is
one *logical* thread, so a pool running the same entry concurrently
with itself is invisible; two instances of one class locking against
each other (`self._lock` vs `other._lock`) collapse to one static lock
identity; and a callable handed over as a parameter is bound one call
level up (three at most). Everything here is stdlib `ast` only.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .project import FunctionInfo, Project, call_target_name

#: factory callables whose result is a with-able mutual-exclusion lock
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}

#: synchronization primitives that mark a class as PARTICIPATING in the
#: threading model even though they are not with-able locks
SYNC_FACTORIES = LOCK_FACTORIES | {"Event", "Barrier"}

#: method names that mutate a container in place: `self.x.append(...)`
#: counts as a WRITE to the shared attribute, not a read
MUTATORS = {"append", "appendleft", "extend", "insert", "add", "update",
            "setdefault", "pop", "popleft", "popitem", "remove",
            "discard", "clear", "sort", "reverse"}

#: callee-name shapes that register a callback fired from a foreign
#: thread later (store listeners, watchdog hooks, conf on_set)
_CALLBACK_PREFIXES = ("on_", "add_", "register")
_CALLBACK_SUBSTR = ("listener", "callback", "hook")


def _is_callback_registration(name: Optional[str]) -> bool:
    if not name:
        return False
    low = name.lower()
    return low.startswith(_CALLBACK_PREFIXES) \
        or any(s in low for s in _CALLBACK_SUBSTR)


class Access:
    """One `self.<attr>` touch inside a method."""

    __slots__ = ("attr", "rel", "cls", "method", "lineno", "kind",
                 "locks", "in_init", "in_wait")

    def __init__(self, attr: str, rel: str, cls: str, method: str,
                 lineno: int, kind: str, locks: FrozenSet[str],
                 in_init: bool, in_wait: bool = False):
        self.attr = attr
        self.rel = rel
        self.cls = cls
        self.method = method      # method simple name
        self.lineno = lineno
        self.kind = kind          # "read" | "write" | "mutate"
        self.locks = locks        # canonical lock ids held at the site
        self.in_init = in_init
        self.in_wait = in_wait    # a read in a `while` test: a wait on it

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<{self.kind} self.{self.attr} @ {self.rel}:{self.lineno}"
                f" in {self.cls}.{self.method} locks={sorted(self.locks)}>")


class ClassRecord:
    """Shared-state model of one class: its locks and every attribute
    access, ready for role-aware classification."""

    def __init__(self, rel: str, name: str, lineno: int):
        self.rel = rel
        self.name = name
        self.lineno = lineno
        self.locks: Set[str] = set()          # self-attr lock names
        self.owns_sync = False                # any sync primitive attr
        self.accesses: List[Access] = []
        self.methods: List[str] = []
        #: (caller method, callee method, locks held at the call site)
        self.calls: List[Tuple[str, str, FrozenSet[str]]] = []
        self._eff: Optional[Dict[str, FrozenSet[str]]] = None

    def attr_accesses(self) -> Dict[str, List[Access]]:
        out: Dict[str, List[Access]] = {}
        for a in self.accesses:
            out.setdefault(a.attr, []).append(a)
        return out

    def effective_locks(self, a: Access,
                        entry_methods: Set[str]) -> FrozenSet[str]:
        """Locks held at the access site, INCLUDING locks every
        intra-class caller of the enclosing private helper holds — the
        `_ensure_sink`-under-`emit`'s-lock convention. Public methods
        and thread-entry methods never inherit caller locks."""
        return a.locks | self._helper_locks(entry_methods).get(
            a.method, frozenset())

    def _helper_locks(self, entry_methods: Set[str]
                      ) -> Dict[str, FrozenSet[str]]:
        if self._eff is not None:
            return self._eff
        sites: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
        for caller, callee, held in self.calls:
            if callee in self.methods:
                sites.setdefault(callee, []).append((caller, held))
        eligible = {m for m in sites
                    if m.startswith("_") and not m.startswith("__")
                    and m not in entry_methods}
        universe = frozenset(
            lock for _, _, held in self.calls for lock in held)
        for a in self.accesses:
            universe |= a.locks
        eff: Dict[str, FrozenSet[str]] = {m: universe for m in eligible}
        changed = True
        while changed:
            changed = False
            for m in eligible:
                new = None
                for caller, held in sites[m]:
                    have = held | eff.get(caller, frozenset())
                    new = have if new is None else (new & have)
                new = new or frozenset()
                if new != eff[m]:
                    eff[m] = new
                    changed = True
        self._eff = eff
        return eff


class ThreadAnalysis:
    def __init__(self) -> None:
        #: "rel::qualname" -> set of role labels (empty/absent = main-only)
        self.roles: Dict[str, Set[str]] = {}
        #: (role_label, rel, entry qualname)
        self.entries: List[Tuple[str, str, str]] = []
        self.classes: List[ClassRecord] = []
        #: rel -> module-level lock names
        self.module_locks: Dict[str, Set[str]] = {}
        #: (outer lock id, inner lock id, rel, lineno) nesting events
        self.acquisitions: List[Tuple[str, str, str, int]] = []

    def rolesets(self, rel: str, cls: str) -> Dict[str, FrozenSet[str]]:
        """method simple name -> its role set, for one class."""
        out: Dict[str, FrozenSet[str]] = {}
        prefix = f"{rel}::"
        for key, roles in self.roles.items():
            if not key.startswith(prefix):
                continue
            qual = key[len(prefix):]
            if qual.startswith(cls + "."):
                m = qual[len(cls) + 1:]
                if "." not in m:     # direct methods only
                    out[m] = frozenset(roles)
        return out


def analyze(project: Project) -> ThreadAnalysis:
    """Memoized on the project (all three rules share one pass)."""
    cached = getattr(project, "_thread_analysis", None)
    if cached is not None:
        return cached
    out = _analyze(project)
    project._thread_analysis = out
    return out


# --------------------------------------------------------------- role map
#: executor classes whose instances run `.submit` / `.map` callables on
#: pool threads
EXECUTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}


class _FileResolver:
    """Resolves a callable expression of one file to a function of that
    file: a named def, or `self.<m>` / `cls.<m>` to a method of the
    enclosing class."""

    def __init__(self, f, fns: List[FunctionInfo]):
        self.rel = f.rel
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        for fn in fns:
            self.by_name.setdefault(fn.name, []).append(fn)
        #: class -> method simple names (to resolve self.<m> references)
        self.class_methods: Dict[str, Set[str]] = {}
        #: subset that may ESCAPE as bound callables: a bare `self.prop`
        #: load on a @property is attribute access, not a callable
        #: hand-off, and dunders are invoked by syntax; both excluded
        self.escapable: Dict[str, Set[str]] = {}
        for fn in fns:
            if "." in fn.qualname:
                cls, meth = fn.qualname.rsplit(".", 1)
                cls = cls.rsplit(".", 1)[-1]
                self.class_methods.setdefault(cls, set()).add(meth)
                decos = {d.attr if isinstance(d, ast.Attribute)
                         else getattr(d, "id", None)
                         for d in getattr(fn.node, "decorator_list", [])}
                if meth.startswith("__") or decos & {"property",
                                                     "cached_property"} \
                        or "setter" in decos:
                    continue
                self.escapable.setdefault(cls, set()).add(meth)
        # line -> the innermost class around it (to resolve `self.<m>`);
        # ast.walk meets an outer class before the classes inside it
        self._class_at: Dict[int, str] = {}
        for node in f.nodes:
            if isinstance(node, ast.ClassDef):
                for ln in range(node.lineno, node.end_lineno + 1):
                    self._class_at[ln] = node.name

    def class_at(self, node: ast.AST) -> str:
        """The class whose body holds `node` ("" at module level)."""
        return self._class_at.get(getattr(node, "lineno", 0), "")

    def resolve(self, expr, near: ast.AST) -> Optional[str]:
        """entry expr -> qualname of a function in THIS file, or None."""
        if isinstance(expr, ast.Name):
            cands = self.by_name.get(expr.id, [])
            if cands:
                return cands[0].qualname
            return None
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "cls"):
            cls = self.class_at(near)
            if cls and expr.attr in self.class_methods.get(cls, ()):
                return f"{cls}.{expr.attr}"
        return None


def _executor_names(f) -> Set[str]:
    """Names (and `self.<attr>` attributes) bound from an executor
    constructor anywhere in the file."""
    out: Set[str] = set()

    def bind(target) -> None:
        if isinstance(target, ast.Name):
            out.add(target.id)
        elif isinstance(target, ast.Attribute):
            out.add(target.attr)

    for node in f.nodes:
        if isinstance(node, ast.withitem) \
                and isinstance(node.context_expr, ast.Call) \
                and call_target_name(node.context_expr.func) in EXECUTORS \
                and node.optional_vars is not None:
            bind(node.optional_vars)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, ast.Call) \
                and call_target_name(node.value.func) in EXECUTORS:
            bind(node.targets[0])
    return out


def _receiver(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _entry_targets(project: Project, f, res: _FileResolver
                   ) -> Tuple[List[Tuple[str, str]],
                              List[Tuple[str, FunctionInfo, str]]]:
    """([(role label, entry qualname)], [(role label, enclosing
    function, parameter name)]) discovered in one file: the second list
    holds the callables handed over as a parameter of the enclosing
    function."""
    if f.tree is None:
        return [], []
    found: Dict[str, str] = {}   # qualname -> role label (first wins)
    params: List[Tuple[str, FunctionInfo, str]] = []
    executors = _executor_names(f)

    fns = {fn.qualname: fn for fn in project.function_index().get(f.rel,
                                                                   [])}

    def note(kind: str, expr, near: ast.AST, bind: bool = False) -> None:
        """Record `expr` as an entry; with `bind`, a parameter of an
        enclosing function (the innermost that has it) is recorded for
        binding through its callers."""
        qual = res.resolve(expr, near)
        if qual is not None:
            if qual not in found:
                found[qual] = f"{kind}:{f.rel}::{qual}"
            return
        if not (bind and isinstance(expr, ast.Name)):
            return
        encl = project.enclosing_function(f.rel, near.lineno)
        while encl is not None and expr.id not in encl.params():
            encl = fns.get(encl.qualname.rsplit(".", 1)[0]) \
                if "." in encl.qualname else None
        label = None if encl is None else \
            f"{kind}:{f.rel}::{encl.qualname}.<{expr.id}>"
        if label is not None and all(p[0] != label for p in params):
            params.append((label, encl, expr.id))

    for node in f.nodes:
        if isinstance(node, ast.Call):
            name = call_target_name(node.func)
            if name == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        note("thread", kw.value, node, bind=True)
            elif name == "Timer":
                if len(node.args) >= 2:
                    note("timer", node.args[1], node, bind=True)
                for kw in node.keywords:
                    if kw.arg == "function":
                        note("timer", kw.value, node, bind=True)
            elif name == "submit" and isinstance(node.func, ast.Attribute) \
                    and node.args:
                note("thread", node.args[0], node,
                     bind=_receiver(node.func.value) in executors)
            elif name == "map" and isinstance(node.func, ast.Attribute) \
                    and _receiver(node.func.value) in executors \
                    and node.args:
                note("thread", node.args[0], node, bind=True)
            elif _is_callback_registration(name):
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    note("callback", arg, node)

    # bound-method escapes: `self._m` referenced OUTSIDE call-func
    # position (stored, passed to a constructor, registered through an
    # alias): the method may run on whatever thread the receiving
    # object calls back from
    call_funcs = {id(n.func) for n in f.nodes
                  if isinstance(n, ast.Call)}
    for node in f.nodes:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and id(node) not in call_funcs \
                and isinstance(node.value, ast.Name) \
                and node.value.id in ("self", "cls"):
            cls = res.class_at(node)
            if cls and node.attr in res.escapable.get(cls, ()):
                qual = f"{cls}.{node.attr}"
                if qual not in found:
                    found[qual] = f"escape:{f.rel}::{qual}"

    return [(role, qual) for qual, role in found.items()], params


def _stem(rel: str) -> str:
    """The module name a file is imported as: "pkg/mod.py" -> "mod",
    "pkg/__init__.py" -> "pkg"."""
    parts = rel[:-3].split("/")
    return parts[-2] if parts[-1] == "__init__" and len(parts) > 1 \
        else parts[-1]


def _imports(f) -> Tuple[Dict[str, str], Dict[str, Tuple[str, str]]]:
    """({module alias -> module name}, {imported name alias -> (module
    name, name)}) of a file's import statements, module names by their
    last component."""
    cached = getattr(f, "_imports", None)
    if cached is not None:
        return cached
    mods: Dict[str, str] = {}
    names: Dict[str, Tuple[str, str]] = {}
    for node in f.nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                mods[a.asname or a.name.split(".")[0]] = \
                    a.name.rsplit(".", 1)[-1]
        elif isinstance(node, ast.ImportFrom):
            base = (node.module or "").rsplit(".", 1)[-1]
            for a in node.names:
                # `from pkg import mod` binds a module, `from mod import
                # f` a name: record both readings
                mods[a.asname or a.name] = a.name
                names[a.asname or a.name] = (base, a.name)
    f._imports = (mods, names)
    return mods, names


def _calls_of(project: Project, f, fn: FunctionInfo) -> List[ast.Call]:
    """The calls in file `f` that resolve to `fn`: a bare name in its
    own module or imported from it, `<module alias>.name(...)` of its
    module, or any spelling of a name no other function bears."""
    unique = len(project.functions_by_name().get(fn.name, [])) == 1
    stem = _stem(fn.rel)
    mods, names = _imports(f)
    out: List[ast.Call] = []
    for node in f.calls_named(fn.name):
        func = node.func
        if isinstance(func, ast.Name):
            hit = f.rel == fn.rel or names.get(func.id) == (stem, fn.name)
        elif isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name):
            hit = mods.get(func.value.id) == stem
        else:
            hit = False
        if hit or unique:
            out.append(node)
    return out


def _bound_arguments(project: Project, fn: FunctionInfo, param: str,
                     resolvers: Dict[str, "_FileResolver"]
                     ) -> List[Tuple[FunctionInfo, Optional[str]]]:
    """Where `fn` is called (`_calls_of`), what each call passes for
    `param`: [(the function passed, None)] when it resolves in the
    caller's file, or [(the caller, its own parameter)] when the caller
    hands on a parameter of its own, so the binding can climb a level."""
    names = fn.params()
    is_method = "." in fn.qualname and names[:1] in (["self"], ["cls"])
    pos = names.index(param) - (1 if is_method else 0)
    out: List[Tuple[FunctionInfo, Optional[str]]] = []
    for f in project.files:
        if f.tree is None:
            continue
        res = resolvers[f.rel]
        for node in _calls_of(project, f, fn):
            arg = None
            for kw in node.keywords:
                if kw.arg == param:
                    arg = kw.value
            if arg is None and 0 <= pos < len(node.args) \
                    and not any(isinstance(a, ast.Starred)
                                for a in node.args[:pos + 1]):
                arg = node.args[pos]
            if arg is None:
                continue
            qual = res.resolve(arg, node)
            if qual is not None:
                for cand in project.function_index().get(f.rel, []):
                    if cand.qualname == qual:
                        out.append((cand, None))
                        break
            elif isinstance(arg, ast.Name):
                caller = project.enclosing_function(f.rel, node.lineno)
                if caller is not None and arg.id in caller.params():
                    out.append((caller, arg.id))
    return out


def thread_roles(project: Project) -> Dict[str, Set[str]]:
    """"rel::qualname" -> role labels, propagated over the call graph."""
    return analyze(project).roles


def _role_callees(project: Project, fn: FunctionInfo,
                  by_name: Dict[str, List[FunctionInfo]]
                  ) -> List[FunctionInfo]:
    """Form-aware call-graph edges for role propagation, stricter than
    `Project.resolve_callees`: `self.m()` binds only to a method of the
    SAME class, `obj.m()` only when exactly one function project-wide
    bears the name, and a bare `f()` prefers same-module definitions.
    The looser resolver would bind `_WATCHDOG.close(ticket)` to a
    same-module `close` method and smear thread roles over unrelated
    lifecycle code."""
    index = project.function_index()
    local = {f.name: f for f in index.get(fn.rel, [])}
    own_cls = fn.qualname.rsplit(".", 1)[0] if "." in fn.qualname else None
    out: List[FunctionInfo] = []
    forms = fn.call_forms or [("name", n) for n in fn.calls]
    for form, name in forms:
        if form == "self":
            if own_cls is not None:
                for cand in index.get(fn.rel, []):
                    if cand.qualname == f"{own_cls}.{name}":
                        out.append(cand)
                        break
            continue
        if form == "name":
            if name in local:
                out.append(local[name])
                continue
        cands = by_name.get(name, [])
        if len(cands) == 1:
            out.append(cands[0])
    return out


def _propagate_roles(project: Project, out: ThreadAnalysis) -> None:
    index = project.function_index()
    by_name = project.functions_by_name()
    resolvers = {f.rel: _FileResolver(f, index.get(f.rel, []))
                 for f in project.files}
    seeds: List[Tuple[FunctionInfo, str]] = []
    for f in project.files:
        found, params = _entry_targets(project, f, resolvers[f.rel])
        for role, qual in found:
            for fn in index.get(f.rel, []):
                if fn.qualname == qual:
                    seeds.append((fn, role))
                    out.entries.append((role, f.rel, qual))
                    break
        for role, encl, param in params:
            out.entries.append((role, f.rel,
                                f"{encl.qualname}.<{param}>"))
            todo = [(encl, param, 0)]
            while todo:
                fn, p, depth = todo.pop()
                for target, up in _bound_arguments(project, fn, p,
                                                   resolvers):
                    if up is not None:
                        if depth < 2:
                            todo.append((target, up, depth + 1))
                        continue
                    seeds.append((target, role))
                    out.entries.append((role, target.rel, target.qualname))
    work = list(seeds)
    while work:
        fn, role = work.pop()
        key = f"{fn.rel}::{fn.qualname}"
        roles = out.roles.setdefault(key, set())
        if role in roles:
            continue
        roles.add(role)
        for callee in _role_callees(project, fn, by_name):
            work.append((callee, role))


# -------------------------------------------------- locks + access walking
def _module_locks(f) -> Set[str]:
    out: Set[str] = set()
    if f.tree is None:
        return out
    for node in f.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call) \
                and call_target_name(node.value.func) in LOCK_FACTORIES:
            out.add(node.targets[0].id)
    return out


def _class_lock_attrs(cls_node: ast.ClassDef) -> Tuple[Set[str], bool]:
    """(with-able lock attr names, owns-any-sync-primitive)."""
    out: Set[str] = set()
    owns_sync = False
    for node in ast.walk(cls_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self" \
                    and isinstance(node.value, ast.Call):
                name = call_target_name(node.value.func)
                if name in LOCK_FACTORIES:
                    out.add(t.attr)
                if name in SYNC_FACTORIES:
                    owns_sync = True
    return out, owns_sync


class _LockWalker:
    """Walk one function body tracking which canonical lock ids the
    `with` nesting holds, recording self-attribute accesses (methods)
    and lock-acquisition order events (all functions)."""

    def __init__(self, rel: str, cls: Optional[ClassRecord],
                 method: str, in_init: bool, module_locks: Set[str],
                 sink: ThreadAnalysis):
        self.rel = rel
        self.cls = cls
        self.method = method
        self.in_init = in_init
        self.module_locks = module_locks
        self.sink = sink
        self.held: List[str] = []
        self.waiting = 0          # depth of `while` tests being walked

    # lock-id resolution --------------------------------------------------
    def _lock_id(self, expr) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name):
            if self.cls is not None and expr.attr in self.cls.locks:
                # self._lock / other._lock: one static identity per
                # (class, attr) — instance-crossing orders collapse
                return f"{self.rel}::{self.cls.name}.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return f"{self.rel}::{expr.id}"
        return None

    # access recording ----------------------------------------------------
    def _note(self, attr: str, lineno: int, kind: str) -> None:
        if self.cls is None:
            return
        self.cls.accesses.append(Access(
            attr, self.rel, self.cls.name, self.method, lineno, kind,
            frozenset(self.held), self.in_init, self.waiting > 0))

    def _is_self_attr(self, node) -> bool:
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self")

    def walk(self, node) -> None:
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _visit(self, node) -> None:
        if isinstance(node, ast.While):
            self.waiting += 1
            self._visit(node.test)
            self.waiting -= 1
            for child in node.body + node.orelse:
                self._visit(child)
            return
        if isinstance(node, ast.With):
            acquired: List[str] = []
            for item in node.items:
                lid = self._lock_id(item.context_expr)
                if lid is not None:
                    for outer in self.held:
                        if outer != lid:
                            self.sink.acquisitions.append(
                                (outer, lid, self.rel, node.lineno))
                    self.held.append(lid)
                    acquired.append(lid)
                self._visit(item.context_expr)
                if item.optional_vars is not None:
                    self._visit(item.optional_vars)
            for child in node.body:
                self._visit(child)
            for _ in acquired:
                self.held.pop()
            return
        if isinstance(node, ast.Assign):
            self._visit(node.value)
            for t in node.targets:
                self._visit_target(t)
            return
        if isinstance(node, ast.AugAssign):
            self._visit(node.value)
            if self._is_self_attr(node.target):
                # x += 1 is a read-modify-write
                self._note(node.target.attr, node.lineno, "read")
                self._note(node.target.attr, node.lineno, "write")
            else:
                self._visit_target(node.target)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._visit(node.value)
            self._visit_target(node.target)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if self._is_self_attr(t):
                    self._note(t.attr, node.lineno, "write")
                else:
                    self._visit(t)
            return
        if isinstance(node, ast.Call):
            # self.x.append(...) — container mutation of self.x
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in MUTATORS \
                    and self._is_self_attr(fn.value):
                self._note(fn.value.attr, node.lineno, "mutate")
            else:
                if self.cls is not None and self._is_self_attr(fn):
                    # intra-class call: feeds the helper-under-lock
                    # fixpoint (effective_locks)
                    self.cls.calls.append(
                        (self.method, fn.attr, frozenset(self.held)))
                self._visit(fn)
            for a in node.args:
                self._visit(a)
            for k in node.keywords:
                self._visit(k.value)
            return
        if isinstance(node, ast.Subscript):
            # self.x[k] = v / del self.x[k] mutate the container
            if self._is_self_attr(node.value) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)):
                self._note(node.value.attr, node.lineno, "mutate")
                self._visit(node.slice)
                return
            self._visit(node.value)
            self._visit(node.slice)
            return
        if self._is_self_attr(node):
            if isinstance(node.ctx, ast.Load):
                self._note(node.attr, node.lineno, "read")
            else:
                self._note(node.attr, node.lineno, "write")
            return
        self.walk(node)

    def _visit_target(self, t) -> None:
        if self._is_self_attr(t):
            self._note(t.attr, t.lineno, "write")
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._visit_target(e)
        else:
            self._visit(t)


def _analyze(project: Project) -> ThreadAnalysis:
    out = ThreadAnalysis()
    _propagate_roles(project, out)
    for f in project.files:
        if f.tree is None:
            continue
        mlocks = _module_locks(f)
        out.module_locks[f.rel] = mlocks
        # module-level functions: lock-order events only
        for node in f.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _LockWalker(f.rel, None, node.name, False, mlocks,
                            out).walk(node)
            elif isinstance(node, ast.ClassDef):
                rec = ClassRecord(f.rel, node.name, node.lineno)
                rec.locks, rec.owns_sync = _class_lock_attrs(node)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        rec.methods.append(item.name)
                        _LockWalker(
                            f.rel, rec, item.name,
                            item.name in ("__init__", "__new__"),
                            mlocks, out).walk(item)
                out.classes.append(rec)
    return out


# -------------------------------------------------- shared-attr judgments
def roleset_of(analysis: ThreadAnalysis, rec: ClassRecord,
               method: str) -> FrozenSet[str]:
    return analysis.rolesets(rec.rel, rec.name).get(method, frozenset())


def entry_methods(analysis: ThreadAnalysis, rec: ClassRecord) -> Set[str]:
    """Methods of this class that ARE thread/callback/escape entries."""
    out: Set[str] = set()
    for _role, rel, qual in analysis.entries:
        if rel == rec.rel and qual.startswith(rec.name + "."):
            m = qual[len(rec.name) + 1:]
            if "." not in m:
                out.add(m)
    return out


def participates(analysis: ThreadAnalysis, rec: ClassRecord) -> bool:
    """A class PARTICIPATES in the threading model when it owns
    synchronization state (a lock/Event attribute) or one of its own
    methods is a thread/timer/callback/escape entry. Value and builder
    classes merely *reachable* from someone else's thread (a DataFrame
    materialized inside a streaming trigger) are instance-confined by
    convention and generate no shared-state findings — flagging every
    such class would drown the real races in noise."""
    return bool(rec.locks) or rec.owns_sync \
        or bool(entry_methods(analysis, rec))


def multi_role(analysis: ThreadAnalysis, rec: ClassRecord,
               accesses: List[Access]) -> bool:
    """True when two accesses run under different role sets with at
    least one non-main role in play — the precondition for a race."""
    sets = {roleset_of(analysis, rec, a.method) for a in accesses}
    return len(sets) >= 2 and any(sets)


def common_locks(accesses: List[Access]) -> FrozenSet[str]:
    """Locks held at EVERY one of the given access sites."""
    if not accesses:
        return frozenset()
    locks = set(accesses[0].locks)
    for a in accesses[1:]:
        locks &= a.locks
    return frozenset(locks)


def short_role(role_or_set) -> str:
    """Violation-message form of a role label (or a role set):
    "thread:serving/_batcher.py::MicroBatcher._loop" -> "thread:_loop";
    an empty role set is the caller thread, "main". The label format is
    defined here — rules must not re-derive it."""
    if isinstance(role_or_set, (set, frozenset)):
        if not role_or_set:
            return "main"
        role_or_set = sorted(role_or_set)[0]
    role = role_or_set
    if "::" in role:
        kind = role.split(":", 1)[0]
        qual = role.split("::", 1)[-1]
        return f"{kind}:{qual.rsplit('.', 1)[-1]}"
    return role


def short_lock(lock_id: str) -> str:
    """"rel::Class.attr" -> "Class.attr" ; "rel::_name" -> "_name"."""
    return lock_id.split("::", 1)[-1]
