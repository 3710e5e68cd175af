"""Param system for the ML pipeline API (the port's copy of
`sml_tpu/ml/param.py`).

The reference's MLlib estimators are parameterized through `Param`s with
defaults, `explainParams()`, and `copy(paramMap)` used by tuning loops.
This re-implements that contract standalone: a Param is a (parent, name,
doc) descriptor; a Params object holds a default map and a user-set map;
`copy({param: value})` clones with extra overrides.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Param(Generic[T]):
    def __init__(self, parent: "Params", name: str, doc: str = ""):
        self.parent = parent.uid if isinstance(parent, Params) else parent
        self.name = name
        self.doc = doc

    def __repr__(self):
        return f"{self.parent}__{self.name}"

    def __hash__(self):
        return hash(str(self))

    def __eq__(self, other):
        return isinstance(other, Param) and self.parent == other.parent \
            and self.name == other.name


_uid_counters: Dict[str, int] = {}


def _gen_uid(cls_name: str) -> str:
    n = _uid_counters.get(cls_name, 0)
    _uid_counters[cls_name] = n + 1
    return f"{cls_name}_{n:04x}"


class Params:
    """Base for everything that carries Params (Transformer/Estimator/Model)."""

    def __init__(self):
        self.uid = _gen_uid(type(self).__name__)
        self._defaultParamMap: Dict[Param, Any] = {}
        self._paramMap: Dict[Param, Any] = {}
        self._shadowed_params: Dict[str, Param] = {}

    # -- declaration ------------------------------------------------------
    def _declareParam(self, name: str, default: Any = None, doc: str = "") -> Param:
        p = Param(self, name, doc)
        try:
            setattr(self, name, p)
        except AttributeError:
            # name shadowed by a class property (e.g. ALSModel.rank);
            # the param stays reachable via getParam/_shadowed
            self._shadowed_params[name] = p
        self._defaultParamMap[p] = default
        return p

    # -- access -----------------------------------------------------------
    @property
    def params(self) -> List[Param]:
        found = [v for v in self.__dict__.values() if isinstance(v, Param)]
        found += list(self._shadowed_params.values())
        return sorted(found, key=lambda p: p.name)

    def getParam(self, name: str) -> Param:
        if name in self._shadowed_params:
            return self._shadowed_params[name]
        p = getattr(self, name, None)
        if not isinstance(p, Param):
            raise AttributeError(f"{type(self).__name__} has no param {name!r}")
        return p

    def isDefined(self, param) -> bool:
        param = self._resolve(param)
        return param in self._paramMap or self._defaultParamMap.get(param) is not None

    def isSet(self, param) -> bool:
        return self._resolve(param) in self._paramMap

    def hasParam(self, name: str) -> bool:
        return name in self._shadowed_params or \
            isinstance(getattr(self, name, None), Param)

    def getOrDefault(self, param) -> Any:
        param = self._resolve(param)
        if param in self._paramMap:
            return self._paramMap[param]
        return self._defaultParamMap.get(param)

    def __getattr__(self, name: str):
        """MLlib auto-generates `get<Param>()`/`set<Param>(v)` for every
        declared param; synthesize the same accessors for any param that
        has no explicit method (explicit defs win — this only runs when
        normal lookup fails)."""
        if name.startswith(("get", "set")) and len(name) > 3 and \
                not name.startswith("__"):
            pname = name[3].lower() + name[4:]
            # hasParam uses getattr(self, pname) which re-enters here for
            # unknown names and correctly raises below — no recursion
            if self.hasParam(pname):
                if name.startswith("get"):
                    return lambda: self.getOrDefault(pname)

                def setter(value, _pname=pname):
                    # same _set semantics as every explicit setter in the
                    # codebase (None means "leave unset") — one setter
                    # contract everywhere beats a PySpark corner case that
                    # no course code exercises
                    self._set(**{_pname: value})
                    return self

                return setter
        # NOTE: a property whose body raises AttributeError lands here and
        # gets re-reported as a missing attribute (Python swallows the
        # original before calling __getattr__) — properties on Params
        # subclasses should raise RuntimeError for internal errors
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def get(self, param) -> Any:
        return self.getOrDefault(param)

    def _resolve(self, param) -> Param:
        return self.getParam(param) if isinstance(param, str) else param

    def set(self, param, value) -> "Params":  # noqa: A003
        self._paramMap[self._resolve(param)] = value
        return self

    def _set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            if v is not None:
                self._paramMap[self.getParam(k)] = v
        # monotonically counts param mutations: compiled-plan caches (the
        # fused pipeline transform) fold this into their tokens so a
        # post-fit setter call invalidates them
        self._param_version = getattr(self, "_param_version", 0) + 1
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self._defaultParamMap[self.getParam(k)] = v
        return self

    def extractParamMap(self, extra: Optional[Dict[Param, Any]] = None) -> Dict[Param, Any]:
        m = dict(self._defaultParamMap)
        m.update(self._paramMap)
        if extra:
            m.update(extra)
        return m

    def explainParam(self, param) -> str:
        param = self._resolve(param)
        default = self._defaultParamMap.get(param)
        cur = self._paramMap.get(param, "undefined")
        if param in self._paramMap:
            state = f"current: {cur}"
        else:
            state = "undefined"
        return f"{param.name}: {param.doc} (default: {default}, {state})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    def copy(self, extra: Optional[Dict[Param, Any]] = None) -> "Params":
        """Clone; tuning loops rely on `est.copy(paramMap)` (`ML 08:97`)."""
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        # rebind Param descriptors to this instance's uid (shared uid semantics
        # — MLlib keeps the same uid on copy, which tuning depends on)
        if extra:
            for p, v in extra.items():
                if isinstance(p, Param):
                    # params addressed to another object (e.g. a pipeline
                    # stage) are skipped here; composite estimators like
                    # Pipeline route them to their children in their copy()
                    if p.parent == that.uid and that.hasParam(p.name):
                        that._paramMap[that.getParam(p.name)] = v
                else:
                    that._paramMap[that.getParam(p)] = v
        return that

    # -- (de)serialization of param values -------------------------------
    def _params_to_dict(self) -> Dict[str, Any]:
        out = {}
        for p, v in self.extractParamMap().items():
            if _is_jsonable(v):
                out[p.name] = v
        return out

    def _params_from_dict(self, d: Dict[str, Any]) -> None:
        for name, v in d.items():
            if self.hasParam(name):
                self._paramMap[self.getParam(name)] = v


def _is_jsonable(v) -> bool:
    import json
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False
