"""What decides `correct`: the answers of the window against the
reference.

A configuration names its `kind`; `portbench/reference/<kind>.py` holds
the plain reference of that kind, whose `Judge(cfg, host, device,
settings)` reads one answer of the program (`numbers(answer, seed)`,
each number by name) and `digest(answer)` keys bit-identical answers,
which share one verdict. Each number is held to the limit of the cell's
file `checks/<cell>.json` (set from the readings recorded beside it);
the file's other keys are the judge's settings.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(cell: str) -> dict:
    with open(os.path.join(HERE, "checks", f"{cell}.json")) as f:
        return json.load(f)


def reference(kind: str):
    """The plain reference module of a configuration's kind."""
    return importlib.import_module(f"portbench.reference.{kind}")


def verdict(numbers: Dict[str, float], lim: Dict[str, float]):
    """(correct, the compared numbers each with its limit)."""
    shown = {k: {"value": float(v), "limit": float(lim[k])}
             for k, v in numbers.items()}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, float("-inf")), float(v))
    return out
