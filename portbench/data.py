"""A configuration's dataset, made from the seed on one device.

The configuration's `data` block is all there is to a dataset: the row
count and the training split, a table of named distributions (`dists`),
the columns in their published order, each naming its distribution, and
the label. Every distribution draws all of its columns in one call of a
`torch.Generator` on the device, in float32, so the same seed gives the
same rows on the same kind of device.

Distributions (`kind`):

- `normal` (mean, std), `lognormal` (mu, sigma), `uniform` (low, high),
- `choice` (values, probs): one of a few values,
- `heavy` (mean, std, tail): a normal scaled by exp(tail * another
  normal), a heavy-tailed scale mixture.

`corr` (0 to 1, for the normal-based kinds) mixes a factor shared by the
distribution's columns into each of them.

Labels (`label.kind`), each a score of the standardized columns (`terms`:
`linear`, `square`, `abs`, `sin` of one column, `prod` of two) plus
noise:

- `binary_share`: 1 where the score lies above its quantile at 1 - share.
- `skewed_year`: a whole year in [lo, hi], `hi - exp(log(median_age) +
  score + noise)`: most years lie near `hi`, with a long tail back.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def column_dists(data: dict) -> List[str]:
    """The distribution name of every column, in column order (an entry
    `[name, dist, count]` stands for `count` columns)."""
    out: List[str] = []
    for entry in data["columns"]:
        out.extend([entry[1]] * (int(entry[2]) if len(entry) > 2 else 1))
    return out


def _normals(g: torch.Generator, rows: int, cols: int, corr: float,
             device) -> torch.Tensor:
    z = torch.randn((rows, cols), generator=g, device=device)
    if corr > 0:
        common = torch.randn((rows, 1), generator=g, device=device)
        z = math.sqrt(1.0 - corr) * z + math.sqrt(corr) * common
    return z


def _draw(spec: dict, g: torch.Generator, rows: int, cols: int,
          device) -> torch.Tensor:
    kind = spec["kind"]
    corr = float(spec.get("corr", 0.0))
    if kind == "normal":
        return spec["mean"] + spec["std"] * _normals(g, rows, cols, corr,
                                                     device)
    if kind == "lognormal":
        return torch.exp(spec["mu"] + spec["sigma"]
                         * _normals(g, rows, cols, corr, device))
    if kind == "heavy":
        z = _normals(g, rows, cols, corr, device)
        scale = torch.exp(spec["tail"] * torch.randn(
            (rows, cols), generator=g, device=device))
        return spec["mean"] + spec["std"] * z * scale
    if kind == "uniform":
        u = torch.rand((rows, cols), generator=g, device=device)
        return spec["low"] + (spec["high"] - spec["low"]) * u
    if kind == "choice":
        u = torch.rand((rows, cols), generator=g, device=device)
        cum = torch.tensor(spec["probs"], dtype=torch.float64).cumsum(0)
        edges = (cum[:-1] / cum[-1]).to(torch.float32).to(device)
        idx = torch.bucketize(u, edges, right=True)
        values = torch.tensor(spec["values"], dtype=torch.float32,
                              device=device)
        return values[idx]
    raise ValueError(f"unknown distribution kind {kind!r}")


def _term(op: str, z: torch.Tensor, cols: List[int]) -> torch.Tensor:
    a = z[:, cols[0]]
    if op == "linear":
        return a
    if op == "square":
        return a * a
    if op == "abs":
        return a.abs()
    if op == "sin":
        return torch.sin(2.0 * a)
    if op == "prod":
        return a * z[:, cols[1]]
    raise ValueError(f"unknown label term {op!r}")


def _noise(spec: dict, g: torch.Generator, rows: int, device):
    if spec["kind"] == "logistic":
        u = torch.rand(rows, generator=g, device=device, dtype=torch.float64)
        u = u.clamp(1e-12, 1 - 1e-12)
        return spec["scale"] * torch.log(u / (1 - u))
    if spec["kind"] == "normal":
        return spec["scale"] * torch.randn(rows, generator=g, device=device,
                                           dtype=torch.float64)
    raise ValueError(f"unknown noise kind {spec['kind']!r}")


def _label(spec: dict, X: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    rows = X.shape[0]
    device = X.device
    x64 = X.to(torch.float64)
    z = (x64 - x64.mean(0)) / x64.std(0).clamp_min(1e-12)
    score = torch.zeros(rows, dtype=torch.float64, device=device)
    for t in spec["terms"]:
        score += t["w"] * _term(t["op"], z, t["cols"])
    score += _noise(spec["noise"], g, rows, device)
    if spec["kind"] == "binary_share":
        k = max(1, min(rows, int(round(rows * (1.0 - spec["share"])))))
        cut = torch.kthvalue(score.cpu(), k).values.to(device)
        return (score > cut).to(torch.float32)
    if spec["kind"] == "skewed_year":
        age = torch.exp(math.log(spec["median_age"]) + score)
        year = torch.round(spec["hi"] - age).clamp(spec["lo"], spec["hi"])
        return year.to(torch.float32)
    raise ValueError(f"unknown label kind {spec['kind']!r}")


def make(data: dict, seed: int, device, rows: int = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X (rows, F) float32, y (rows,) float32) on `device` from `seed`:
    every row of the dataset (`rows` overrides the count, for tests)."""
    rows = int(data["rows"] if rows is None else rows)
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    dists = column_dists(data)
    X = torch.empty((rows, len(dists)), dtype=torch.float32, device=device)
    for name in sorted(set(dists), key=dists.index):
        cols = [i for i, d in enumerate(dists) if d == name]
        X[:, cols] = _draw(data["dists"][name], g, rows, len(cols),
                           device).to(torch.float32)
    return X, _label(data["label"], X, g)


def split(data: dict, X: torch.Tensor, y: torch.Tensor, train_rows: int = None
          ) -> Dict[str, torch.Tensor]:
    """The training rows and the held-out rows, as the published split
    cuts them (the training rows first)."""
    n = int(data["train_rows"] if train_rows is None else train_rows)
    return {"X": X[:n], "y": y[:n], "X_test": X[n:], "y_test": y[n:]}
