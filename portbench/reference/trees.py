"""Histogram trees, as the estimators document them, in plain PyTorch.

A tree grows level by level to `max_depth`. Each row carries a gradient
g, a Hessian h and a weight w: boosted logistic loss g = p - y and
h = max(p(1 - p), 1e-16) at p = sigmoid(margin) (XGBoost's
`binary:logistic`); boosted squared loss g = margin - y, h = 1; a forest
g = -y, h = 1. A node's candidate split (feature f, bin b) sends the rows
of bin <= b left; its score is

    T(GL, HL) + T(GR, HR) - T(G, H),   T(g, h) = g^2 / ((h + lambda) + 1e-12)

over the weighted sums of g, h and w of its children. A candidate counts
when f is among the node's sampled features, b is not the last bin and
both children hold at least `min_child_weight` of the configuration's
`min_child_of`: the Hessian sum (XGBoost's `min_child_weight`) or the
weight sum (Spark's `minInstancesPerNode`, each row counted by its
bootstrap weight). A node splits on its best candidate when that score
is above 0, else it is a leaf. A leaf's value is -G / ((H + lambda) +
1e-12) of its rows; a node that no weighted row reached takes its
parent's value. A row goes right where its value is above the split's
threshold (the edge of bin b).

`judge_fit` follows a fitted model round by round: it computes each
round's gradients in float64 from the model's own earlier trees (the
state the fit was in). In every round it sums each node's
`min_child_of` over the rows that reach it and finds any split whose
child holds less than `min_child_weight` (`INADMISSIBLE`). In the judged
rounds it also histograms the round's rows under the reference's own
bins and reads, level by level, how far the model's splits fall short of
the best candidates: the regret of a level is

    sum W * (best - chosen) / sum W * best

over the level's nodes (W a node's weight, `best` the best candidate's
score, `chosen` the model's split's, 0 where the model made a leaf).
Scores are variance reductions, so the ratio does not move with the
labels' offset, and weighting by rows lets a few-row node's float32
rounding pass while a wrong split of a populous node does not. Leaves
are read against the leaf value of the rows that reached them, weighted
by rows: sum W |leaf - reference| / sum W |reference| (`leaf_gap`).
`build_tree` grows a tree itself, in float64 or in bfloat16 values with
float32 sums (the control). `Judge` holds a fitted model's answers to
the configuration: every number that decides `correct`.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import binning, threefry

F64 = torch.float64
#: the regret of a split that the configuration does not allow (a masked
#: feature, or a child under the least weight)
INADMISSIBLE = 1e6
#: rows x features histogrammed at a time
_CELLS = 1 << 26
#: the column of (g*w, h*w, w) that `min_child_weight` holds
_MIN_COLUMN = {"hessian": 1, "weight": 2}


class Frame:
    """A dataset under one binning: raw rows X (n, F) float32 and labels
    y on one device, the (F, B-1) edges and the rows' bins."""

    def __init__(self, X: torch.Tensor, y: torch.Tensor, edges: np.ndarray,
                 max_bins: int):
        self.X, self.y, self.edges, self.B = X, y, edges, int(max_bins)
        self.bins = binning.bins(X, edges)
        self.n, self.F = X.shape


def _term(g, h, lam):
    return (g * g) / ((h + lam) + 1e-12)


def min_column(model: dict) -> int:
    return _MIN_COLUMN[model["min_child_of"]]


def level_hist(fr: Frame, rows: torch.Tensor, slot: torch.Tensor,
               n_slots: int, stats: torch.Tensor,
               acc=F64) -> torch.Tensor:
    """(n_slots, F, B, 3) sums of `stats` ((m, 3), of the `rows` given by
    index) by (slot, feature, bin), accumulated in `acc`."""
    F, B = fr.F, fr.B
    out = torch.zeros((n_slots * F * B, 3), dtype=acc, device=fr.X.device)
    if rows.numel() == 0:
        return out.view(n_slots, F, B, 3)
    step = max(1, _CELLS // max(int(rows.numel()), 1))
    row_bins = fr.bins[rows]
    for f0 in range(0, F, step):
        f1 = min(F, f0 + step)
        fs = torch.arange(f0, f1, device=fr.X.device)
        idx = ((slot[:, None] * F + fs[None, :]) * B
               + row_bins[:, f0:f1]).reshape(-1)
        src = stats.to(acc)[:, None, :].expand(-1, f1 - f0, 3).reshape(-1, 3)
        out.index_add_(0, idx, src)
    return out.view(n_slots, F, B, 3)


def best_splits(hist: torch.Tensor, mask: Optional[torch.Tensor], lam: float,
                min_child: float, col: int, rnd=None):
    """Per slot of an (S, F, B, 3) histogram: (best score, its flat
    candidate f * B + b, G, H, W), each child held to `min_child` of
    column `col`. `rnd` rounds each stored value (the control's lower
    precision)."""
    rnd = rnd or (lambda t: t)
    S, F, B, _ = hist.shape
    pref = rnd(torch.cumsum(hist, dim=2))
    GL, HL = pref[..., 0], pref[..., 1]
    G, H = GL[:, :1, -1:], HL[:, :1, -1:]
    CL = pref[..., col]
    C = CL[:, :1, -1:]
    kids = rnd(_term(GL, HL, lam) + _term(G - GL, H - HL, lam))
    score = rnd(kids - _term(G, H, lam))
    ok = (CL >= min_child) & ((C - CL) >= min_child)
    ok &= torch.arange(B, device=hist.device) < B - 1
    if mask is not None:
        ok &= mask[:, :, None]
    sc = torch.where(ok, score, float("-inf")).reshape(S, F * B)
    best, flat = sc.max(dim=1)
    W = pref[..., 2][:, 0, -1]
    return best, flat, G[:, 0, 0], H[:, 0, 0], W


def gradients(model: dict, y: torch.Tensor, margin: torch.Tensor):
    """(g, h) in float64 at `margin`."""
    y = y.to(F64)
    if not model["boosting"]:
        return -y, torch.ones_like(y)
    if model["loss"] == "logistic":
        p = torch.sigmoid(margin)
        return p - y, torch.clamp(p * (1 - p), min=1e-16)
    return margin - y, torch.ones_like(y)


def base_margin(model: dict, y: torch.Tensor) -> float:
    """A boosted fit's start: the labels' mean, or its log-odds (clipped
    to [1e-6, 1 - 1e-6]); 0 for a forest."""
    if not model["boosting"]:
        return 0.0
    mean = float(y.to(F64).mean())
    if model["loss"] == "logistic":
        p = min(max(mean, 1e-6), 1 - 1e-6)
        return float(np.log(p / (1 - p)))
    return mean


def draws(model: dict, t: int, n: int, F: int, device):
    """Round t's row weights and per-level feature masks (None where
    every feature is a candidate)."""
    w = threefry.row_weights(model["seed"], t, model["row_weights"],
                             model["rate"], n, device)
    k = int(model["feature_k"])
    masks = [threefry.feature_mask(model["seed"], t, L, 2 ** L, F, k, device)
             if k < F else None for L in range(model["max_depth"])]
    return w, masks


def route(X: torch.Tensor, sf: torch.Tensor, thr: torch.Tensor,
          depth: int, mass: Optional[torch.Tensor] = None):
    """Each row's terminal node of a tree ((N,) split features, -1 at a
    leaf, and thresholds); with `mass` ((n,) float64) also each node's sum
    of it over the rows that reach the node."""
    node = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    rows = torch.arange(X.shape[0], device=X.device)
    held = None
    if mass is not None:
        held = torch.zeros(sf.shape[0], dtype=F64, device=X.device)
        held[0] = mass.sum()
    for _ in range(depth):
        f = sf[node]
        x = X[rows, f.clamp(min=0)].to(F64)
        child = 2 * node + 1 + (x > thr[node]).to(torch.int64)
        go = f >= 0
        node = torch.where(go, child, node)
        if held is not None:
            held.index_add_(0, node[go], mass[go])
    return node if held is None else (node, held)


def inadmissible(fr: Frame, model: dict, h, w, sf: torch.Tensor,
                 thr: torch.Tensor):
    """The splits of a tree whose lighter child holds less than
    `min_child_weight` of the configuration's `min_child_of`, over rows of
    Hessians h and weights w: (their count, the worst one, each row's
    terminal node)."""
    D = int(model["max_depth"])
    col = min_column(model)
    mass = (h * w if col == 1 else w).to(F64)
    node, held = route(fr.X, sf, thr, D, mass)
    n_inner = 2 ** D - 1
    split = sf[:n_inner] >= 0
    kids = torch.arange(n_inner, device=sf.device)
    lighter = torch.minimum(held[2 * kids + 1], held[2 * kids + 2])
    bad = split & (lighter < float(model["min_child_weight"]))
    count = int(bad.sum())
    if not count:
        return 0, None, node
    i = int(torch.where(bad, lighter, float("inf")).argmin())
    return count, {"node": i, "lighter_child": float(lighter[i]),
                   "node_sum": float(held[i])}, node


def judge_tree(fr: Frame, model: dict, g, h, w, masks, sf: torch.Tensor,
               thr: torch.Tensor, leaf: torch.Tensor) -> Dict[str, float]:
    """The worst level's regret and the leaves' gap of one tree ((N,)
    split features, float64 thresholds and leaf values on the frame's
    device) on rows of gradients g, h and weights w."""
    D, lam = int(model["max_depth"]), float(model["reg_lambda"])
    mcw, col = float(model["min_child_weight"]), min_column(model)
    dev = fr.X.device
    n_nodes = 2 ** (D + 1) - 1
    stats = torch.stack([g * w, h * w, w.to(F64)], dim=1)
    node = torch.zeros(fr.n, dtype=torch.int64, device=dev)
    live = torch.ones(fr.n, dtype=torch.bool, device=dev)
    ref_leaf = torch.zeros(n_nodes, dtype=F64, device=dev)
    weight = torch.zeros(n_nodes, dtype=F64, device=dev)
    terminal = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    regret = 0.0
    where = None
    all_rows = torch.arange(fr.n, device=dev)
    for L in range(D + 1):
        width, base = 2 ** L, 2 ** L - 1
        rows = all_rows[live]
        lid = node[rows] - base
        sums = torch.zeros((width, 3), dtype=F64, device=dev)
        sums.index_add_(0, lid, stats[rows])
        reached = torch.zeros(width, dtype=torch.bool, device=dev)
        reached[lid] = True
        G, H, W = sums[:, 0], sums[:, 1], sums[:, 2]
        weight[base:base + width] = W
        parent = ref_leaf[(torch.arange(base, base + width, device=dev) - 1)
                          .clamp(min=0) // 2]
        own = -G / ((H + lam) + 1e-12)
        ref_leaf[base:base + width] = torch.where(W > 0, own, parent) \
            if L else own
        f_l = sf[base:base + width]
        splits = (f_l >= 0) & reached if L < D else torch.zeros_like(reached)
        terminal[base:base + width] = reached & ~splits
        if L < D:
            keep = w[rows] > 0
            hist = level_hist(fr, rows[keep], lid[keep], width,
                              stats[rows[keep]])
            best, _, _, _, _ = best_splits(
                hist, masks[L] if masks is not None else None, lam, mcw, col)
            # the model's own split, summed over the rows it sends left
            feat = f_l[lid].clamp(min=0)
            left = ~(fr.X[rows, feat].to(F64) > thr[base + lid])
            lsum = torch.zeros((width, 3), dtype=F64, device=dev)
            lsum.index_add_(0, lid, stats[rows] * left[:, None])
            rsum = torch.zeros((width, 3), dtype=F64, device=dev)
            rsum.index_add_(0, lid, stats[rows] * (~left)[:, None])
            GL, HL = lsum[:, 0], lsum[:, 1]
            chosen = _term(GL, HL, lam) + _term(rsum[:, 0], rsum[:, 1], lam) \
                - _term(G, H, lam)
            ok = (lsum[:, col] >= mcw) & (rsum[:, col] >= mcw)
            if masks is not None and masks[L] is not None:
                ok &= masks[L].gather(1, f_l.clamp(min=0)[:, None])[:, 0]
            gain = torch.where(reached & torch.isfinite(best) & (best > 0),
                               best, 0.0)
            short = torch.where(splits, (gain - chosen).clamp(min=0), gain)
            if bool((splits & ~ok).any()):
                level = INADMISSIBLE
                worst = int((splits & ~ok).to(torch.int8).argmax())
            else:
                mass = float((W * gain).sum())
                level = float((W * short).sum()) / mass if mass > 0 else 0.0
                worst = int((W * short).argmax())
            if level > regret:
                regret = level
                where = {"level": L, "node": base + worst,
                         "split": bool(splits[worst]),
                         "feature": int(f_l[worst]),
                         "best": float(best[worst]),
                         "chosen": float(chosen[worst]),
                         "W": float(W[worst]), "WL": float(lsum[worst, 2]),
                         "H": float(H[worst]), "HL": float(HL[worst])}
            go = splits[lid]
            node[rows] = torch.where(go, 2 * node[rows] + 1
                                     + (~left).to(torch.int64), node[rows])
            live[rows] = go
    ref_t, w_t = ref_leaf[terminal], weight[terminal]
    off = (leaf[terminal] - ref_t).abs()
    mass = (w_t * ref_t.abs()).sum()
    gap = float((w_t * off).sum() / mass) if float(mass) > 0 else 0.0
    return {"regret": regret, "leaf_gap": gap, "where": where}


def judge_fit(fr: Frame, model: dict, fit: dict, rounds: List[int],
              candidate: Optional[Callable] = None) -> Dict[str, float]:
    """The worst regret (and `where` it is) and leaf gap over `rounds` of
    a fit (`fit`: (T, N) `split_feature`, float64 `threshold`,
    `leaf_value`, and `base`), each round judged in the state of the
    fit's own earlier trees; every round's splits held to the least
    child weight (a split under it reads `INADMISSIBLE`).
    `candidate(t, margin, w, masks)` gives the tree judged at round t in
    place of the fit's own (the control's), grown in the same state."""
    dev = fr.X.device
    D = int(model["max_depth"])
    sf = torch.as_tensor(fit["split_feature"], device=dev).to(torch.int64)
    thr = torch.as_tensor(fit["threshold"], device=dev).to(F64)
    lv = torch.as_tensor(fit["leaf_value"], device=dev).to(F64)
    margin = torch.full((fr.n,), float(fit["base"]), dtype=F64, device=dev)
    out = {"regret": 0.0, "leaf_gap": 0.0, "where": None,
           "inadmissible": 0}
    todo = set(int(t) for t in rounds)
    for t in range(sf.shape[0]):
        g, h = gradients(model, fr.y, margin)
        w, masks = draws(model, t, fr.n, fr.F, dev)
        node = None
        if candidate is None:
            count, bad, node = inadmissible(fr, model, h, w, sf[t], thr[t])
            if count:
                out["inadmissible"] += count
                if out["regret"] < INADMISSIBLE:
                    out["regret"] = INADMISSIBLE
                    out["where"] = dict(bad, round=t, count=count)
        if t in todo:
            tree = (sf[t], thr[t], lv[t]) if candidate is None \
                else candidate(t, margin, w, masks)
            got = judge_tree(fr, model, g, h, w, masks, *tree)
            out["leaf_gap"] = max(out["leaf_gap"], got["leaf_gap"])
            if got["regret"] > out["regret"]:
                out["regret"] = got["regret"]
                out["where"] = dict(got["where"], round=t)
        if model["boosting"]:
            if node is None:
                node = route(fr.X, sf[t], thr[t], D)
            margin = margin + float(model["step_size"]) * lv[t][node]
    return out


def outputs(X: torch.Tensor, model: dict, fit: dict, dtype=F64
            ) -> torch.Tensor:
    """The model's output on rows X, summed in `dtype`: base plus
    step_size times each tree's leaf (boosted) or the trees' mean (a
    forest); the probability for a classifier."""
    dev = X.device
    D = int(model["max_depth"])
    sf = torch.as_tensor(fit["split_feature"], device=dev).to(torch.int64)
    thr = torch.as_tensor(fit["threshold"], device=dev).to(F64)
    lv = torch.as_tensor(fit["leaf_value"], device=dev).to(dtype)
    T = sf.shape[0]
    weight = float(model["step_size"]) if model["boosting"] else 1.0 / T
    w = torch.tensor(weight, dtype=dtype, device=dev)
    acc = torch.full((X.shape[0],), float(fit["base"]), dtype=dtype,
                     device=dev)
    for t in range(T):
        acc = acc + w * lv[t][route(X, sf[t], thr[t], D)]
    if model["output"] == "probability":
        return torch.sigmoid(acc.to(F64)).to(dtype)
    return acc


def build_tree(fr: Frame, model: dict, g, h, w, masks,
               low: bool = False):
    """A tree grown on the frame's own bins: (split features, float64
    thresholds, leaf values). `low`: values in bfloat16 and sums in
    float32 (the control), else float64 throughout."""
    D, lam = int(model["max_depth"]), float(model["reg_lambda"])
    mcw, col = float(model["min_child_weight"]), min_column(model)
    dev = fr.X.device
    if low:
        acc = torch.float32

        def rnd(t):
            return t.to(torch.bfloat16).to(torch.float32)
    else:
        acc = F64

        def rnd(t):
            return t.to(F64)
    n_nodes = 2 ** (D + 1) - 1
    g, h, w = rnd(g), rnd(h), rnd(w)
    stats = torch.stack([rnd(g * w), rnd(h * w), w], dim=1)
    sf = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    sb = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    leaf = torch.zeros(n_nodes, dtype=acc, device=dev)
    node = torch.zeros(fr.n, dtype=torch.int64, device=dev)
    live = torch.ones(fr.n, dtype=torch.bool, device=dev)
    all_rows = torch.arange(fr.n, device=dev)
    for L in range(D + 1):
        width, base = 2 ** L, 2 ** L - 1
        rows = all_rows[live]
        lid = node[rows] - base
        keep = w[rows] > 0
        hist = rnd(level_hist(fr, rows[keep], lid[keep], width,
                              stats[rows[keep]], acc=acc))
        mask = masks[L] if (L < D and masks is not None) else None
        best, flat, G, H, W = best_splits(hist, mask, lam, mcw, col, rnd=rnd)
        parent = leaf[(torch.arange(base, base + width, device=dev) - 1)
                      .clamp(min=0) // 2]
        own = rnd(-G / ((H + lam) + 1e-12))
        leaf[base:base + width] = torch.where(W > 0, own, parent) \
            if L else own
        if L == D:
            break
        do = (best > 0) & torch.isfinite(best)
        sf[base:base + width] = torch.where(do, flat // fr.B, -1)
        sb[base:base + width] = flat % fr.B
        go = do[lid]
        xb = fr.bins[rows, (flat // fr.B)[lid]]
        child = 2 * node[rows] + 1 + (xb > (flat % fr.B)[lid]).to(torch.int64)
        node[rows] = torch.where(go, child, node[rows])
        live[rows] = go
    thr = torch.as_tensor(binning.thresholds(
        fr.edges, sf.cpu().numpy(), sb.cpu().numpy()), device=dev)
    return sf, thr, leaf.to(F64)


def judged_rounds(n_trees: int, k: int, seed: int) -> List[int]:
    """Round 0 and k - 1 more drawn from the seed."""
    if n_trees <= k:
        return list(range(n_trees))
    rng = np.random.default_rng(int(seed))
    rest = rng.choice(np.arange(1, n_trees), size=k - 1, replace=False)
    return [0] + sorted(int(t) for t in rest)


def as_fit(arrays: dict) -> dict:
    """A model's saved arrays as the judge reads them: thresholds from
    the model's own edges."""
    return {"split_feature": arrays["split_feature"],
            "threshold": binning.thresholds(arrays["edges"],
                                            arrays["split_feature"],
                                            arrays["split_bin"]),
            "leaf_value": arrays["leaf_value"], "base": arrays["base"]}


def edges_diff(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int((a != b).sum())


class Judge:
    """The reference's view of one dataset: its edges and bins of the
    training rows, its start, and the held-out rows, on one device.

    `numbers` reads one fitted model's answer (`split_feature`,
    `split_bin`, `leaf_value`, `edges`, `base` and `heldout`, its output
    on the held-out rows):

    - `edges_diff`: bin edges unequal to the reference's (exact).
    - `base_gap`: a boosted model's start against the labels' log-odds
      or mean, relative (a forest starts at 0 and skips it).
    - `split_regret`: the worst level's regret over the judged rounds,
      or `INADMISSIBLE` where any round holds a split that the
      configuration does not allow.
    - `leaf_gap`: the worst judged tree's leaf gap.
    - `heldout_gap`: the most the model's output on the held-out rows
      lies from the reference's traversal of the model in float64 from
      the reference's start (a probability, or a prediction over the
      labels' standard deviation).

    The judged rounds are round 0 and `judge_rounds - 1` more drawn from
    the seed."""

    def __init__(self, cfg: dict, host: dict, dev, settings: dict):
        self.model = cfg["model"]
        B = int(self.model["max_bins"])
        X = torch.from_numpy(host["X"]).to(dev)
        y = torch.from_numpy(host["y"]).to(dev)
        self.edges = binning.edges(host["X"], B)
        self.frame = Frame(X, y, self.edges, B)
        self.base = base_margin(self.model, y)
        self.X_test = torch.from_numpy(host["X_test"]).to(dev)
        self.judge_rounds = int(settings["judge_rounds"])
        #: the last judged answer's worst split
        self.where = None
        self.out_scale = 1.0 if self.model["output"] == "probability" \
            else max(float(y.to(F64).std()), 1e-12)

    def rounds(self, seed: int) -> List[int]:
        return judged_rounds(int(self.model["n_trees"]), self.judge_rounds,
                             seed)

    def numbers(self, answer: dict, seed: int) -> Dict[str, float]:
        m = self.model
        T, D = int(m["n_trees"]), int(m["max_depth"])
        got = {"edges_diff": float(edges_diff(answer["edges"], self.edges))}
        if m["boosting"]:
            got["base_gap"] = abs(answer["base"] - self.base) \
                / max(abs(self.base), 1e-3)
        if answer["split_feature"].shape != (T, 2 ** (D + 1) - 1):
            # a model of other trees or depths: nothing of it is judged
            got.update(split_regret=INADMISSIBLE, leaf_gap=INADMISSIBLE,
                       heldout_gap=INADMISSIBLE)
            return got
        fit = as_fit(answer)
        j = judge_fit(self.frame, m, fit, self.rounds(seed))
        got["split_regret"], got["leaf_gap"] = j["regret"], j["leaf_gap"]
        self.where = j["where"]
        ref = outputs(self.X_test, m, dict(fit, base=self.base))
        cand = torch.as_tensor(np.asarray(answer["heldout"], np.float64),
                               device=ref.device)
        got["heldout_gap"] = float((cand - ref).abs().max()) \
            / self.out_scale if ref.numel() else 0.0
        return got


def digest(answer: dict) -> str:
    """A key of an answer's arrays: bit-identical fits share it."""
    h = hashlib.sha256()
    for k in sorted(answer):
        h.update(k.encode())
        h.update(np.ascontiguousarray(answer[k]).tobytes())
    return h.hexdigest()
