"""ALS: alternating least squares on one device or over ranks.

The port's copy of `sml_tpu/ml/recommendation.py` (MLE 01,
`SML/ML Electives/MLE 01 - Collaborative Filtering Lab.py:159-201`). The
rating triples are sorted by user and by item once per fit on the host
(`sort_als_triples`, verbatim), and every entity's rating run is
[start, end) of the sorted order, found by `searchsorted`. Each
half-step then solves every entity's normal equations without a
scatter:

- per rating, the stats `[f ⊗ f, r·f]` of the other side's factor f;
- each entity's sums as differences of one float64 prefix sum
  (`torch.cumsum`, in two levels: `segment_prefix`) at its bounds;
- ALS-WR regularization `reg·max(count, 1)` on the diagonal, one batched
  solve, and zero factors for an entity with no ratings.

The JAX package carries its prefix in double-single f32 pairs
(`_ds_cumsum`), having no float64; the port sums in float64, solves in
float64 and rounds each factor matrix to f32, the JAX package's factor
dtype. A float `index_add_` would be shorter, but its atomics add in a
different order from run to run. The whole fit stays on the device and
the two factor matrices come back in one copy each at the end.

Over a mesh of ranks on the fit's device every rank sorts all the
triples and draws the same inits, then holds only its contiguous slice
of the user-sorted and of the item-sorted triples (`mesh.row_range`,
the JAX package's `host_partition` blocks), with each entity's bounds
clipped to the slice (`slice_bounds`, the JAX package's `bounds_for`):
an entity whose run crosses a slice edge gets a partial sum on both
ranks, one with no rating there an empty run. Each half-step
all-reduces the (n_out, r^2 + r) segment sums with the (n_out,) counts
in one call (`tree_impl.mesh_merge`) before the solve, as the JAX
package psums them.

The fit reads its columns from the frame's numpy blocks (the JAX
package calls `toPandas()`). `implicitPrefs` is declared and ignored, as
in the JAX package. The factor frames hold the factors as a vector
column (a 2-D float64 block); the recommendation frames hold a list of
{"id", "rating"} dicts a row, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.column import block_len, object_array
from ..utils.profiler import PROFILER
from .base import Estimator, Model, load_arrays, save_arrays


def sort_als_triples(u32: np.ndarray, i32: np.ndarray, ratings: np.ndarray):
    """Per-side stable sort of the rating triples (host, once per fit —
    ids are static across iterations)."""
    u_order = np.argsort(u32, kind="stable")
    i_order = np.argsort(i32, kind="stable")
    return {
        "u_sorted": u32[u_order], "i_sorted": i32[i_order],
        "ius": i32[u_order], "usi": u32[i_order],
        "rat_u": ratings[u_order], "rat_i": ratings[i_order],
    }


def segment_bounds(ids_sorted: np.ndarray, n_out: int) -> np.ndarray:
    """(2, n_out) [start, end) of each entity's run in `ids_sorted`."""
    ents = np.arange(n_out)
    return np.stack([np.searchsorted(ids_sorted, ents),
                     np.searchsorted(ids_sorted, ents + 1)]).astype(np.int64)


def slice_bounds(bounds: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Global (2, n_out) run bounds clipped to the rows [start, stop) of
    a slice and made local to it: a run the slice cuts keeps its part,
    a run outside it becomes empty (start == end)."""
    return np.clip(bounds, start, stop) - start


#: rows a block of the two-level prefix sum covers
PREFIX_BLOCK = 1024


def segment_prefix(stats: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1, s) inclusive prefix sums over the rows of `stats` with a
    zero first row. `stats` (n_pad, s) is a whole number of
    `PREFIX_BLOCK`-row blocks, its rows past n zero. The sums run in two
    levels, within each block and then over the block totals: a scan
    along the rows of a 2-D tensor runs each column's adds one after
    another on the card, so one level over 800,000 rows takes that many
    dependent steps, two levels about two thousand. Every add is an add
    in `stats`' dtype in the same order on every device."""
    n_pad, s = stats.shape
    nb = n_pad // PREFIX_BLOCK
    prefix = stats.new_empty((n_pad + 1, s))
    prefix[0] = 0.0
    within = prefix[1:].view(nb, PREFIX_BLOCK, s)
    torch.cumsum(stats.view(nb, PREFIX_BLOCK, s), dim=1, out=within)
    offsets = torch.cumsum(within[:-1, -1, :], dim=0)
    within[1:] += offsets[:, None, :]
    return prefix[:n + 1]


def als_half(other: torch.Tensor, rat: torch.Tensor, bounds: torch.Tensor,
             reg: float, nonneg: bool, merge=None) -> torch.Tensor:
    """One half-step: each entity's factor from the other side's factors
    `other` (rows in this side's sorted order, float64), the ratings
    `rat` in the same order and the (2, n_out) `bounds`. Returns the
    (n_out, rank) factors as float64 values of f32. With `merge` (a
    mesh's all-reduce) the rows are this rank's slice and the segment
    sums and counts are merged over the ranks before the solve."""
    n, rank = other.shape
    rr = rank * rank
    n_pad = -(-n // PREFIX_BLOCK) * PREFIX_BLOCK
    stats = other.new_empty((n_pad, rr + rank))
    stats[n:] = 0.0
    torch.mul(other[:, :, None], other[:, None, :],
              out=stats[:n, :rr].view(n, rank, rank))
    torch.mul(other, rat[:, None], out=stats[:n, rr:])
    prefix = segment_prefix(stats, n)
    del stats
    starts, ends = bounds[0], bounds[1]
    seg = prefix[ends] - prefix[starts]
    del prefix
    cnt = (ends - starts).to(torch.float64)
    if merge is not None:
        flat = merge(torch.cat([seg, cnt[:, None]], dim=1))
        seg, cnt = flat[:, :-1], flat[:, -1]
    lam = reg * torch.clamp_min(cnt, 1.0)
    A = seg[:, :rr].reshape(-1, rank, rank) + lam[:, None, None] * \
        torch.eye(rank, dtype=seg.dtype, device=seg.device)[None]
    sol = torch.linalg.solve(A, seg[:, rr:, None])[:, :, 0]
    sol = torch.where(cnt[:, None] > 0, sol, 0.0)
    if nonneg:
        sol = torch.clamp_min(sol, 0.0)
    return sol.to(torch.float32).to(torch.float64)


def als_fit(prep: dict, n_users: int, n_items: int, uf0: np.ndarray,
            if0: np.ndarray, reg: float, max_iter: int, nonneg: bool,
            device: torch.device, mesh=None):
    """`max_iter` alternations on `device` from the f32 inits; returns
    the (user, item) factor matrices as f32 host arrays. Over a `mesh`
    this rank holds only its slice of each sorted order, and every
    half-step merges its segment sums over the ranks."""
    from ..parallel.mesh import row_range

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dtype)

    start, stop, merge = 0, len(prep["rat_u"]), None
    if mesh is not None:
        from .tree_impl import mesh_merge
        start, stop = row_range(stop, mesh)
        merge = mesh_merge(mesh)
    rows = slice(start, stop)
    ius = put(prep["ius"][rows], torch.int64)
    usi = put(prep["usi"][rows], torch.int64)
    rat_u = put(prep["rat_u"][rows], torch.float64)
    rat_i = put(prep["rat_i"][rows], torch.float64)
    ub = put(slice_bounds(segment_bounds(prep["u_sorted"], n_users), start,
                          stop), torch.int64)
    ib = put(slice_bounds(segment_bounds(prep["i_sorted"], n_items), start,
                          stop), torch.int64)
    uf, itf = put(uf0, torch.float64), put(if0, torch.float64)
    for _ in range(max_iter):
        uf = als_half(itf[ius], rat_u, ub, reg, nonneg, merge)
        itf = als_half(uf[usi], rat_i, ib, reg, nonneg, merge)
    return (uf.to(torch.float32).cpu().numpy(),
            itf.to(torch.float32).cpu().numpy())


def als_init(rng: np.random.Generator, n_users: int, n_items: int,
             rank: int):
    """MLlib-style init (ALS.scala initialize), the JAX package's draws:
    |N(0,1)| rows normalized to unit norm, users then items."""
    uf0 = np.abs(rng.standard_normal((n_users, rank))).astype(np.float32)
    if0 = np.abs(rng.standard_normal((n_items, rank))).astype(np.float32)
    uf0 /= np.linalg.norm(uf0, axis=1, keepdims=True) + 1e-12
    if0 /= np.linalg.norm(if0, axis=1, keepdims=True) + 1e-12
    return uf0, if0


class ALS(Estimator):
    def _init_params(self):
        self._declareParam("userCol", default="user", doc="user id column")
        self._declareParam("itemCol", default="item", doc="item id column")
        self._declareParam("ratingCol", default="rating",
                           doc="rating column")
        self._declareParam("predictionCol", default="prediction",
                           doc="prediction column")
        self._declareParam("rank", default=10, doc="latent factor size")
        self._declareParam("maxIter", default=10, doc="alternations")
        self._declareParam("regParam", default=0.1, doc="ALS-WR lambda")
        self._declareParam("coldStartStrategy", default="nan",
                           doc="nan|drop")
        self._declareParam("nonnegative", default=False,
                           doc="clip factors at 0")
        self._declareParam("implicitPrefs", default=False,
                           doc="implicit feedback")
        self._declareParam("seed", default=None, doc="init seed")

    def __init__(self, userCol=None, itemCol=None, ratingCol=None, rank=None,
                 maxIter=None, regParam=None, coldStartStrategy=None,
                 nonnegative=None, implicitPrefs=None, seed=None,
                 predictionCol=None):
        super().__init__()
        self._set(userCol=userCol, itemCol=itemCol, ratingCol=ratingCol,
                  rank=rank, maxIter=maxIter, regParam=regParam,
                  coldStartStrategy=coldStartStrategy,
                  nonnegative=nonnegative, implicitPrefs=implicitPrefs,
                  seed=seed, predictionCol=predictionCol)

    def setColdStartStrategy(self, v):
        return self._set(coldStartStrategy=v)

    def getUserCol(self):
        return self.getOrDefault("userCol")

    def getItemCol(self):
        return self.getOrDefault("itemCol")

    def _fit(self, df) -> "ALSModel":
        from ..device import session_device
        from ..parallel.dispatch import WorkHint
        from ._staging import mesh_rows, routed_for
        whole = df._whole()
        uc, ic, rc = (self.getOrDefault("userCol"),
                      self.getOrDefault("itemCol"),
                      self.getOrDefault("ratingCol"))
        rank = int(self.getOrDefault("rank"))
        seed = self.getOrDefault("seed")
        rng = np.random.default_rng(int(seed) if seed is not None else 0)

        ratings = np.asarray(whole[rc], dtype=np.float32)
        u_ids, u_index = np.unique(np.asarray(whole[uc]),
                                   return_inverse=True)
        i_ids, i_index = np.unique(np.asarray(whole[ic]),
                                   return_inverse=True)
        U, I = len(u_ids), len(i_ids)
        prep = sort_als_triples(u_index.astype(np.int32),
                                i_index.astype(np.int32), ratings)
        uf0, if0 = als_init(rng, U, I, rank)
        max_iter = int(self.getOrDefault("maxIter"))
        # the whole alternating fit routed as one program: nnz * rank^2
        # a half-step plus (U + I) * rank^3 of solves
        hint = WorkHint(flops=2.0 * max_iter * (len(ratings) * rank * rank
                                                + (U + I) * rank ** 3),
                        kind="segment")
        with routed_for(hint, prep["ius"], prep["usi"], prep["rat_u"],
                        prep["rat_i"], device=session_device()) as device, \
                PROFILER.span("program.als_fit", rows=len(ratings),
                              route=device.type):
            reg = float(self.getOrDefault("regParam"))
            nonneg = bool(self.getOrDefault("nonnegative"))
            mesh, _ = mesh_rows(
                device, len(ratings),
                (prep["ius"], prep["usi"], prep["rat_u"], prep["rat_i"],
                 uf0, if0), grid=("als", U, I, reg, max_iter, nonneg))
            uf, itf = als_fit(prep, U, I, uf0, if0, reg, max_iter, nonneg,
                              device, mesh)
        m = ALSModel(user_ids=u_ids, item_ids=i_ids, user_factors=uf,
                     item_factors=itf)
        m._inherit_params(self)
        return m


class ALSModel(Model):
    def _init_params(self):
        ALS._init_params(self)

    def __init__(self, user_ids=None, item_ids=None, user_factors=None,
                 item_factors=None):
        super().__init__()
        self._user_ids = user_ids
        self._item_ids = item_ids
        self._uf = user_factors
        self._if = item_factors

    def setColdStartStrategy(self, v):
        return self._set(coldStartStrategy=v)

    @property
    def rank(self) -> int:
        if self._uf is None:
            # RuntimeError, not AttributeError: Params.__getattr__ would
            # re-report an AttributeError as "no attribute rank"
            raise RuntimeError("ALSModel has no factors (not fitted)")
        return int(self._uf.shape[1])

    @staticmethod
    def _factor_frame(ids, factors):
        from ..frame.session import get_session
        return get_session().createDataFrame(
            {"id": np.asarray(ids),
             "features": np.asarray(factors, dtype=np.float64)})

    @property
    def userFactors(self):
        return self._factor_frame(self._user_ids, self._uf)

    @property
    def itemFactors(self):
        return self._factor_frame(self._item_ids, self._if)

    @staticmethod
    def _lookup(raw, ids):
        idx = np.searchsorted(ids, raw)
        idx = np.clip(idx, 0, len(ids) - 1)
        known = ids[idx] == raw
        return idx, known

    def _transform(self, df):
        from ..device import session_device
        from ..frame.dataframe import take_rows
        session_device()  # a DataFrame entry point: no card, no transform
        uc, ic = self.getOrDefault("userCol"), self.getOrDefault("itemCol")
        oc = self.getOrDefault("predictionCol")
        cold = self.getOrDefault("coldStartStrategy")

        def fn(block, ctx):
            out = dict(block)
            if not block_len(block):
                out[oc] = np.zeros(0)
                return out
            ui, u_ok = self._lookup(np.asarray(block[uc]), self._user_ids)
            ii, i_ok = self._lookup(np.asarray(block[ic]), self._item_ids)
            pred = np.einsum("ij,ij->i", self._uf[ui], self._if[ii])
            pred = np.where(u_ok & i_ok, pred, np.nan)
            out[oc] = pred.astype(np.float64)
            if cold == "drop":
                out = take_rows(out, np.isfinite(out[oc]))
            return out

        return df._derive(fn, op="predict")

    def _recommend(self, ids, factors, other_ids, other_factors, n: int,
                   id_col: str):
        from ..frame.session import get_session
        scores = factors @ other_factors.T
        top = np.argsort(-scores, axis=1)[:, :n]
        recs = [[{"id": int(other_ids[j])
                  if np.issubdtype(type(other_ids[j]), np.integer)
                  else other_ids[j], "rating": float(scores[i, j])}
                 for j in top[i]] for i in range(len(ids))]
        return get_session().createDataFrame(
            {id_col: np.asarray(ids), "recommendations": object_array(recs)})

    def recommendForAllUsers(self, numItems: int):
        return self._recommend(self._user_ids, self._uf, self._item_ids,
                               self._if, numItems,
                               self.getOrDefault("userCol"))

    def recommendForAllItems(self, numUsers: int):
        return self._recommend(self._item_ids, self._if, self._user_ids,
                               self._uf, numUsers,
                               self.getOrDefault("itemCol"))

    def recommendForUserSubset(self, dataset, numItems: int):
        uc = self.getOrDefault("userCol")
        want = np.unique(np.asarray(dataset._whole()[uc]))
        sel = np.isin(self._user_ids, want)
        return self._recommend(self._user_ids[sel], self._uf[sel],
                               self._item_ids, self._if, numItems, uc)

    def _save_state(self, path):
        save_arrays(path, user_ids=self._user_ids, item_ids=self._item_ids,
                    user_factors=self._uf, item_factors=self._if)

    def _load_state(self, path, meta):
        d = load_arrays(path)
        self._user_ids = d["user_ids"]
        self._item_ids = d["item_ids"]
        self._uf = d["user_factors"]
        self._if = d["item_factors"]
