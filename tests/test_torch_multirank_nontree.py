"""The non-tree programs and the evaluators over a mesh of ranks, on the CPU.

Each layout is one launch of gloo ranks (subprocesses, each with its own
timeout; `initialize_multihost` on a `file://` store, `device="cpu"`),
all three launches started at once by a module-scoped fixture: 1 rank
(a default group of world size 1), 2 ranks, and 4 ranks, which run flat
and then as 2 host groups (`sml.mesh.hostGroups=2`). Every rank runs
every program on all the rows; each stages only its block and
all-reduces its float64 partial sums.

- Bit-equal to the port's own run outside any mesh, on every rank of
  every layout: the Gram moments (dense, compact, and on integer data,
  where every partial sum is exact), the ridge and elastic-net
  coefficients solved from them, both IRLS fits (dense and compact:
  their moments are rounded to f32 once after the all-reduce, which
  hides the order of the float64 adds on these inputs), and KMeans'
  centers and cost (rounded to f32 each iteration, and came out
  bit-equal). The evaluators' statistics (regression, accuracy, the
  fused predict+eval) are bit-equal by construction: the ordered block
  reduction adds the same block partials in the same order in every
  layout.
- ALS's segment sums are differences of prefix sums over each rank's
  slice, so they differ from the one-rank sums in the last float64 bits,
  and an f32 rounding can flip: its factors are held to 2e-6 absolute
  and its training rmse to 1e-6 relative (one rank: bit-equal; measured
  on these 2,000 ratings: bit-equal in every layout).
- One rank holds against the JAX package's 4-device CPU mesh
  (`build_mesh(4)`) within the tolerances of `tests/test_torch_linear.py`,
  `test_torch_compact_linear.py`, `test_torch_clustering.py` and
  `test_torch_als.py`.
- `collective.psum_bytes` of each program equals its payload: the Gram
  (d+1)^2 + (d+1) + 2 float64 values; an IRLS step (d+1) + (d+1)^2 + 1;
  a Lloyd iteration k*(d+1), and the cost once; an ALS half-step
  n_out * (r^2 + r + 1); an evaluation its blocks x 5 (accuracy x 1). On
  the host mesh the payload, padded to a multiple of the group size,
  goes to the "ici" hop and half of it to the "dcn" hop.
- Ranks given different rows raise on every rank; under a stub card's
  mesh `sml.dispatch.mode=host` runs the fits and the evaluation on the
  CPU over all the rows with no collective and gives the one-device
  result; a prewarm entry recorded over a mesh carries its width and
  host groups and is skipped outside it; `addressable_row_blocks` /
  `host_row_blocks` give each rank its own block, the JAX package's
  blocks on `host_mesh(2)` over 4 devices.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240

N, D = 3000, 5
LAYOUTS = [(1, "flat"), (2, "flat"), (4, "flat"), (4, "hosts")]
#: compact layout: 3 numeric slots and two one-hot pieces of 4 and 3
PARTS_LAYOUT = (("num", 0), ("num", 1), ("num", 2), ("oh", 0, 4),
                ("oh", 1, 3))
PARTS_WIDTH = 10
LOGIT_ITERS = 12
#: the dense IRLS's tol: at 1e-6 the JAX package's own 4-device fit stops
#: a step before its one-device fit (11 against 12, from its f32 psums);
#: at 1e-5 every run here takes 11 steps
LOGIT_TOL = 1e-5
KM = dict(k=3, maxIter=8, seed=5)
ALS_KW = dict(userCol="user", itemCol="item", ratingCol="rating", rank=4,
              maxIter=6, regParam=0.1, seed=3)
N_RATINGS = 2000
#: rating positions (in user order) that are a one-rating user's run:
#: both sides of every slice edge of 2 and 4 ranks
SINGLES = (499, 500, 999, 1000, 1499, 1500)
N_EVAL = 20_000


def _dense(seed: int = 4):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(N, D)) * rng.uniform(0.5, 4.0, D)
         + rng.normal(size=D)).astype(np.float32)
    y = (X @ rng.normal(size=D) + 2.0 + rng.normal(size=N)).astype(
        np.float32)
    return X, y


def _integer(seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 8, (N, D)).astype(np.float32)
    y = (X @ rng.integers(-3, 4, D) + rng.integers(0, 5, N)).astype(
        np.float32)
    return X, y


def _binary(y):
    return (y > np.median(y)).astype(np.float32)


def _parts_arrays(seed: int = 1):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(N, 3)).astype(np.float32)
    # one code past each piece's width: the dropped last category, so
    # that the one-hots and the intercept are not collinear
    codes = np.stack([rng.integers(0, 5, N), rng.integers(0, 4, N)],
                     axis=1).astype(np.int32)
    y = (num @ np.array([1.0, -0.5, 0.25]) + codes[:, 0] * 0.3
         + rng.normal(0, 0.5, N)).astype(np.float32)
    return num, codes, y


def _parts(pkg: str = "port"):
    if pkg == "port":
        from sml_tpu_torch.ml.featurizer import CompactParts
    else:
        from sml_tpu.ml.featurizer import CompactParts
    num, codes, y = _parts_arrays()
    return CompactParts(num, codes, PARTS_LAYOUT, PARTS_WIDTH, None), y


def _blobs():
    rng = np.random.default_rng(221)
    centers = np.array([[0.0, 0.0], [5.0, 5.0], [0.0, 6.0]])
    return np.concatenate([c + rng.normal(0, 0.4, (400, 2))
                           for c in centers])


def _ratings():
    """N_RATINGS (user, item, rating) triples in shuffled order whose
    user-sorted runs put a one-rating user on both sides of every slice
    edge of 2 and 4 ranks (`SINGLES`)."""
    rng = np.random.default_rng(17)
    users, p, u = [], 0, 0
    while p < N_RATINGS:
        nxt = min([s for s in SINGLES if s >= p] + [N_RATINGS])
        run = 1 if p in SINGLES else min(int(rng.integers(2, 12)), nxt - p)
        users += [u] * run
        p += run
        u += 1
    users = np.asarray(users, np.int64)
    items = np.empty(N_RATINGS, np.int64)
    for uu in np.unique(users):   # distinct items within a user
        idx = np.nonzero(users == uu)[0]
        items[idx] = rng.choice(60, size=len(idx), replace=False)
    rating = np.round(rng.uniform(1, 5, N_RATINGS) * 2) / 2
    order = rng.permutation(N_RATINGS)
    return users[order], items[order], rating[order]


def _eval_data():
    rng = np.random.default_rng(31)
    X = rng.normal(size=(N_EVAL, 4))
    y = (X[:, 0] * 2 - X[:, 1] ** 2 + rng.normal(0, 0.3, N_EVAL))
    y[::97] = np.nan
    pred = y + rng.normal(0, 0.5, N_EVAL)
    pred[::89] = np.nan
    lab = np.round(rng.uniform(0, 3, N_EVAL))
    guess = np.where(rng.uniform(size=N_EVAL) < 0.7, lab,
                     np.round(rng.uniform(0, 3, N_EVAL)))
    return X, y, pred, y.copy(), guess, lab


def _kmeans_frame(blobs):
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.feature import VectorAssembler
    return VectorAssembler(inputCols=["x", "y"],
                           outputCol="features").transform(
        get_session().createDataFrame({"x": blobs[:, 0],
                                       "y": blobs[:, 1]}))


def _programs(device, counts=None):
    """Every program of the file on `device` (the CPU or a stub card),
    outside or inside a mesh as the caller set it: {name: array}. With
    `counts` each program's collectives are counted into it by name
    (`collectives.COUNTS`, reset before each)."""
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import evaluation as pev
    from sml_tpu_torch.ml import linear_impl as plin
    from sml_tpu_torch.ml._tree_models import (DecisionTreeRegressor,
                                               fused_reg_stats_from_matrix)
    from sml_tpu_torch.ml.clustering import KMeans
    from sml_tpu_torch.ml.recommendation import ALS
    from sml_tpu_torch.parallel import collectives as coll
    out = {}

    def run(name, fn):
        coll.reset_counts()
        out[name] = np.asarray(fn(), dtype=np.float64)
        if counts is not None:
            counts[name] = dict(coll.COUNTS)

    def gram(fn, *args):
        A, b, n, yy = fn(*args, device=device)
        return np.concatenate([A.ravel(), b, [n, yy]])

    def linear(**kw):
        fit = plin.fit_linear(X, y, device=device, **kw)
        return np.concatenate([fit.coefficients, [fit.intercept]])

    def logistic(fit):
        return np.concatenate([fit.coefficients, [fit.intercept,
                                                  fit.iterations]])

    X, y = _dense()
    parts, yp = _parts()
    run("gram", lambda: gram(plin.gram_stats, X, y))
    run("gram_int", lambda: gram(plin.gram_stats, *_integer()))
    run("gram_compact", lambda: gram(plin.gram_stats_compact, parts, yp))
    run("ridge", lambda: linear(regParam=0.1))
    run("enet", lambda: linear(regParam=0.1, elasticNetParam=0.5))
    run("logistic", lambda: logistic(plin.fit_logistic(
        X, _binary(y), tol=LOGIT_TOL, device=device)))
    run("logistic_compact", lambda: logistic(plin.fit_logistic_compact(
        parts, _binary(yp), maxIter=LOGIT_ITERS, device=device)))
    frame = _kmeans_frame(_blobs())

    def kmeans():
        km = KMeans(**KM).fit(frame)
        return np.concatenate([np.ravel(km._centers), [km._trainingCost]])
    run("kmeans", kmeans)
    users, items, rating = _ratings()
    ratings = get_session().createDataFrame(
        {"user": users, "item": items, "rating": rating})

    def als():
        m = ALS(**ALS_KW).fit(ratings)
        return np.concatenate([m._uf.ravel(), m._if.ravel()])
    run("als", als)
    Xe, ye, pred, lab, guess, cls = _eval_data()
    ok = np.isfinite(pred) & np.isfinite(lab)
    run("reg_stats", lambda: pev.reg_stats(pred[ok], lab[ok], device))
    run("accuracy", lambda: [pev._accuracy(guess, cls, device)])
    keep = np.isfinite(ye)
    spec = DecisionTreeRegressor(maxDepth=4, maxBins=16).fit(
        Xe[keep], ye[keep], device=device)._spec
    run("fused_eval", lambda: fused_reg_stats_from_matrix(
        spec, Xe, ye, device=device))
    run("fused_eval_small", lambda: fused_reg_stats_from_matrix(
        spec, Xe[:3000], ye[:3000], link="exp", device=device))
    return out


WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
import test_torch_multirank_nontree as T
from sml_tpu_torch import GLOBAL_CONF
from sml_tpu_torch.ml import linear_impl as plin
from sml_tpu_torch.ml.clustering import KMeans
from sml_tpu_torch.parallel import collectives as coll, mesh as M
from sml_tpu_torch.parallel import prewarm as pw

rank, store, out, n, tmp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            int(sys.argv[4]), sys.argv[5])
if n == 1:   # a default group of one rank: the mesh path, nothing to add
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=1, rank=0)
    M.bind_rank_device("cpu")
else:
    assert coll.initialize_multihost("file://" + store, n, rank,
                                     backend="gloo", device="cpu",
                                     timeout_s=120)
GLOBAL_CONF.set("sml.device", "cpu")
res = {{}}
counts = {{}}
layouts = ["flat"] + (["hosts"] if n == 4 else [])
for layout in layouts:
    if layout == "hosts":
        GLOBAL_CONF.set("sml.mesh.hostGroups", 2)
        GLOBAL_CONF.set("sml.tree.hierarchicalAllreduce", "auto")
        M.set_mesh(M.host_mesh())
    counts[layout] = {{}}
    for k, v in T._programs(torch.device("cpu"), counts[layout]).items():
        res[layout + "_" + k] = v
    # the row blocks this rank addresses, with their host group
    blocks = M.host_row_blocks(np.arange(40 * 3).reshape(40, 3))
    res[layout + "_row_blocks"] = np.asarray(
        [[g, d.type == "cpu"] + blk.ravel().tolist()
         for g, pairs in blocks for d, blk in pairs])
    # prewarm: an entry recorded over this mesh carries its signature
    # and replays over it
    GLOBAL_CONF.set("sml.compile.cacheDir", os.path.join(tmp, layout))
    pw.record_stage(torch.device("cpu"), (37, 4), np.uint8)
    pw.flush()
    res[layout + "_prewarm_sig"] = np.asarray(
        [e["device"][1:] for e in pw.entries().values()])
    res[layout + "_prewarm_here"] = np.asarray(
        [pw.prewarm(device="cpu")["programs"]])
if n == 2:   # ranks given different rows raise, every one of them
    X, y = T._dense()
    blobs = T._blobs()
    if rank == 1:
        X[::7, 0] += 1.0
        blobs[::5, 1] += 0.5
    raised = []
    for fit in (lambda: plin.gram_stats(X, y, device="cpu"),
                lambda: KMeans(**T.KM).fit(T._kmeans_frame(blobs))):
        try:
            fit()
            raised.append(0)
        except ValueError as e:
            assert "different fit inputs" in str(e), e
            raised.append(1)
    res["mismatch_raised"] = np.asarray(raised)
    # the host route under a stub card's mesh: every program on the CPU
    # over all the rows, with no collective
    card = torch.device("cuda", 0)
    GLOBAL_CONF.set("sml.dispatch.mode", "host")
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        with M.use_mesh(M.Mesh(M.get_mesh().group, M.get_mesh().ranks,
                               card)):
            GLOBAL_CONF.set("sml.device", "cuda:0")
            coll.reset_counts()
            for k, v in T._programs(card).items():
                res["host_" + k] = v
            res["host_collectives"] = np.asarray(
                [sum(coll.COUNTS.values())])
    finally:
        torch.cuda.is_available = real
        GLOBAL_CONF.set("sml.device", "cpu")
        GLOBAL_CONF.set("sml.dispatch.mode", "auto")
with open(out + ".json", "w") as f:
    json.dump(counts, f)
np.savez(out, **res)
print("rank", rank, "ok")
"""


def _start(tmp, n: int):
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    script = WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    outs = [str(tmp / f"rank{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(tmp / "store"), outs[r],
         str(n), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return procs, outs, tmp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: (each rank's results, each rank's counts, the launch's
    directory)}; the three launches run at once, each rank under its
    own timeout."""
    import json
    launches, logs = {}, {}
    try:
        for n in (1, 2, 4):
            launches[n] = _start(tmp_path_factory.mktemp(f"nontree{n}"), n)
        for n, (procs, _, _) in launches.items():
            logs[n] = [p.communicate(timeout=RANK_TIMEOUT)[0]
                       for p in procs]
    finally:
        for procs, _, _ in launches.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for n, (procs, _, _) in launches.items():
        for r, (p, log) in enumerate(zip(procs, logs[n])):
            assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
    out = {}
    for n, (_, outs, tmp) in launches.items():
        counts = []
        for o in outs:
            with open(o + ".json") as f:
                counts.append(json.load(f))
        out[n] = ([dict(np.load(o)) for o in outs], counts, tmp)
    return out


@pytest.fixture(scope="module")
def reference():
    """The port's own programs outside any mesh, on the CPU."""
    from sml_tpu_torch import GLOBAL_CONF
    GLOBAL_CONF.set("sml.device", "cpu")
    try:
        return _programs(__import__("torch").device("cpu"))
    finally:
        GLOBAL_CONF.unset("sml.device")


#: programs whose every rank, in every layout, gives the one-device bits
BIT_EQUAL = ("gram", "gram_int", "gram_compact", "ridge", "enet",
             "logistic", "logistic_compact", "kmeans", "reg_stats",
             "accuracy", "fused_eval", "fused_eval_small")


@pytest.mark.parametrize("name", BIT_EQUAL)
@pytest.mark.parametrize("n,layout", LAYOUTS)
def test_every_rank_gives_the_one_device_bits(runs, reference, n, layout,
                                              name):
    for rank, res in enumerate(runs[n][0]):
        np.testing.assert_array_equal(
            res[f"{layout}_{name}"], reference[name],
            err_msg=f"{name} on rank {rank} of {n} ({layout})")


def _als_rmse(factors):
    users, items, rating = _ratings()
    U, I = len(np.unique(users)), len(np.unique(items))
    r = ALS_KW["rank"]
    uf = factors[:U * r].reshape(U, r)
    itf = factors[U * r:].reshape(I, r)
    u = np.unique(users, return_inverse=True)[1]
    i = np.unique(items, return_inverse=True)[1]
    pred = np.sum(uf[u] * itf[i], axis=1)
    return float(np.sqrt(np.mean((pred - rating) ** 2)))


@pytest.mark.parametrize("n,layout", LAYOUTS)
def test_als_factors_within_tolerance_of_one_device(runs, reference, n,
                                                    layout):
    """One rank gives the one-device bits; more ranks sum each slice's
    prefix differences in another order: factors within 2e-6, the
    training rmse within 1e-6 relative."""
    want = reference["als"]
    for res in runs[n][0]:
        got = res[f"{layout}_als"]
        if n == 1:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        assert _als_rmse(got) == pytest.approx(_als_rmse(want), rel=1e-6)


def test_ratings_put_single_rating_users_at_every_slice_edge():
    """The ALS data's user-sorted order has one-rating users on both
    sides of each slice edge of 2 and 4 ranks, and items whose runs
    cross an edge."""
    from sml_tpu_torch.parallel.mesh import host_partition
    users, items, _ = _ratings()
    u_sorted = np.sort(users, kind="stable")
    i_sorted = np.sort(items, kind="stable")
    counts = np.bincount(users)
    for size in (2, 4):
        for start, _ in host_partition(N_RATINGS, size)[1:]:
            assert counts[u_sorted[start]] == counts[u_sorted[start - 1]] \
                == 1
            assert i_sorted[start] == i_sorted[start - 1]   # a cut run


def _payload(name: str, reference) -> list:
    """The float64 values of each all-reduce a program makes."""
    d1, w1 = D + 1, PARTS_WIDTH + 1
    blocks = -(-N_EVAL // 4096)
    if name in ("gram", "gram_int", "ridge", "enet"):
        return [d1 * d1 + d1 + 2]
    if name == "gram_compact":
        return [w1 * w1 + w1 + 2]
    if name == "logistic":
        return [d1 + d1 * d1 + 1] * int(reference["logistic"][-1])
    if name == "logistic_compact":
        return [w1 + w1 * w1 + 1] * LOGIT_ITERS
    if name == "kmeans":
        return [KM["k"] * 3] * KM["maxIter"] + [1]
    if name == "als":
        users, items, _ = _ratings()
        r = ALS_KW["rank"]
        per = r * r + r + 1
        return [len(np.unique(users)) * per,
                len(np.unique(items)) * per] * ALS_KW["maxIter"]
    if name == "reg_stats":
        _, _, pred, lab, _, _ = _eval_data()
        ok = int(np.sum(np.isfinite(pred) & np.isfinite(lab)))
        return [-(-ok // 4096) * 5]
    if name == "accuracy":
        return [blocks]
    if name == "fused_eval":
        return [blocks * 5]
    return [5]   # fused_eval_small: 3,000 rows, one block


@pytest.mark.parametrize("name", BIT_EQUAL + ("als",))
@pytest.mark.parametrize("n,layout", LAYOUTS)
def test_psum_bytes_are_the_payload(runs, reference, n, layout, name):
    """Each program's all-reduces carry its float64 partials and nothing
    else (and one MIN / MAX pair checks a fit's inputs); on the host
    mesh the payload, padded to the group size, crosses the "ici" hop
    and half of it the "dcn" hop."""
    values = _payload(name, reference)
    fits = name not in ("reg_stats", "accuracy", "fused_eval",
                        "fused_eval_small")
    for c in runs[n][1]:
        got = c[layout][name]
        assert got.get("collective.pmin", 0) == (1 if fits else 0)
        if layout == "flat":
            assert got["collective.psum"] == len(values)
            assert got["collective.psum_bytes"] == 8 * sum(values)
        else:
            padded = [v + v % 2 for v in values]
            assert got["collective.psum.ici"] == len(values)
            assert got["collective.psum_bytes.ici"] == 8 * sum(padded)
            assert got["collective.psum_bytes.dcn"] == 4 * sum(padded)
            assert "collective.psum_bytes" not in got


def _jax_programs(spark) -> dict:
    """The JAX package's fits on its 4-device CPU mesh, as arrays laid
    out as `_programs`'."""
    import pandas as pd
    from sml_tpu.ml import linear_impl as jlin
    from sml_tpu.ml.clustering import KMeans as JKMeans
    from sml_tpu.ml.feature import VectorAssembler as JVA
    from sml_tpu.ml.recommendation import ALS as JALS
    from sml_tpu.parallel import mesh as jmesh
    out = {}
    X, y = _dense()
    parts, yp = _parts("jax")
    with jmesh.use_mesh(jmesh.build_mesh(4)):
        A, b, n, yy = jlin.gram_stats(*_integer())
        out["gram_int"] = np.concatenate([A.ravel(), b, [n, yy]])
        for key, kw in (("ridge", dict(regParam=0.1)),
                        ("enet", dict(regParam=0.1, elasticNetParam=0.5))):
            fit = jlin.fit_linear(X, y, **kw)
            out[key] = np.concatenate([fit.coefficients, [fit.intercept]])
        fit = jlin.fit_logistic(X, _binary(y), tol=LOGIT_TOL)
        out["logistic"] = np.concatenate([fit.coefficients,
                                          [fit.intercept, fit.iterations]])
        fit = jlin.fit_logistic_compact(parts, _binary(yp),
                                        maxIter=LOGIT_ITERS)
        out["logistic_compact"] = np.concatenate(
            [fit.coefficients, [fit.intercept, fit.iterations]])
        blobs = _blobs()
        frame = JVA(inputCols=["x", "y"], outputCol="features").transform(
            spark.createDataFrame(pd.DataFrame({"x": blobs[:, 0],
                                                "y": blobs[:, 1]})))
        km = JKMeans(**KM).fit(frame)
        out["kmeans"] = np.concatenate([np.ravel(km._centers),
                                        [km._trainingCost]])
        users, items, rating = _ratings()
        m = JALS(**ALS_KW).fit(spark.createDataFrame(pd.DataFrame(
            {"user": users, "item": items, "rating": rating})))
        out["als"] = np.concatenate([np.ravel(m._uf), np.ravel(m._if)])
    return out


@pytest.fixture(scope="module")
def jax_runs(spark):
    return _jax_programs(spark)


def test_one_rank_matches_the_jax_four_device_mesh(runs, jax_runs):
    """Rank 0 of the one-rank layout against the JAX package's fits on
    `build_mesh(4)`, within the tolerances the one-device port tests
    hold: integer Gram moments bit-equal; linear coefficients 2e-6 of
    max(1, |w|); IRLS 1e-5 with equal steps (compact 5e-4: its step
    counts differ between the packages, whose f32 sums keep w moving,
    `tests/test_torch_compact_linear.py`); KMeans centers 5e-6 of the
    largest coordinate, cost rtol 2e-5; ALS factors 5e-5."""
    got = runs[1][0][0]
    np.testing.assert_array_equal(got["flat_gram_int"], jax_runs["gram_int"])
    for key in ("ridge", "enet"):
        want = jax_runs[key]
        scale = np.maximum(1.0, np.abs(want))
        assert np.max(np.abs(got["flat_" + key] - want) / scale) <= 2e-6
    for key, tol in (("logistic", 1e-5), ("logistic_compact", 5e-4)):
        want, mine = jax_runs[key], got["flat_" + key]
        if key == "logistic":
            assert mine[-1] == want[-1]
        np.testing.assert_allclose(mine[:-1], want[:-1], rtol=0, atol=tol)
    want, mine = jax_runs["kmeans"], got["flat_kmeans"]
    np.testing.assert_allclose(mine[:-1], want[:-1], rtol=0,
                               atol=5e-6 * np.abs(want[:-1]).max())
    assert mine[-1] == pytest.approx(want[-1], rel=2e-5)
    np.testing.assert_allclose(got["flat_als"], jax_runs["als"], rtol=0,
                               atol=5e-5)


def test_ranks_given_different_rows_raise(runs):
    assert [r["mismatch_raised"].tolist() for r in runs[2][0]] == \
        [[1, 1], [1, 1]]


@pytest.fixture(scope="module")
def host_reference():
    """The port's programs under `sml.dispatch.mode=host`, asked for a
    stub card outside any mesh: the one-device host route."""
    import torch

    from sml_tpu_torch import GLOBAL_CONF
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    GLOBAL_CONF.set("sml.dispatch.mode", "host")
    GLOBAL_CONF.set("sml.device", "cuda:0")
    try:
        return _programs(torch.device("cuda", 0))
    finally:
        torch.cuda.is_available = real
        GLOBAL_CONF.unset("sml.device")
        GLOBAL_CONF.unset("sml.dispatch.mode")


def test_host_route_under_a_mesh_is_the_one_device_host_route(
        runs, host_reference):
    """Under a stub card's mesh of 2 ranks `sml.dispatch.mode=host` runs
    every fit and evaluation on the CPU over all the rows, with no
    collective, and gives the one-device host route's bits."""
    for res in runs[2][0]:
        assert res["host_collectives"][0] == 0
        for name, want in host_reference.items():
            np.testing.assert_array_equal(res["host_" + name], want,
                                          err_msg=name)


@pytest.mark.parametrize("n,layout", LAYOUTS)
def test_prewarm_entries_carry_the_mesh_and_skip_elsewhere(runs, n, layout):
    """An entry recorded over a mesh is keyed by its width and host
    groups, replays over that mesh, and is skipped outside it (the port
    counterpart of `tests/test_multichip.py:354-382`)."""
    from sml_tpu_torch import GLOBAL_CONF
    from sml_tpu_torch.parallel import prewarm as pw
    groups = 2 if layout == "hosts" else 1
    for res in runs[n][0]:
        assert res[f"{layout}_prewarm_sig"].tolist() == [[1, n, groups]]
        assert res[f"{layout}_prewarm_here"].tolist() == [1]
    foreign = int(n > 1)   # a one-rank mesh is keyed as no mesh
    prev = GLOBAL_CONF.get("sml.compile.cacheDir")
    GLOBAL_CONF.set("sml.compile.cacheDir", str(runs[n][2] / layout))
    pw.reset()
    try:
        stats = pw.prewarm(device="cpu")
    finally:
        GLOBAL_CONF.set("sml.compile.cacheDir", prev)
        pw.reset()
    assert stats["programs"] == 1 - foreign
    assert stats["skipped"] == foreign


def test_row_blocks_are_each_rank_s_block_of_the_jax_host_mesh(spark, runs):
    """`host_row_blocks` on rank r of 4 (2 host groups) gives the one
    block r addresses, in its group; joined over the ranks they are the
    JAX package's `host_row_blocks` of the same rows sharded on
    `host_mesh(2)` over 4 devices. Flat, every rank's group is 0."""
    import jax
    from sml_tpu.parallel import mesh as jmesh
    arr = np.arange(40 * 3).reshape(40, 3)
    hm = jmesh.host_mesh(2, mesh=jmesh.build_mesh(4))
    sharded = jax.device_put(arr, jmesh.data_sharding(hm))
    want = [(g, np.asarray(blk).ravel().tolist())
            for g, pairs in jmesh.host_row_blocks(sharded, hm)
            for _, blk in pairs]
    got = [(int(row[0]), row[2:].tolist())
           for res in runs[4][0] for row in res["hosts_row_blocks"]]
    assert got == want
    for res in runs[4][0]:
        assert res["hosts_row_blocks"][0][1] == 1   # the rank's device
    assert [int(r["flat_row_blocks"][0][0]) for r in runs[4][0]] == [0] * 4
    whole = runs[1][0][0]["flat_row_blocks"]
    assert whole[0][2:].tolist() == arr.ravel().tolist()
