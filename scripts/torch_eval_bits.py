"""Print the port's one-device evaluation statistics and linear moments of
a checkout, on the CPU, to compare their bits across two checkouts.

    python3 scripts/torch_eval_bits.py [ROOT]

ROOT is a checkout of this repository (the current one by default), for
example a parent commit unpacked with `git archive`. It prints phase 12's
fused CrossValidator avgMetrics (100,000 rows), the device route's
regression statistics and accuracy on 50,000 seeded rows, the fused
predict+eval statistics of a decision tree on 30,000 rows (identity and
exp link), and a digest of the Gram moments and of an IRLS fit. Run it on
both checkouts and compare the lines.
"""

import hashlib
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def report(cpu: torch.device) -> None:
    import chip_smoke as cs
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml import _tree_models as ptm
    from sml_tpu_torch.ml import evaluation as pev
    from sml_tpu_torch.ml import linear_impl as li
    from sml_tpu_torch.ml._tree_models import DecisionTreeRegressor
    train, _ = cs.sel_frames(100_000)
    feat = Pipeline(stages=cs.sel_prep()).fit(train).transform(train)
    feat.cache()
    rf = cs.sel_rf()
    cvm = cs.sel_cv(rf, cs.sel_grid(rf), 4).fit(feat)
    print("cv avgMetrics", [repr(float(m)) for m in cvm.avgMetrics])
    rng = np.random.default_rng(3)
    pred = rng.normal(100, 30, 50_000)
    lab = pred + rng.normal(0, 10, 50_000)
    print("reg_stats", [repr(v) for v in pev.reg_stats(pred, lab, cpu)])
    guess = np.round(rng.uniform(0, 3, 50_000))
    cls = np.where(rng.uniform(size=50_000) < 0.7, guess, 0)
    print("accuracy", repr(pev._accuracy(guess, cls, cpu)))
    X = rng.normal(size=(30_000, 5))
    y = X[:, 0] * 2 + rng.normal(0, 0.3, 30_000)
    spec = DecisionTreeRegressor(maxDepth=5, maxBins=32).fit(
        X, y, device=cpu)._spec
    print("fused", [repr(v) for v in ptm.fused_reg_stats_from_matrix(
        spec, X, y, device=cpu)])
    print("fused exp", [repr(v) for v in ptm.fused_reg_stats_from_matrix(
        spec, X, np.exp(y / 10), link="exp", device=cpu)])
    A, b, n, yy = li.gram_stats(X.astype(np.float32), y.astype(np.float32),
                                device=cpu)
    fit = li.fit_logistic(X.astype(np.float32), (y > 0).astype(np.float32),
                          device=cpu)
    print("gram", hashlib.sha1(A.tobytes() + b.tobytes()).hexdigest(),
          repr(n), repr(yy), "irls",
          hashlib.sha1(fit.coefficients.tobytes()).hexdigest(),
          fit.iterations)


def main() -> None:
    from sml_tpu_torch.device import use_device_local
    cpu = torch.device("cpu")
    with use_device_local(cpu):   # the DataFrame entry points' device
        report(cpu)


if __name__ == "__main__":
    main()
