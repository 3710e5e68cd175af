"""The host route's bits against the JAX package's host route, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_host_route_diff.py

The port's `DeviceScorer.score_block_host` runs the C++ host traversal,
which gives the card's bits (per tree, in tree order, each f32 product
and sum rounded); the JAX package's host route sums the trees with XLA's
f32 `tensordot` and `mean` on its host mesh. This fits five ensembles
with the JAX package (the shapes of `tests/test_torch_host_route.py`,
plus ML 11's 40 trees of depth 6 and ML 07's 20 of depth 6), carries
each into the port, scores 5,000 rows on both host routes and prints how
many rows differ and by how much.
"""

import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sml_tpu.ml._tree_models import _fit_ensemble
    from sml_tpu.ml.inference import DeviceScorer as JaxScorer
    from sml_tpu_torch.ml.inference import DeviceScorer
    from test_torch_host_route import _carry, _data
    X, y = _data()
    y32 = y.astype(np.float32)
    yb = (y > np.median(y)).astype(np.float32)
    common = dict(categorical={}, max_bins=32, min_instances=1,
                  min_info_gain=0.0, seed=5)
    boosted = dict(feature_k=None, bootstrap=False, subsample=1.0,
                   boosting=True)
    forest = dict(feature_k=3, bootstrap=True, subsample=1.0)
    specs = {
        "rf 5 x depth 4": _fit_ensemble(X, y32, max_depth=4, n_trees=5,
                                        loss="squared", **forest, **common),
        "gbt 30 x depth 5": _fit_ensemble(X, y32, max_depth=5, n_trees=30,
                                          loss="squared", reg_lambda=1.0,
                                          **boosted, **common),
        "ML 11 gbt 40 x depth 6": _fit_ensemble(
            X, y32, max_depth=6, n_trees=40, loss="squared",
            reg_lambda=1.0, **boosted, **common),
        "ML 07 rf 20 x depth 6": _fit_ensemble(
            X, y32, max_depth=6, n_trees=20, loss="squared", **forest,
            **common),
        "binary gbt 5 x depth 3": _fit_ensemble(
            X, yb, max_depth=3, n_trees=5, loss="logistic", **boosted,
            **common),
    }
    Xt, _ = _data(n=5000, seed=9)
    for name, spec in specs.items():
        want = JaxScorer(types.SimpleNamespace(_spec=spec)).score_block_host(
            Xt)
        got = DeviceScorer(types.SimpleNamespace(_spec=_carry(spec)),
                           device="cpu").score_block_host(Xt)
        diff = np.abs(got - want)
        print(f"{name}: {int((diff > 0).sum())} of {len(diff)} rows differ, "
              f"max |diff| {float(diff.max())!r}, "
              f"{float(diff.max() / np.abs(want).max())!r} of the largest "
              f"|prediction|")


if __name__ == "__main__":
    main()
