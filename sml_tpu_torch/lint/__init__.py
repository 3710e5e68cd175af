"""torchlint: the port's own static checks over `sml_tpu_torch/`,
`chip_smoke.py` and `scripts/torch_*.py`.

The port has invariants no runtime test checks cheaply: kernel
libraries load and launch only in `native/`, with no `torch.compile`
beside them; hot dispatch paths do not sync the card stray-wise; every
conf literal is registered; obs names match the taxonomy; timings come
from the profiler's clock; collectives name declared axes, run where a
mesh is held and never under a rank-local branch; a rank's randomness
is sliced, never folded; and state shared between the port's threads
follows a lock or snapshot discipline (`threads.py`). Each is an AST
rule with per-line pragmas and a reviewed baseline, enforced by
`tests/test_torch_lint_clean.py` and by `chip_smoke.py`'s lint phase.
It is the JAX package's lint (`sml_tpu/lint/`) carried over where its
rules mean something for eager torch (`regions.py` says what was left
out).

Run it:            python3 scripts/torch_lint.py
Suppress a line:   # torchlint: disable=<rule> -- <reason>
Carry a debt:      sml_tpu_torch/lint/baseline.json (reviewed reasons)

This package is stdlib-only and is loaded STANDALONE by the runner
(importlib by path, package name "torchlint"), so a lint run imports
none of torch, jax, `sml_tpu` or the rest of `sml_tpu_torch`: keep every
import in here relative.
"""

from .core import META_RULES, RULES, Rule, Violation, rule  # noqa: F401
from .project import Project  # noqa: F401
from . import rules as _rules  # noqa: F401  (registers the built-ins)
from .engine import Report, run  # noqa: F401

__all__ = ["run", "Report", "Project", "Violation", "Rule", "rule",
           "RULES", "META_RULES"]
