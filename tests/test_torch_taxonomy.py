"""The port's name taxonomy (`sml_tpu_torch/obs/taxonomy.py`), enforced
by the port's lint rule `obs-taxonomy` (`sml_tpu_torch/lint/rules/
taxonomy.py`, loaded standalone by path as `scripts/torch_lint.py` loads
it; the JAX package's is enforced by its own lint, tests/test_obs_taxonomy.py,
which reads only `sml_tpu/`).

Every `PROFILER.span/count`, `RECORDER.emit/counter/gauge` (also as
`_OBS`) and `METRICS.observe` (also as `_METRICS`) call site must name a
registered name: a literal exactly or under a `prefix.*` wildcard, an
f-string by a literal prefix under a wildcard; a computed name is legal
only inside `obs/` and `utils/profiler.py`, which forward names checked
where they start. Every kernel wrapper's launch counter (`LAUNCHES`) is
a registered kernel name, and a rogue name is caught.
"""

import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def lint():
    spec = importlib.util.spec_from_file_location(
        "_torch_lint_taxonomy_runner",
        os.path.join(REPO, "scripts", "torch_lint.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    return runner.load_linter()


@pytest.fixture(scope="module")
def rule(lint):
    import sys
    return sys.modules["torchlint.rules.taxonomy"]


@pytest.fixture(scope="module")
def taxonomy(rule):
    """Loaded by path: the registry is pure data."""
    return rule.load_taxonomy(REPO)


def check_source(rule, text, rel, taxonomy, internal):
    return rule.check_source(text, rel, taxonomy, internal)


def test_port_is_taxonomy_clean(lint):
    report = lint.run(project=lint.Project.from_root(REPO),
                      rule_names=["obs-taxonomy"])
    assert report.clean, report.format()


def test_checker_catches_rogue_names(rule, taxonomy):
    bad = (
        "PROFILER.count('staging.h2dBytes')\n"              # drifted name
        "PROFILER.count('staging.h2d_bytes')\n"             # registered
        "with PROFILER.span(f'mystery.{x}'):\n    pass\n"   # rogue family
        "RECORDER.emit('cache', name_var)\n"                # computed
        "_OBS.gauge('hbm.bin_cache_bytes', 1)\n"            # registered
        "_METRICS.observe('serve.latency', 1.0)\n")         # unregistered
    violations = check_source(rule, bad, "rogue.py", taxonomy, internal=False)
    msgs = "\n".join(m for _, _, m in violations)
    assert len(violations) == 4, msgs
    assert "staging.h2dBytes" in msgs and "mystery." in msgs
    assert "computed" in msgs and "serve.latency" in msgs
    # the same computed name is legal inside obs/
    assert check_source(rule, "RECORDER.emit('cache', name_var)\n",
                        "obs/x.py", taxonomy, internal=True) == []


def test_kernel_launch_counters_are_registered(lint, rule, taxonomy):
    from sml_tpu_torch.native import hist_kernel, prng_kernel
    counted = set(hist_kernel.LAUNCHES) | set(prng_kernel.LAUNCHES) \
        | {"forest_traverse"}
    assert counted == taxonomy.KERNEL_LAUNCHES
    # the rule reads the same counters from the source
    assert set(rule.launch_counters(lint.Project.from_root(REPO))) \
        == counted
    assert taxonomy.is_registered("launch", "split_scan")
    assert not taxonomy.is_registered("launch", "index_add")


def test_wildcards_and_the_ports_own_names(taxonomy):
    t = taxonomy
    assert t.is_registered("span", "program.tree_ensemble")
    assert t.is_registered("span", "staging.fit")
    assert t.is_registered("span", "binning.fit")
    assert t.is_registered("count", "infer.dispatch")
    assert t.is_registered("count", "compile.program.hist_accumulate")
    assert t.is_registered("gauge", "hbm.chunk_stage_bytes")
    assert t.is_registered("emit", "drift.report")
    assert t.is_registered("observe", "serve.request_ms")
    assert not t.is_registered("count", "staging.h2dBytes")
    assert t.prefix_registered("span", "program.")
    assert not t.prefix_registered("span", "mystery.")
