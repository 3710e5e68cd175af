"""The port's name taxonomy (`sml_tpu_torch/obs/taxonomy.py`), enforced
by an AST pass over `sml_tpu_torch/` (the JAX package's is enforced by
its lint, tests/test_obs_taxonomy.py, which reads only `sml_tpu/`).

Every `PROFILER.span/count`, `RECORDER.emit/counter/gauge` (also as
`_OBS`) and `METRICS.observe` (also as `_METRICS`) call site must name a
registered name: a literal exactly or under a `prefix.*` wildcard, an
f-string by a literal prefix under a wildcard; a computed name is legal
only inside `obs/` and `utils/profiler.py`, which forward names checked
where they start. Every kernel wrapper's launch counter (`LAUNCHES`) is
a registered kernel name, and a rogue name is caught.
"""

import ast
import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "sml_tpu_torch")

# receiver -> {method: (index of the name argument, taxonomy kind)}
TARGETS = {
    "PROFILER": {"span": (0, "span"), "count": (0, "count")},
    "RECORDER": {"emit": (1, "emit"), "counter": (0, "counter"),
                 "gauge": (0, "gauge")},
    "_OBS": {"emit": (1, "emit"), "counter": (0, "counter"),
             "gauge": (0, "gauge")},
    "METRICS": {"observe": (0, "observe")},
    "_METRICS": {"observe": (0, "observe")},
}


@pytest.fixture(scope="module")
def taxonomy():
    """Loaded by path: the registry is pure data."""
    path = os.path.join(PKG, "obs", "taxonomy.py")
    spec = importlib.util.spec_from_file_location("_pt_taxonomy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _receiver(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _prefix(node: ast.JoinedStr) -> str:
    out = ""
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            out += part.value
        else:
            break
    return out


def check_source(text, rel, taxonomy, internal):
    out = []
    for node in ast.walk(ast.parse(text, filename=rel)):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        methods = TARGETS.get(_receiver(node.func.value))
        if methods is None or node.func.attr not in methods:
            continue
        idx, kind = methods[node.func.attr]
        if len(node.args) <= idx:
            continue
        arg = node.args[idx]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if not taxonomy.is_registered(kind, arg.value):
                out.append((rel, node.lineno,
                            f"unregistered {kind} name {arg.value!r}"))
        elif isinstance(arg, ast.JoinedStr):
            if not taxonomy.prefix_registered(kind, _prefix(arg)):
                out.append((rel, node.lineno,
                            f"unregistered dynamic {kind} family "
                            f"{_prefix(arg)!r}"))
        elif not internal:
            out.append((rel, node.lineno, f"computed {kind} name"))
    return out


def check_tree(taxonomy):
    out = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, REPO).replace(os.sep, "/")
            internal = "/obs/" in rel or rel.endswith("utils/profiler.py")
            with open(path, encoding="utf-8") as fh:
                out.extend(check_source(fh.read(), rel, taxonomy, internal))
    return out


def test_port_is_taxonomy_clean(taxonomy):
    violations = check_tree(taxonomy)
    assert violations == [], "\n".join(
        f"{f}:{ln}: {msg}" for f, ln, msg in violations)


def test_checker_catches_rogue_names(taxonomy):
    bad = (
        "PROFILER.count('staging.h2dBytes')\n"              # drifted name
        "PROFILER.count('staging.h2d_bytes')\n"             # registered
        "with PROFILER.span(f'mystery.{x}'):\n    pass\n"   # rogue family
        "RECORDER.emit('cache', name_var)\n"                # computed
        "_OBS.gauge('hbm.bin_cache_bytes', 1)\n"            # registered
        "_METRICS.observe('serve.latency', 1.0)\n")         # unregistered
    violations = check_source(bad, "rogue.py", taxonomy, internal=False)
    msgs = "\n".join(m for _, _, m in violations)
    assert len(violations) == 4, msgs
    assert "staging.h2dBytes" in msgs and "mystery." in msgs
    assert "computed" in msgs and "serve.latency" in msgs
    # the same computed name is legal inside obs/
    assert check_source("RECORDER.emit('cache', name_var)\n", "obs/x.py",
                        taxonomy, internal=True) == []


def test_kernel_launch_counters_are_registered(taxonomy):
    from sml_tpu_torch.native import hist_kernel, prng_kernel
    counted = set(hist_kernel.LAUNCHES) | set(prng_kernel.LAUNCHES) \
        | {"forest_traverse"}
    assert counted == taxonomy.KERNEL_LAUNCHES
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
