"""The committed tree passes the port's lint, the runner keeps its
contract, and the conf registry the lint holds the port against.

- `scripts/torch_lint.py` exits 0 on the committed tree with its 11
  rules, from a cold interpreter that imports none of torch, jax,
  sml_tpu or sml_tpu_torch; its JSON carries every rule's wall and the
  suppressed findings with their status; every single-rule run is
  clean; the exit codes are 0 clean, 1 violations, 2 usage or internal
  error (a crashing rule included); `--changed-only` filters the report
  and `--update-baseline` keeps the reviewed reasons. `chip_smoke.py`'s
  phase 25 (the lint under `-X importtime`) runs here as on the card,
  and its phase 26 (the pandas function API) with pandas installed.
- `sml_tpu_torch/conf.py`: `registered_keys()` and `describe()` have the
  reference's shapes, the registries differ by exactly the keys
  ROADMAP.md section 1 lists, and a fresh conf reads the course keys as
  "" in both packages (on the parent the port's `get` raised
  `KeyError`).
"""

import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RUNNER = os.path.join(REPO, "scripts", "torch_lint.py")
FORBIDDEN = ("torch", "jax", "sml_tpu", "sml_tpu_torch")
RULES = ("collective-axis-discipline", "conf-key-registry",
         "divergent-collective", "host-sync-in-hot-path",
         "kernel-launch-outside-native", "lock-order",
         "no-wallclock-in-engine", "obs-taxonomy", "per-chip-key-fold",
         "race-check-then-use", "race-unguarded-shared-write")


def _runner(name="_torch_lint_runner"):
    spec = importlib.util.spec_from_file_location(name, RUNNER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _copy_tree(dst, conf_text=None):
    """The lint's targets and evidence, copied under `dst` (the built
    libraries and caches left out); `conf_text` replaces conf.py."""
    ignore = shutil.ignore_patterns("__pycache__", "build")
    shutil.copytree(os.path.join(REPO, "sml_tpu_torch"),
                    dst / "sml_tpu_torch", ignore=ignore)
    os.makedirs(dst / "scripts")
    os.makedirs(dst / "tests")
    for folder, prefix in (("scripts", "torch_"), ("tests", "test_torch_")):
        for f in os.listdir(os.path.join(REPO, folder)):
            if f.startswith(prefix) and f.endswith(".py"):
                shutil.copy(os.path.join(REPO, folder, f), dst / folder / f)
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst / "chip_smoke.py")
    if conf_text is not None:
        (dst / "sml_tpu_torch" / "conf.py").write_text(conf_text)


def test_torch_lint_clean_and_standalone():
    """One cold interpreter: exit 0 with the 11 rules, and none of the
    forbidden packages loaded (the probe raises before exiting)."""
    probe = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('_t', {RUNNER!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "rc = m.main(['--json'])\n"
        f"bad = [k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'torchlint.threads' in sys.modules\n"
        "assert 'torchlint.regions' in sys.modules\n"
        "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr
    payload = json.loads(out.stdout)
    assert payload["clean"] is True and payload["violations"] == []
    assert tuple(payload["rules"]) == RULES
    assert set(payload["rule_times"]) == set(RULES)
    assert all(t >= 0 for t in payload["rule_times"].values())
    statuses = [sv["status"] for sv in payload["suppressed_violations"]]
    assert set(statuses) == {"pragma", "baseline"}
    assert statuses.count("pragma") == payload["suppressed"]["pragma"]
    assert statuses.count("baseline") == payload["suppressed"]["baseline"]


def test_phase_25_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 25 as the card's machine runs it: the
    runner under `-X importtime`, exit 0, nothing forbidden imported."""
    import chip_smoke
    out = chip_smoke.phase_lint("cpu")
    assert out["rules"] == len(RULES)
    assert out["suppressed_pragma"] > 0 and out["suppressed_baseline"] > 0
    assert out["wall_s"] > 0 and out["modules_imported"] > 0


def test_phase_26_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 26 with pandas installed: the
    pandas-free imports, the conf keys, ML 12's `mapInPandas` and
    `pandas_udf` with a `DeviceScorer` inside (one traversal a batch,
    bit-equal to `score_block`), ML 13's `applyInPandas`, ML 14's
    operations and the return path, on the CPU (the traversal's plain
    version counted as its launch)."""
    import torch
    import chip_smoke
    from sml_tpu_torch import GLOBAL_CONF
    from sml_tpu_torch.native import traverse_kernel as tk
    plain = tk.forest_margin_plain

    def counted(*a, **k):
        tk.LAUNCHES += 1
        return plain(*a, **k)

    monkeypatch.setattr(tk, "forest_margin_plain", counted)
    GLOBAL_CONF.set("sml.device", "cpu")
    try:
        out = chip_smoke.phase_pandas(0, torch.device("cpu"), "cpu")
    finally:
        GLOBAL_CONF.unset("sml.device")
    assert out["pandas"] is True and out["a"]["loaded"] == []
    assert out["b"]["alias_moves_key"] is True
    assert out["c"]["mapInPandas"]["launches"] == out["c"]["batches"] > 8
    assert out["c"]["pandas_udf"]["launches"] == out["c"]["batches"]
    assert out["c"]["applyInPandas"]["groups"] == 3
    assert out["launches"]["forest_traverse"] == 2 * out["c"]["batches"] + 2
    assert out["d"]["len"] == out["d"]["shape"][0] > 0
    assert out["launches"]["hist_accumulate"] == 0


@pytest.fixture(scope="module")
def tree():
    """The linter and one parse of the committed tree (the rules'
    analyses are memoized on it)."""
    lint = _runner().load_linter()
    return lint, lint.Project.from_root(REPO)


@pytest.mark.parametrize("rule", RULES)
def test_single_rule_run_is_clean(tree, rule):
    """A one-rule run is clean on the committed tree: the suppressions
    the other rules own are not judged."""
    lint, project = tree
    report = lint.run(project=project, rule_names=[rule])
    assert report.clean, report.format()


def test_runner_rule_flag_is_clean():
    out = subprocess.run([sys.executable, RUNNER, "--rule",
                          "conf-key-registry"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_exit_code_contract(tmp_path, capsys, monkeypatch):
    m = _runner("_torch_lint_contract")
    assert m.main([]) == 0
    assert m.main(["--rule", "no-such-rule"]) == 2
    assert m.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(r in listed for r in RULES)
    os.makedirs(tmp_path / "sml_tpu_torch")
    (tmp_path / "sml_tpu_torch" / "a.py").write_text(
        "import time\nt = time.time()\n")
    assert m.main(["--root", str(tmp_path)]) == 1
    assert "no-wallclock-in-engine" in capsys.readouterr().out
    lint = m.load_linter()

    def crash(project):
        raise RuntimeError("boom")

    monkeypatch.setitem(lint.RULES, "obs-taxonomy",
                        lint.Rule("obs-taxonomy", "", crash))
    assert m.main(["--root", str(tmp_path)]) == 2
    assert "internal error" in capsys.readouterr().err
    bad = subprocess.run([sys.executable, RUNNER, "--rule", "bogus"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode == 2


def test_changed_only_mode():
    out = subprocess.run([sys.executable, RUNNER, "--changed-only", "HEAD",
                          "--json"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["clean"] is True and payload["changed_only"] == "HEAD"
    assert tuple(payload["rules"]) == RULES
    bad = subprocess.run([sys.executable, RUNNER, "--changed-only",
                          "no-such-ref-xyz"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode == 2 and "--changed-only" in bad.stderr


def test_changed_only_filters_to_changed_files(tmp_path):
    if shutil.which("git") is None:
        pytest.skip("git unavailable")
    shutil.copytree(os.path.join(REPO, "sml_tpu_torch", "lint"),
                    tmp_path / "sml_tpu_torch" / "lint",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(tmp_path / "scripts")
    shutil.copy(RUNNER, tmp_path / "scripts" / "torch_lint.py")
    os.makedirs(tmp_path / "sml_tpu_torch" / "obs")
    shutil.copy(os.path.join(REPO, "sml_tpu_torch", "obs", "taxonomy.py"),
                tmp_path / "sml_tpu_torch" / "obs" / "taxonomy.py")
    (tmp_path / "sml_tpu_torch" / "old.py").write_text(
        "import time\nT0 = time.time()\n")
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")

    def git(*args):
        subprocess.run(["git", *args], cwd=tmp_path, check=True, env=env,
                       capture_output=True, timeout=60)

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    (tmp_path / "sml_tpu_torch" / "new.py").write_text(
        "import time\nT1 = time.time()\n")
    runner = str(tmp_path / "scripts" / "torch_lint.py")
    full = subprocess.run([sys.executable, runner, "--json"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert full.returncode == 1
    paths = {v["path"] for v in json.loads(full.stdout)["violations"]}
    assert {"sml_tpu_torch/old.py", "sml_tpu_torch/new.py"} <= paths
    part = subprocess.run([sys.executable, runner, "--changed-only", "HEAD",
                           "--json"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert part.returncode == 1
    paths = {v["path"] for v in json.loads(part.stdout)["violations"]}
    assert "sml_tpu_torch/new.py" in paths
    assert "sml_tpu_torch/old.py" not in paths


def test_update_baseline_keeps_reviewed_reasons(tmp_path):
    """--update-baseline on a copy of the clean tree re-emits the
    committed entries with their reviewed reasons, and the rewritten
    baseline still passes."""
    _copy_tree(tmp_path)
    runner = str(tmp_path / "scripts" / "torch_lint.py")
    base = tmp_path / "sml_tpu_torch" / "lint" / "baseline.json"
    committed = json.loads(base.read_text())["entries"]
    assert committed and all(e["reason"] and not e["reason"].startswith(
        "TODO") for e in committed)
    out = subprocess.run([sys.executable, runner, "--update-baseline"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(base.read_text())["entries"] == committed
    again = subprocess.run([sys.executable, runner], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stdout + again.stderr


def _parent_conf_text():
    text = open(os.path.join(REPO, "sml_tpu_torch", "conf.py"),
                encoding="utf-8").read()
    out = re.sub(r'_register\("sml\.training\.(module-name|username)", '
                 r'"", str,\n(          "[^\n]*\n)+', "", text)
    assert out.count("sml.training.") == 0
    return out


def test_runner_flags_courseware_keys_on_the_parent_registry(tmp_path):
    """`--rule conf-key-registry` over the tree with the parent's conf.py
    flags courseware.py:84 and :90, the keys a fresh conf's get raised
    KeyError for."""
    _copy_tree(tmp_path, conf_text=_parent_conf_text())
    out = subprocess.run([sys.executable, str(tmp_path / "scripts" /
                                              "torch_lint.py"),
                          "--rule", "conf-key-registry", "--json"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1, out.stdout + out.stderr
    got = [(v["path"], v["line"]) for v in json.loads(out.stdout)[
        "violations"]]
    assert got == [("sml_tpu_torch/courseware.py", 84),
                   ("sml_tpu_torch/courseware.py", 90)]


# ---------------------------------------------------------------- the conf
REF_REGISTRARS = ("sml_tpu.conf", "sml_tpu.loadgen", "sml_tpu.obs.blackbox",
                  "sml_tpu.obs._watchdog", "sml_tpu.parallel.dispatch",
                  "sml_tpu.parallel.prewarm", "sml_tpu.ct",
                  "sml_tpu.serving", "sml_tpu.fleet")
PORT_REGISTRARS = ("sml_tpu_torch.conf", "sml_tpu_torch.loadgen",
                   "sml_tpu_torch.obs._watchdog",
                   "sml_tpu_torch.parallel.dispatch",
                   "sml_tpu_torch.parallel.prewarm", "sml_tpu_torch.ct",
                   "sml_tpu_torch.fleet")


def _modules_with_register(pkg):
    """Every module of a package that calls `_register(...)` at module
    level (an AST listing, so that a new late registrar is not missed)."""
    import ast
    out = set()
    root = os.path.join(REPO, pkg)
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path, encoding="utf-8").read())
            if any(isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                   and getattr(n.value.func, "id", None) == "_register"
                   for n in tree.body):
                rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                out.add(rel[:-len(".__init__")]
                        if rel.endswith(".__init__") else rel)
    return out


@pytest.fixture(scope="module")
def registries():
    assert _modules_with_register("sml_tpu") - {"sml_tpu.compat"} \
        == set(REF_REGISTRARS)
    assert _modules_with_register("sml_tpu_torch") == set(PORT_REGISTRARS)
    for name in REF_REGISTRARS + PORT_REGISTRARS:
        importlib.import_module(name)
    return (sys.modules["sml_tpu.conf"], sys.modules["sml_tpu_torch.conf"])


def _roadmap_keys(heading):
    """The backticked conf keys of the ROADMAP.md paragraph that starts
    with `heading` (up to the next blank line)."""
    text = open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8").read()
    start = text.index(heading)
    end = text.find("\n\n", start)
    return set(re.findall(r"`((?:sml|spark)\.[A-Za-z0-9_.\-]+)`",
                          text[start:end]))


def test_registry_difference_is_the_documented_list(registries):
    ref, port = registries
    ref_keys, port_keys = set(ref.registered_keys()), \
        set(port.registered_keys())
    assert ref_keys - port_keys == _roadmap_keys("**Conf keys left out**")
    assert port_keys - ref_keys == _roadmap_keys("**Conf keys the port "
                                                 "adds:**")
    assert list(port.registered_keys()) == sorted(port_keys)


def test_describe_has_the_reference_shape(registries):
    ref, port = registries
    got, want = port.describe(), ref.describe()
    assert list(got) == list(port.registered_keys())
    assert all(set(v) == {"default", "type", "doc"} for v in got.values())
    for key in set(got) & set(want):
        assert got[key]["type"] == want[key]["type"], key
    for key in ("sml.training.module-name", "sml.training.username"):
        assert got[key] == {"default": "", "type": "str",
                            "doc": want[key]["doc"]}


@pytest.mark.parametrize("key", ["sml.training.username",
                                 "sml.training.module-name"])
def test_fresh_conf_reads_the_course_keys(registries, key):
    """On the parent the port's fresh conf raised KeyError here; the
    reference returns the registered default, "", and so does the port
    now (and its black-box conf dump carries the key)."""
    ref, port = registries
    assert port.TorchConf().get(key) == ""
    assert ref.TpuConf().get(key) == ""
    assert port.TorchConf().asDict()[key] == ""
