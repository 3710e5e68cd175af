"""The port's lint (`sml_tpu_torch/lint/`, run by `scripts/torch_lint.py`)
held against the JAX package's (`sml_tpu/lint/`, `scripts/graftlint.py`).

Both linters are loaded standalone by path, as their runners load them
(package names "torchlint" and "graftlint"), so no test here imports
torch or jax on the lint side.

- Parity: each generic rule (conf-key-registry, no-wallclock-in-engine,
  obs-taxonomy, race-unguarded-shared-write, race-check-then-use,
  lock-order) and the pragma and baseline hygiene get the JAX package's
  fixtures (`tests/test_graftlint.py`'s cases), paths rewritten from
  `sml_tpu/` to `sml_tpu_torch/` and `# graftlint:` pragmas to
  `# torchlint:`; both linters must report the same (rule, line) set
  (the hygiene rules' names mapped), and the expected one.
- The port's own rules (host-sync-in-hot-path,
  kernel-launch-outside-native, collective-axis-discipline,
  divergent-collective, per-chip-key-fold): flagged and clean fixtures
  each.
- The thread-role map on the committed tree, and two reconstructions of
  faults the port had: the streaming trigger that counted its files
  processed before it appended their progress entry (the
  publish-order leg of race-check-then-use, which the JAX rule does not
  see), and `courseware.py`'s two unregistered conf keys.
"""

import importlib.util
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _load(script):
    spec = importlib.util.spec_from_file_location(
        "_runner_" + script.replace(".", "_"),
        os.path.join(REPO, "scripts", script))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    return runner.load_linter()


@pytest.fixture(scope="module")
def tlint():
    return _load("torch_lint.py")


@pytest.fixture(scope="module")
def glint():
    return _load("graftlint.py")


def run_on(lint, sources, rules=None, extra=None, **kw):
    project = lint.Project.from_sources(sources, extra=extra)
    return lint.run(project=project, rule_names=rules,
                    use_baseline=kw.pop("use_baseline", False), **kw)


def rules_fired(report):
    return sorted({v.rule for v in report.violations})


def lines(report):
    return sorted((v.rule, v.line) for v in report.violations)


# ------------------------------------------------------------------ parity
#: the hygiene rules' names in each linter
_META = {"graftlint-pragma": "pragma", "graftlint-baseline": "baseline",
         "torchlint-pragma": "pragma", "torchlint-baseline": "baseline"}


def _to_port(text):
    return text.replace("sml_tpu/", "sml_tpu_torch/") \
        .replace("graftlint:", "torchlint:")


def _pairs(report):
    return sorted((_META.get(v.rule, v.rule), v.line)
                  for v in report.violations)


def parity(glint, tlint, sources, rules, extra=None, baseline=None,
           tmp_path=None):
    """Run the JAX package's linter on `sources` and the port's on the
    same sources with their paths and pragmas rewritten; assert equal
    (rule, line) sets and return them."""
    kw_g, kw_t = {}, {}
    if baseline is not None:
        g_path, t_path = tmp_path / "g.json", tmp_path / "t.json"
        g_path.write_text(json.dumps({"entries": baseline}))
        t_path.write_text(_to_port(json.dumps({"entries": baseline})))
        kw_g = dict(use_baseline=True, baseline_path=str(g_path))
        kw_t = dict(use_baseline=True, baseline_path=str(t_path))
    g = run_on(glint, sources, rules=rules, extra=extra, **kw_g)
    t = run_on(tlint, {_to_port(k): _to_port(v) for k, v in sources.items()},
               rules=rules, extra=extra, **kw_t)
    assert _pairs(g) == _pairs(t), (g.format(), t.format())
    assert g.n_suppressed_pragma == t.n_suppressed_pragma
    assert g.n_suppressed_baseline == t.n_suppressed_baseline
    return _pairs(t)


CONF = ["conf-key-registry"]
_REGISTRY = ("def _register(k, d, c, doc=''):\n    pass\n"
             "_register('sml.alpha', 1, int)\n"
             "_register('sml.beta', 2, int)\n")
WALL = ["no-wallclock-in-engine"]
TAX = ["obs-taxonomy"]
RACEW = ["race-unguarded-shared-write"]
RACEC = ["race-check-then-use"]
ORDER = ["lock-order"]

_RACEW_POS = (
    "import threading\n"
    "class Pump:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._n = 0\n"
    "    def start(self):\n"
    "        threading.Thread(target=self._loop).start()\n"
    "    def _loop(self):\n"
    "        self._n += 1\n"
    "    def bump(self):\n"
    "        self._n += 1\n")

#: a scorer whose prefetch threads null the attribute a caller checks
#: and then loads again (the JAX package's reconstruction)
_CHECK_USE_BUG = (
    "class Scorer:\n"
    "    def __init__(self):\n"
    "        import threading\n"
    "        self._done = threading.Event()\n"
    "        self._factorized = None\n"
    "    def prefetch(self, ex, batches):\n"
    "        for b in batches:\n"
    "            ex.submit(self._prep, b)\n"
    "    def _prep(self, b):\n"
    "        self._factorized = None\n"
    "    def score(self, X):\n"
    "        if self._factorized is None:\n"
    "            raise KeyError('cold scorer')\n"
    "        return self._factorized.transform(X)\n")

_CHECK_USE_FIXED = _CHECK_USE_BUG.replace(
    "        if self._factorized is None:\n"
    "            raise KeyError('cold scorer')\n"
    "        return self._factorized.transform(X)\n",
    "        fact = self._factorized\n"
    "        if fact is None:\n"
    "            raise KeyError('cold scorer')\n"
    "        return fact.transform(X)\n")

_LOCKED = (
    "import threading\n"
    "class Pump:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._n = 0\n"
    "    def start(self):\n"
    "        threading.Thread(target=self._loop).start()\n"
    "    def _loop(self):\n"
    "        with self._lock:\n"
    "            self._n += 1\n"
    "    def bump(self):\n"
    "        with self._lock:\n"
    "            self._n += 1\n")

_HELPER_LOCKED = (
    "import threading\n"
    "class Pump:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._n = 0\n"
    "    def start(self):\n"
    "        threading.Thread(target=self._loop).start()\n"
    "    def _loop(self):\n"
    "        with self._lock:\n"
    "            self._bump_locked()\n"
    "    def bump(self):\n"
    "        with self._lock:\n"
    "            self._bump_locked()\n"
    "    def _bump_locked(self):\n"
    "        self._n += 1\n")

_PUBLISH_SNAPSHOT = (
    "import threading\n"
    "class Pub:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._cur = None\n"
    "    def start(self):\n"
    "        threading.Thread(target=self._loop).start()\n"
    "    def _loop(self):\n"
    "        self._cur = object()\n"
    "    def read(self):\n"
    "        cur = self._cur\n"
    "        return cur\n")

_CONFINED = (
    "import threading\n"
    "class Builder:\n"
    "    def mode(self, m):\n"
    "        self._mode = m\n"
    "        return self\n"
    "    def save(self):\n"
    "        if self._mode:\n"
    "            return self._mode\n"
    "def run():\n"
    "    Builder().mode('x').save()\n"
    "def spin():\n"
    "    threading.Thread(target=run).start()\n")

_READ_UNDER_LOCK = (
    "import threading\n"
    "class Svc:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._obj = None\n"
    "    def start(self):\n"
    "        threading.Thread(target=self._loop).start()\n"
    "    def _loop(self):\n"
    "        with self._lock:\n"
    "            self._obj = object()\n"
    "    def use(self):\n"
    "        with self._lock:\n"
    "            if self._obj is not None:\n"
    "                return self._obj\n")

_SINGLE_ROLE = (
    "import threading\n"
    "class Svc:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._obj = None\n"
    "    def start(self):\n"
    "        threading.Thread(target=self._loop).start()\n"
    "    def _loop(self):\n"
    "        self._obj = object()\n"
    "        if self._obj is not None:\n"
    "            return self._obj\n")

_ABBA = (
    "import threading\n"
    "_a = threading.Lock()\n"
    "_b = threading.Lock()\n"
    "def one():\n"
    "    with _a:\n"
    "        with _b:\n"
    "            pass\n"
    "def two():\n"
    "    with _b:\n"
    "        with _a:\n"
    "            pass\n")

_CLASS_MODULE_ABBA = (
    "import threading\n"
    "_m = threading.Lock()\n"
    "class Svc:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def f(self):\n"
    "        with self._lock:\n"
    "            with _m:\n"
    "                pass\n"
    "    def g(self):\n"
    "        with _m:\n"
    "            with self._lock:\n"
    "                pass\n")

#: (name, sources, extra, rules, expected (rule, line) pairs)
PARITY_CASES = [
    ("conf-unregistered-near-miss",
     {"sml_tpu/conf.py": _REGISTRY,
      "sml_tpu/a.py": ("CONF.get('sml.alhpa')\n"
                       "CONF.set('sml.alpha', 2)\n"
                       "CONF.getInt('sml.beta')\n")},
     None, CONF, [("conf-key-registry", 1)]),
    ("conf-dead-key",
     {"sml_tpu/conf.py": _REGISTRY, "sml_tpu/a.py": "CONF.set('sml.alpha', 3)\n"},
     None, CONF, [("conf-key-registry", 4)]),
    ("conf-test-usage-is-evidence",
     {"sml_tpu/conf.py": _REGISTRY, "sml_tpu/a.py": "CONF.set('sml.alpha', 3)\n"},
     {"tests/test_x.py": "CONF.getBool('sml.beta')\n"}, CONF, []),
    ("conf-foreign-prefixes-ignored",
     {"sml_tpu/conf.py": _REGISTRY,
      "sml_tpu/a.py": ("CONF.get('sml.alpha')\n"
                       "CONF.set('sml.beta', 1)\n"
                       "CONF.set('com.databricks.training.x', 1)\n"
                       "opts.get('header', False)\n")},
     None, CONF, []),
    ("wallclock-flagged",
     {"sml_tpu/a.py": ("import time\n"
                       "from time import perf_counter\n"
                       "t0 = time.time()\n"
                       "t1 = perf_counter()\n")},
     None, WALL, [("no-wallclock-in-engine", 3),
                  ("no-wallclock-in-engine", 4)]),
    ("wallclock-owners-and-monotonic-exempt",
     {"sml_tpu/obs/r.py": "import time\nt = time.time()\n",
      "sml_tpu/utils/profiler.py": "import time\nt = time.time()\n",
      "sml_tpu/a.py": "import time\nt = time.monotonic()\n"},
     None, WALL, []),
    ("taxonomy-rogue-names",
     {"sml_tpu/rogue.py": ("PROFILER.count('staging.h2dBytes')\n"
                           "with PROFILER.span(f'mystery.{x}'):\n"
                           "    pass\n")},
     None, TAX, [("obs-taxonomy", 1), ("obs-taxonomy", 2)]),
    ("taxonomy-registered-and-obs-internal",
     {"sml_tpu/good.py": "PROFILER.count('staging.h2d_bytes')\n",
      "sml_tpu/obs/fwd.py": "RECORDER.emit('cache', name_var)\n"},
     None, TAX, []),
    ("pragma-suppresses-with-reason",
     {"sml_tpu/a.py": ("import time\n"
                       "t = time.time()  # graftlint: disable="
                       "no-wallclock-in-engine -- fixture needs a raw "
                       "clock\n")},
     None, WALL, []),
    ("pragma-comment-line-guards-next",
     {"sml_tpu/a.py": ("import time\n"
                       "# graftlint: disable=no-wallclock-in-engine -- "
                       "next-line form\n"
                       "t = time.time()\n")},
     None, WALL, []),
    ("pragma-without-reason",
     {"sml_tpu/a.py": ("import time\n"
                       "t = time.time()  # graftlint: disable="
                       "no-wallclock-in-engine\n")},
     None, WALL, [("pragma", 2)]),
    ("pragma-unused-and-unknown",
     {"sml_tpu/a.py": ("x = 1  # graftlint: disable=no-wallclock-in-engine"
                       " -- nothing here\n"
                       "y = 2  # graftlint: disable=not-a-rule -- typo\n")},
     None, WALL, [("pragma", 1), ("pragma", 2)]),
    ("pragma-foreign-rule-not-judged",
     {"sml_tpu/a.py": ("import time\n"
                       "t = time.time()  # graftlint: disable="
                       "no-wallclock-in-engine -- fixture\n")},
     None, ORDER, []),
    ("race-write-multi-role-unguarded", {"sml_tpu/a.py": _RACEW_POS}, None,
     RACEW, [("race-unguarded-shared-write", 9),
             ("race-unguarded-shared-write", 11)]),
    ("race-write-lock-guarded", {"sml_tpu/a.py": _LOCKED}, None, RACEW, []),
    ("race-write-helper-under-callers-lock",
     {"sml_tpu/a.py": _HELPER_LOCKED}, None, RACEW, []),
    ("race-write-publish-snapshot-reader",
     {"sml_tpu/a.py": _PUBLISH_SNAPSHOT}, None, RACEW, []),
    ("race-instance-confined-class",
     {"sml_tpu/a.py": _CONFINED}, None, RACEW + RACEC, []),
    ("race-write-pragma",
     {"sml_tpu/a.py": _RACEW_POS.replace(
         "        self._n += 1\n",
         "        self._n += 1  # graftlint: disable="
         "race-unguarded-shared-write -- fixture: ordered by Event\n")},
     None, RACEW, []),
    ("check-then-use-reload", {"sml_tpu/ml/scorer.py": _CHECK_USE_BUG},
     None, RACEC, [("race-check-then-use", 14)]),
    ("check-then-use-snapshot-fix", {"sml_tpu/ml/scorer.py": _CHECK_USE_FIXED},
     None, RACEC + RACEW, []),
    ("check-then-use-under-writers-lock",
     {"sml_tpu/a.py": _READ_UNDER_LOCK}, None, RACEC, []),
    ("check-then-use-single-role", {"sml_tpu/a.py": _SINGLE_ROLE}, None,
     RACEC, []),
    ("lock-order-abba", {"sml_tpu/a.py": _ABBA}, None, ORDER,
     [("lock-order", 6), ("lock-order", 10)]),
    ("lock-order-consistent",
     {"sml_tpu/a.py": _ABBA.replace("    with _b:\n        with _a:\n",
                                    "    with _a:\n        with _b:\n")},
     None, ORDER, []),
    ("lock-order-class-and-module-locks",
     {"sml_tpu/a.py": _CLASS_MODULE_ABBA}, None, ORDER,
     [("lock-order", 8), ("lock-order", 12)]),
]


@pytest.mark.parametrize("name, sources, extra, rules, expected",
                         PARITY_CASES, ids=[c[0] for c in PARITY_CASES])
def test_generic_rule_parity(glint, tlint, name, sources, extra, rules,
                             expected):
    assert parity(glint, tlint, sources, rules, extra=extra) == expected


_WALL_SRC = {"sml_tpu/a.py": "import time\nt0 = time.time()\n"}
_WALL_ENTRY = {"rule": "no-wallclock-in-engine", "file": "sml_tpu/a.py",
               "code": "t0 = time.time()", "reason": "fixture: reviewed"}


@pytest.mark.parametrize("entry, sources, expected", [
    (_WALL_ENTRY, _WALL_SRC, []),
    (dict(_WALL_ENTRY, reason="TODO: justify"), _WALL_SRC,
     [("baseline", 1)]),
    (_WALL_ENTRY, {"sml_tpu/a.py": "x = 1\n"}, [("baseline", 1)]),
    (_WALL_ENTRY, {"sml_tpu/a.py": ("import time\nt0 = time.time()\n"
                                    "t0 = time.time()\n")},
     [("no-wallclock-in-engine", 3)]),
    (dict(_WALL_ENTRY, count=2), _WALL_SRC, [("baseline", 1)]),
], ids=["reviewed", "todo-reason", "stale", "count-one-blesses-one",
        "count-exceeds-occurrences"])
def test_baseline_hygiene_parity(glint, tlint, tmp_path, entry, sources,
                                 expected):
    assert parity(glint, tlint, sources, WALL, baseline=[entry],
                  tmp_path=tmp_path) == expected


def test_baseline_round_trip_keeps_reviewed_reasons(tlint, tmp_path):
    """update() stamps TODO reasons (flagged until reviewed), keeps a
    reviewed one, and an entry whose code was fixed goes stale."""
    src = {"sml_tpu_torch/a.py": "import time\nt0 = time.time()\n"}
    base = tmp_path / "base.json"
    rep = run_on(tlint, src, rules=WALL)
    baseline_mod = sys.modules["torchlint.baseline"]
    baseline_mod.update(str(base), rep.violations)
    entries = baseline_mod.load(str(base))
    assert entries[0]["code"] == "t0 = time.time()"
    rep2 = run_on(tlint, src, rules=WALL, use_baseline=True,
                  baseline_path=str(base))
    assert rules_fired(rep2) == ["torchlint-baseline"]
    entries[0]["reason"] = "fixture: raw clock needed"
    baseline_mod.save(str(base), entries)
    assert run_on(tlint, src, rules=WALL, use_baseline=True,
                  baseline_path=str(base)).clean
    baseline_mod.update(str(base), rep.violations)
    assert baseline_mod.load(str(base))[0]["reason"] \
        == "fixture: raw clock needed"


def test_each_linter_reads_only_its_own_pragmas(glint, tlint):
    src = {"a.py": ("import time\n"
                    "t = time.time()  # graftlint: disable="
                    "no-wallclock-in-engine -- the other linter's\n")}
    g = run_on(glint, {"sml_tpu/a.py": src["a.py"]}, rules=WALL)
    t = run_on(tlint, {"sml_tpu_torch/a.py": src["a.py"]}, rules=WALL)
    assert g.clean and g.n_suppressed_pragma == 1
    assert lines(t) == [("no-wallclock-in-engine", 2)]


# ------------------------------------------------- host-sync-in-hot-path
HOT = ["host-sync-in-hot-path"]


@pytest.mark.parametrize("body, expected", [
    # .cpu() reached from routed_for through the call graph
    ("def helper(x):\n"
     "    return x.cpu()\n"
     "def fit(x):\n"
     "    with routed_for(None, x) as dev:\n"
     "        return helper(x)\n", [2]),
    # .item() in the entry itself
    ("def fit(x):\n"
     "    with routed_for(None, x) as dev:\n"
     "        s = x.sum()\n"
     "    return s.item()\n", [4]),
    # float() of a device tensor, a stream sync
    ("def fit(x, dev):\n"
     "    m = mesh_for(dev)\n"
     "    d = torch.zeros(3, device=dev)\n"
     "    torch.cuda.current_stream(dev).synchronize()\n"
     "    return float(d.sum())\n", [4, 5]),
    # .numpy() and .tolist() of a kernel's result
    ("def fit(b, dev):\n"
     "    route = decide(None, dev)\n"
     "    h = hist_accumulate(b)\n"
     "    return h.numpy(), h.tolist()\n", [4, 4]),
], ids=["cpu-via-call-graph", "item-in-entry", "float-and-synchronize",
        "numpy-tolist-of-kernel-result"])
def test_host_sync_flagged(tlint, body, expected):
    rep = run_on(tlint, {"sml_tpu_torch/ml/a.py": body}, rules=HOT)
    assert [v.line for v in rep.violations] == expected, rep.format()


@pytest.mark.parametrize("body", [
    # a cold function: no dispatch entry reaches it
    "def cold(x, dev):\n"
    "    d = x.to(dev)\n"
    "    return float(d), d.item(), d.cpu()\n",
    # the blessed transfer: its results are host values
    "def fit(x, dev):\n"
    "    with routed_for(None, x) as dev:\n"
    "        out, = device_get(stage_rows(x, dev).sum())\n"
    "    return float(out), out.tolist()\n",
    # host arrays' numpy/tolist are free
    "def fit(x, dev):\n"
    "    m = mesh_for(dev)\n"
    "    a = np.asarray(x)\n"
    "    return a.tolist(), float(a[0])\n",
], ids=["cold", "blessed-device-get", "host-arrays"])
def test_host_sync_clean(tlint, body):
    rep = run_on(tlint, {"sml_tpu_torch/ml/a.py": body}, rules=HOT)
    assert rep.clean, rep.format()


def test_host_sync_exempts_the_blessed_body(tlint):
    rep = run_on(tlint, {"sml_tpu_torch/ml/_staging.py": (
        "def device_get(*ts):\n"
        "    return tuple(t.cpu().numpy() for t in ts)\n"
        "def fit(x, dev):\n"
        "    with routed_for(None, x) as dev:\n"
        "        return device_get(x)\n")}, rules=HOT)
    assert rep.clean, rep.format()


# ------------------------------------------ kernel-launch-outside-native
KL = ["kernel-launch-outside-native"]


@pytest.mark.parametrize("rel, body, expected", [
    ("sml_tpu_torch/ml/rogue.py",
     "def f(dev, fn, x):\n"
     "    return build.launch_on_stream(dev, fn, x)\n", [2]),
    ("sml_tpu_torch/serving/rogue.py",
     "lib = build.load('forest_traverse')\n", [1]),
    ("sml_tpu_torch/ml/rogue.py",
     "import ctypes\nlib = ctypes.CDLL('x.so')\n", [2]),
    ("sml_tpu_torch/ml/rogue.py",
     "from torch.utils.cpp_extension import load\n"
     "mod = load(name='k', sources=['k.cu'])\n", [2]),
    ("sml_tpu_torch/ml/rogue.py",
     "def f(x):\n    return torch.compile(g)(x)\n", [2]),
    ("sml_tpu_torch/native/rogue.py",
     "@torch.jit.script\ndef f(x):\n    return x + 1\n", [1]),
    ("sml_tpu_torch/ml/rogue.py",
     "g = torch.jit.trace(f, (x,))\n", [1]),
    ("sml_tpu_torch/serving/rogue.py",
     "def score(b, sf, sb, lv, w):\n"
     "    return tk.forest_traverse(b, sf, sb, lv, w, depth=4)\n", [2]),
], ids=["launch-on-stream", "build-load", "ctypes-cdll",
        "cpp-extension-load", "torch-compile", "jit-script-in-native",
        "jit-trace", "forest-traverse-outside-glue"])
def test_kernel_launch_flagged(tlint, rel, body, expected):
    rep = run_on(tlint, {rel: body}, rules=KL)
    assert [v.line for v in rep.violations] == expected, rep.format()


def test_kernel_launch_clean_in_native_and_the_glue(tlint):
    rep = run_on(tlint, {
        "sml_tpu_torch/native/hist_kernel.py": (
            "from . import build\n"
            "def hist_accumulate(dev, x):\n"
            "    fn = build.load('hist_accumulate').f\n"
            "    return build.launch_on_stream(dev, fn, x)\n"),
        "sml_tpu_torch/ml/inference.py": (
            "def predict(b, sf, sb, lv, w):\n"
            "    return forest_traverse(b, sf, sb, lv, w, depth=4)\n"),
        "sml_tpu_torch/ml/tree_impl.py": (
            "def replay(b, t):\n"
            "    return forest_traverse(b, *t, depth=6)\n")}, rules=KL)
    assert rep.clean, rep.format()


# ------------------------------------------------ collectives and folds
CAD = ["collective-axis-discipline"]
DIV = ["divergent-collective"]
FOLD = ["per-chip-key-fold"]
_MESH = {"sml_tpu_torch/parallel/mesh.py": (
    "DATA_AXIS = 'data'\nDCN_AXIS = 'dcn'\nICI_AXIS = 'ici'\n"
    "TRIAL_AXIS = 'trial'\n")}


def _with_mesh(body):
    return dict(_MESH, **{"sml_tpu_torch/ml/a.py": body})


@pytest.mark.parametrize("body, expected", [
    ("def fit(x, mesh):\n"
     "    return coll.psum(x, axis='dtaa', mesh=mesh)\n", [2]),
    ("def fit(x, mesh):\n"
     "    return coll.psum_hierarchical(x, ici_axis='icy',\n"
     "                                  dcn_axis=DCN_AXIS, mesh=mesh)\n", [2]),
    # no mesh is obtained in or handed to the helper or its caller
    ("def helper(x):\n"
     "    return coll.psum(x)\n"
     "def fit(x):\n"
     "    return helper(x)\n", [2]),
    ("total = coll.psum(x)\n", [1]),
], ids=["undeclared-literal", "hierarchical-hop-typo", "no-mesh-region",
        "module-level"])
def test_collective_axis_flagged(tlint, body, expected):
    rep = run_on(tlint, _with_mesh(body), rules=CAD)
    assert [v.line for v in rep.violations] == expected, rep.format()


@pytest.mark.parametrize("body", [
    # a declared axis in a function handed a mesh
    "from ..parallel.mesh import TRIAL_AXIS\n"
    "def lanes(x, tmesh):\n"
    "    return coll.all_gather(x, TRIAL_AXIS, tiled=True, mesh=tmesh)\n"
    "def fit(x, mesh):\n"
    "    return lanes(x, mesh)\n",
    # a helper reached from a function that obtains the mesh itself
    "def merge(x, mesh):\n"
    "    return coll.psum_hierarchical(x, ici_axis=ICI_AXIS,"
    " dcn_axis=DCN_AXIS, mesh=mesh)\n"
    "def fit(x):\n"
    "    mesh = get_mesh()\n"
    "    return merge(x, mesh)\n",
    # a trial handed to run_placed_trials
    "def trial(job):\n"
    "    return coll.pmax(job)\n"
    "def tune(jobs):\n"
    "    return run_placed_trials(jobs, trial, 2)\n",
    # a collective inside a lambda a mesh-holding function returns
    "def mesh_merge(mesh):\n"
    "    return lambda x: coll.psum(x, mesh=mesh)\n",
], ids=["declared-axis", "obtained-mesh", "placed-trial", "lambda"])
def test_collective_axis_clean(tlint, body):
    rep = run_on(tlint, _with_mesh(body), rules=CAD)
    assert rep.clean, rep.format()


def test_collective_axis_exempts_the_wrapper_module(tlint):
    rep = run_on(tlint, dict(_MESH, **{
        "sml_tpu_torch/parallel/collectives.py": (
            "def psum(x, axis=DATA_AXIS, mesh=None):\n"
            "    return _reduce(x, axis, mesh)\n"
            "def _reduce(x, axis, mesh):\n"
            "    out = x.clone()\n"
            "    dist.all_reduce(out)\n"
            "    return out\n"
            "def masked_count(m, axis=DATA_AXIS, mesh=None):\n"
            "    return psum(m.sum(), axis, mesh)\n")}), rules=CAD)
    assert rep.clean, rep.format()


@pytest.mark.parametrize("body, expected", [
    ("def fit(x, mesh):\n"
     "    if dist.get_rank() == 0:\n"
     "        x = coll.psum(x, mesh=mesh)\n"
     "    return x\n", [3]),
    ("def fit(x, mesh):\n"
     "    if mesh.rank == 0:\n"
     "        return x\n"
     "    return coll.pmax(x, mesh=mesh)\n", [4]),
    ("def fit(x, mesh):\n"
     "    if GLOBAL_CONF.getBool('sml.x.flag'):\n"
     "        x = coll.psum(x, mesh=mesh)\n"
     "    return x\n", [3]),
    ("def fit(x, mesh):\n"
     "    lo, hi = row_range(len(x), mesh)\n"
     "    while hi > lo:\n"
     "        x = coll.psum(x, mesh=mesh)\n"
     "        hi -= 1\n"
     "    return x\n", [4]),
    ("def fit(x, mesh):\n"
     "    y = coll.psum(x, mesh=mesh) if os.environ.get('A') else x\n"
     "    return y\n", [2]),
    ("def bye():\n"
     "    if getattr(sys, 'last_value', None) is not None:\n"
     "        return\n"
     "    dist.barrier()\n", [4]),
], ids=["if-get-rank", "early-return-on-rank", "conf-branch",
        "while-on-row-range", "ternary-on-environ", "exit-hook-shape"])
def test_divergent_collective_flagged(tlint, body, expected):
    rep = run_on(tlint, _with_mesh(body), rules=DIV)
    assert [v.line for v in rep.violations] == expected, rep.format()


@pytest.mark.parametrize("body", [
    # the lowest-rank checkpoint writer (ct/_checkpoint._writer)
    "def _writer(body):\n"
    "    mesh = get_mesh()\n"
    "    if mesh is None or mesh.size <= 1:\n"
    "        body()\n"
    "        return\n"
    "    error = None\n"
    "    if mesh.rank == 0:\n"
    "        try:\n"
    "            body()\n"
    "        except Exception as e:\n"
    "            error = e\n"
    "    failed = coll.pmax(torch.tensor([int(error is not None)],\n"
    "                                    device=mesh.device), mesh=mesh)\n"
    "    if error is not None:\n"
    "        raise error\n"
    "    if int(failed[0]):\n"
    "        raise OSError('the writer failed')\n",
    # both arms make the collective
    "def fit(x, mesh):\n"
    "    if mesh.rank == 0:\n"
    "        x = coll.psum(x * 2, mesh=mesh)\n"
    "    else:\n"
    "        x = coll.psum(x, mesh=mesh)\n"
    "    return x\n",
    # a submesh membership test is the same on every member
    "def run(jobs, meshes, fn):\n"
    "    for sub in meshes:\n"
    "        if sub.rank is None:\n"
    "            continue\n"
    "        fn(sub)\n"
    "    return coll.all_gather_object(jobs, mesh=meshes[0])\n",
    # ppermute pairs its sends by rank inside the wrapper, by design
    None,
], ids=["lowest-rank-writer", "both-arms", "membership", "ppermute"])
def test_divergent_collective_clean(tlint, body):
    if body is None:
        sources = dict(_MESH, **{"sml_tpu_torch/parallel/collectives.py": (
            "def ppermute(x, perm, axis=DATA_AXIS, mesh=None):\n"
            "    me = dist.get_rank()\n"
            "    for s, d in perm:\n"
            "        if s == me:\n"
            "            dist.isend(x, d)\n"
            "    return x\n")})
    else:
        sources = _with_mesh(body)
    rep = run_on(tlint, sources, rules=DIV)
    assert rep.clean, rep.format()


def test_divergent_collective_clean_on_the_committed_writer(tlint):
    """The committed `_writer` (ct/_checkpoint.py) stays clean: the rule
    reports nothing in that file on the real tree."""
    project = tlint.Project.from_root(REPO)
    rep = tlint.run(project=project, rule_names=DIV, use_baseline=False)
    assert not [v for v in rep.violations
                if v.path == "sml_tpu_torch/ct/_checkpoint.py"]
    assert "def _writer(" in project.by_rel[
        "sml_tpu_torch/ct/_checkpoint.py"].text


@pytest.mark.parametrize("body, expected", [
    ("def draw(key, mesh):\n"
     "    return prng.fold_in(key, coll.axis_index(mesh=mesh))\n", [2]),
    ("def draw(key, mesh):\n"
     "    r = mesh.rank\n"
     "    return prng.fold_in(key, r)\n", [3]),
    ("def draw(keys):\n"
     "    return fold_in_keys(keys, dist.get_rank())\n", [2]),
], ids=["axis-index", "assigned-rank", "fold-in-keys-get-rank"])
def test_key_fold_flagged(tlint, body, expected):
    rep = run_on(tlint, _with_mesh(body), rules=FOLD)
    assert [v.line for v in rep.violations] == expected, rep.format()


@pytest.mark.parametrize("body", [
    "def draw(key, n_trees):\n"
    "    return [prng.fold_in(key, t) for t in range(n_trees)]\n",
    # each rank draws every row and slices its block
    "def draw(key, n, mesh):\n"
    "    lo, hi = row_range(n, mesh)\n"
    "    u = prng.uniform(prng.fold_in(key, 7), (n,))\n"
    "    return u[lo:hi]\n",
], ids=["round-counter", "sliced-draw"])
def test_key_fold_clean(tlint, body):
    rep = run_on(tlint, _with_mesh(body), rules=FOLD)
    assert rep.clean, rep.format()


# ------------------------------------------------------ the thread model
THREADED = ("ct/_trainer.py", "device.py", "fleet/_pool.py",
            "loadgen/_driver.py", "native/build.py", "obs/_watchdog.py",
            "parallel/pipeline.py", "parallel/prewarm.py",
            "serving/_batcher.py", "serving/_endpoint.py",
            "streaming/stream.py")


def test_role_map_finds_an_entry_in_every_threaded_module(tlint):
    project = tlint.Project.from_root(REPO)
    analysis = sys.modules["torchlint.threads"].analyze(project)
    found = {rel for _, rel, _ in analysis.entries}
    missing = [m for m in THREADED if "sml_tpu_torch/" + m not in found]
    assert missing == []


def test_role_map_binds_a_pool_callable_through_its_callers(tlint):
    """`pool.map(fn, jobs)` with `fn` a parameter: the entry is recorded
    at the pool, and each caller's function is a thread entry."""
    project = tlint.Project.from_sources({
        "sml_tpu_torch/device.py": (
            "from concurrent.futures import ThreadPoolExecutor\n"
            "def run_placed_trials(jobs, fn, parallelism):\n"
            "    with ThreadPoolExecutor(max_workers=2) as pool:\n"
            "        return list(pool.map(fn, jobs))\n"),
        "sml_tpu_torch/ml/tuning.py": (
            "from .. import device\n"
            "def fit_grid(jobs):\n"
            "    def run(job):\n"
            "        return helper(job)\n"
            "    return device.run_placed_trials(jobs, run, 2)\n"
            "def helper(job):\n"
            "    return job\n")})
    roles = sys.modules["torchlint.threads"].thread_roles(project)
    for key in ("sml_tpu_torch/ml/tuning.py::fit_grid.run",
                "sml_tpu_torch/ml/tuning.py::helper"):
        assert any(r.startswith("thread:") for r in roles.get(key, ())), key
    assert not roles.get("sml_tpu_torch/ml/tuning.py::fit_grid")


# ---------------------------------------------------- the reconstructions
STREAM = "sml_tpu_torch/streaming/stream.py"
_APPEND = (
    "        # the progress entry goes in before the files count as processed,\n"
    "        # so `processAllAvailable` never returns with it missing\n"
    "        self.recentProgress.append({\n"
    "            \"id\": self.id, \"name\": self.name, \"numInputRows\": rows,\n"
    "            \"files\": batch_files, \"timestamp\": wallclock(),\n"
    "            \"durationMs\": (wallclock() - t0) * 1e3})\n")
_SAVE = ("        self._save_checkpoint()\n"
         "        self._ckpt_dirty = False\n")


def _stream_parent_text():
    """stream.py as it stood before the fix: the progress entry appended
    after the files were counted processed and the checkpoint saved."""
    with open(os.path.join(REPO, STREAM), encoding="utf-8") as fh:
        text = fh.read()
    assert text.count(_APPEND) == 1 and text.count(_SAVE) == 1
    moved = _APPEND.split("\n", 2)[2]   # the append, without the comment
    return text.replace(_APPEND, "").replace(_SAVE, _SAVE + moved)


def test_streaming_publish_order_fault_flagged_on_the_parent(tlint, glint):
    parent = _stream_parent_text()
    rep = run_on(tlint, {STREAM: parent}, rules=RACEC)
    append_line = parent.splitlines().index(
        "        self.recentProgress.append({") + 1
    assert [v.line for v in rep.violations] == [append_line], rep.format()
    assert "publish `self.recentProgress` first" in rep.violations[0].message
    # the JAX package's check-then-use rule has no publish-order leg
    old = run_on(glint, {"sml_tpu/streaming/stream.py": parent},
                 rules=RACEC)
    assert old.clean


def test_streaming_publish_order_clean_on_the_fix(tlint):
    with open(os.path.join(REPO, STREAM), encoding="utf-8") as fh:
        rep = run_on(tlint, {STREAM: fh.read()}, rules=RACEC + RACEW)
    assert rep.clean, rep.format()


_PUBLISH_ORDER = (
    "import threading\n"
    "class Query:\n"
    "    def __init__(self):\n"
    "        self._stop = threading.Event()\n"
    "        self._done = set()\n"
    "        self.progress = []\n"
    "    def start(self):\n"
    "        threading.Thread(target=self._run).start()\n"
    "    def _run(self):\n"
    "        self._done.update(['f'])\n"
    "        self.progress.append('f')\n"
    "    def wait(self):\n"
    "        while 'f' not in self._done:\n"
    "            self._stop.wait(0.01)\n"
    "    @property\n"
    "    def last(self):\n"
    "        p = self.progress\n"
    "        return p[-1] if p else None\n")


def test_publish_order_leg_flags_the_later_publish_only(tlint):
    rep = run_on(tlint, {"sml_tpu_torch/a.py": _PUBLISH_ORDER}, rules=RACEC)
    assert lines(rep) == [("race-check-then-use", 11)]
    fixed = _PUBLISH_ORDER.replace(
        "        self._done.update(['f'])\n        self.progress.append('f')\n",
        "        self.progress.append('f')\n        self._done.update(['f'])\n")
    assert run_on(tlint, {"sml_tpu_torch/a.py": fixed}, rules=RACEC).clean


COURSE_KEYS = ("sml.training.module-name", "sml.training.username")


def _tree_sources(conf_text=None):
    """Every lint target of the committed tree as in-memory sources, with
    `conf.py` replaced by `conf_text`, and the tests as evidence."""
    project = tlint_project()
    sources = {f.rel: f.text for f in project.files}
    if conf_text is not None:
        sources["sml_tpu_torch/conf.py"] = conf_text
    return sources, {f.rel: f.text for f in project.extra_files}


def tlint_project():
    return sys.modules["torchlint"].Project.from_root(REPO)


def parent_conf_text():
    """conf.py without the two course keys' registrations (the parent's
    registry)."""
    with open(os.path.join(REPO, "sml_tpu_torch", "conf.py"),
              encoding="utf-8") as fh:
        text = fh.read()
    block = ('_register("sml.training.module-name", "", str,\n'
             '          "Course module name stamped by the Classroom-Setup '
             'shim "\n'
             '          "(courseware.CourseConfig)")\n'
             '_register("sml.training.username", "", str,\n'
             '          "Course username stamped by the Classroom-Setup '
             'shim")\n')
    assert text.count(block) == 1
    return text.replace(block, "")


def test_courseware_keys_flagged_on_the_parent_registry(tlint):
    sources, extra = _tree_sources(parent_conf_text())
    rep = run_on(tlint, sources, rules=CONF, extra=extra)
    got = [(v.path, v.line) for v in rep.violations]
    assert got == [("sml_tpu_torch/courseware.py", 84),
                   ("sml_tpu_torch/courseware.py", 90)], rep.format()
    for key, v in zip(COURSE_KEYS, rep.violations):
        assert repr(key) in v.message


def test_courseware_keys_clean_on_the_fix(tlint):
    sources, extra = _tree_sources()
    rep = run_on(tlint, sources, rules=CONF, extra=extra)
    assert rep.clean, rep.format()


def test_taxonomy_rule_checks_the_kernel_launch_counters(tlint):
    """A native module's counter must be a registered kernel, and each
    registered kernel must be counted: a rogue counter and a missing
    one both flag."""
    rep = run_on(tlint, {"sml_tpu_torch/native/rogue.py": (
        "LAUNCHES = {'index_add': 0}\n")}, rules=TAX)
    assert lines(rep) == [("obs-taxonomy", 1)]
    assert "'index_add'" in rep.violations[0].message
    project = tlint_project()
    tax = sys.modules["torchlint.rules.taxonomy"]
    counted = tax.launch_counters(project)
    assert set(counted) == tax.load_taxonomy().KERNEL_LAUNCHES
    sources = {f.rel: f.text for f in project.files}
    sources["sml_tpu_torch/native/prng_kernel.py"] = sources[
        "sml_tpu_torch/native/prng_kernel.py"].replace(
        'LAUNCHES = {"row_weights": 0, "feature_mask": 0}',
        'LAUNCHES = {"row_weights": 0}')
    rep2 = run_on(tlint, sources, rules=TAX)
    assert [v.message for v in rep2.violations] == [
        "registered kernel 'feature_mask' has no LAUNCHES counter in "
        "sml_tpu_torch/native/"]


def test_rule_catalogue(tlint):
    assert sorted(tlint.RULES) == sorted([
        "collective-axis-discipline", "conf-key-registry",
        "divergent-collective", "host-sync-in-hot-path",
        "kernel-launch-outside-native", "lock-order",
        "no-wallclock-in-engine", "obs-taxonomy", "per-chip-key-fold",
        "race-check-then-use", "race-unguarded-shared-write"])
    assert tlint.META_RULES == ("torchlint-pragma", "torchlint-baseline",
                                "syntax-error")


FRAME = "sml_tpu_torch/frame/dataframe.py"
#: (the fix, the parent's text) of each hunk of the frame's race repair
_FRAME_HUNKS = [
    ("        with self._lock:\n"
     "            whole = self._whole_cache\n"
     "            if whole is None:\n"
     "                whole = concat_blocks(self._materialize())\n"
     "                self._whole_cache = whole\n"
     "            return whole\n",
     "        if self._whole_cache is None:\n"
     "            self._whole_cache = concat_blocks(self._materialize())\n"
     "        return self._whole_cache\n"),
    ("        with self._lock:\n"
     "            if self._compute is not None:\n"
     "                self._parts = None\n"
     "                self._offsets = None\n"
     "            self._whole_cache = None\n",
     "        if self._compute is not None:\n"
     "            self._parts = None\n"
     "            self._offsets = None\n"
     "        self._whole_cache = None\n"),
]


def test_frame_whole_race_flagged_on_the_parent(tlint):
    """Tuning's trials share frames across threads (the placed trials'
    pool), and the parent's `_whole` stored its block and loaded it
    again unlocked while `unpersist` could drop it in between."""
    sources, extra = _tree_sources()
    text = sources[FRAME]
    for fix, parent in _FRAME_HUNKS:
        assert text.count(fix) == 1
        text = text.replace(fix, parent)
    sources[FRAME] = text
    rep = run_on(tlint, sources, rules=RACEC + RACEW, extra=extra)
    found = {(v.rule, v.snippet) for v in rep.violations if v.path == FRAME}
    assert ("race-check-then-use", "return self._whole_cache") in found
    assert ("race-unguarded-shared-write",
            "self._whole_cache = None") in found
    fixed, _ = _tree_sources()
    rep2 = run_on(tlint, fixed, rules=RACEC + RACEW, extra=extra)
    assert not [v for v in rep2.violations if v.path == FRAME], \
        rep2.format()


def test_frame_whole_survives_an_unpersist_between_store_and_return():
    """The interleaving itself, made deterministic: an `unpersist` that
    lands right after `_whole` stores its block. The parent returned
    None; the fix returns the block it stored."""
    import numpy as np

    from sml_tpu_torch.frame.dataframe import DataFrame

    class Interleaved(DataFrame):
        def __setattr__(self, name, value):
            super().__setattr__(name, value)
            if name == "_whole_cache" and value is not None:
                self.unpersist()

    df = Interleaved.from_block({"a": np.arange(6.0)}, num_partitions=3)
    whole = df._whole()
    assert whole is not None
    assert whole["a"].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_frame_whole_under_concurrent_unpersist_stress():
    """More reader threads than cores read `_whole` while the main
    thread unpersists the frame, under a short switch interval: every
    read returns the block (the parent's could return None)."""
    import threading

    import numpy as np

    from sml_tpu_torch.frame.dataframe import DataFrame

    df = DataFrame.from_block({"a": np.arange(64.0)}, num_partitions=4)
    df._materialize()
    bad = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            if df._whole() is None:
                bad.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for _ in range(1000):
            df.unpersist()
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert bad == []
