"""The port's courseware harness (`sml_tpu_torch/courseware.py`) against
the live JAX package, on the CPU.

- `TestResults.to_hash`: the course's own constants (hash("8") ==
  1276280174, hash("100000") == 972882115, `Labs/ML 00L:89-90`) and the
  JAX package's hash of other answers; `validate_your_answer`,
  `validate_your_schema`, `summarize_your_results` and `all_passed` as
  the JAX package records and renders them;
- `log_your_test` writes the JAX package's bytes; each package loads
  the other's log (`load_your_test_results` gives a port DataFrame);
- `ClassroomSetup`: the workspace, the conf keys, `get_widget`,
  `path_exists`, the `SML_JOB_ID` experiment, and `install_datasets` /
  `reset` into `tmp_path`: the raw CSV and the dedup text are the JAX
  package's bytes, and the JAX package reads the port's clean parquet
  and Delta tables and MovieLens's parquet to the frames its own install
  gives (partition for partition, floats bit for bit).

The course's import names (`compat.install_shims`, which a setup also
installs) are left out here, where the JAX package's tests share the
interpreter; `tests/test_torch_isolation.py` runs a setup in a fresh
one.
"""

import os

import numpy as np
import pytest

from sml_tpu_torch import GLOBAL_CONF as PCONF
from sml_tpu_torch import courseware as pcw

from test_torch_frame_sql import assert_same_frame


@pytest.fixture(autouse=True)
def no_shims(monkeypatch):
    import sml_tpu.compat
    import sml_tpu_torch.compat
    monkeypatch.setattr(sml_tpu_torch.compat, "install_shims", lambda: None)
    monkeypatch.setattr(sml_tpu.compat, "install_shims", lambda: None)


@pytest.mark.parametrize("value, want", [("8", 1276280174),
                                         ("100000", 972882115),
                                         (8, 1276280174),
                                         (100000, 972882115)])
def test_the_course_hash_constants(value, want):
    assert pcw.TestResults.to_hash(value) == want == pcw.toHash(value)


@pytest.mark.parametrize("answer", [None, True, False, 0, -7, 3.25, "é",
                                    "a longer answer, with punctuation!",
                                    2 ** 40, "Private room"])
def test_answers_hash_as_in_the_jax_package(answer):
    from sml_tpu import courseware as jcw
    pt, jt = pcw.TestResults(), jcw.TestResults()
    assert pt._answer_str(answer) == jt._answer_str(answer)
    assert pt.to_hash(pt._answer_str(answer)) == \
        jt.to_hash(jt._answer_str(answer))


def test_validation_records_and_summary_equal_jax(spark, capsys):
    from sml_tpu import courseware as jcw
    from sml_tpu_torch.frame.session import get_session
    pdf = get_session().createDataFrame({"a": np.arange(3.0),
                                         "b": np.array(["x", "y", "z"],
                                                       dtype=object)})
    jdf = spark.createDataFrame(pdf.toPandas())
    out = {}
    for name, mod, df in (("jax", jcw, jdf), ("port", pcw, pdf)):
        r = mod.TestResults()
        r.validate_your_answer("01 count", 972882115, 100000)
        r.validate_your_answer("02 wrong", 1276280174, 9)
        r.validate_your_schema("03 schema", df, {"a": "double",
                                                 "b": "string"})
        r.validate_your_schema("04 schema", df, {"a": "bigint"})
        out[name] = (r.results, r.summarize_your_results(), r.all_passed,
                     capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["port"][2] is False


def test_test_log_bytes_and_cross_loading(tmp_path):
    from sml_tpu import courseware as jcw
    for name, mod in (("jax", jcw), ("port", pcw)):
        d = str(tmp_path / name)
        mod.log_your_test(d, "ML 00L: records", 100000)
        mod.log_your_test(d, "rmse", 0.125)
        mod.log_your_test(d, "r2 (test)", -3)
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    want = jcw.load_your_test_results(str(tmp_path / "port"))
    got = pcw.load_your_test_results(str(tmp_path / "jax"))
    assert [r.asDict() for r in got.collect()] == \
        want.to_dict("records")
    assert pcw.load_your_test_map(str(tmp_path / "jax")) == \
        jcw.load_your_test_map(str(tmp_path / "port"))
    os.makedirs(tmp_path / "none")
    assert pcw.load_your_test_results(str(tmp_path / "none")).count() == 0


def test_classroom_setup_fields_widgets_and_job_experiment(tmp_path,
                                                           monkeypatch):
    from sml_tpu import courseware as jcw
    from sml_tpu import tracking as jt
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu_torch import tracking as pt
    for m in (pt, jt):
        m.set_tracking_uri(str(tmp_path / "runs"))
        m._active_experiment["id"] = None
    monkeypatch.setenv("SML_JOB_ID", "job-17")
    try:
        j = jcw.ClassroomSetup(base_dir=str(tmp_path / "j"),
                               widgets={"reinstall": "true"})
        p = pcw.ClassroomSetup(base_dir=str(tmp_path / "p"),
                               widgets={"reinstall": "true"})
        for attr in ("course_name", "username", "clean_username",
                     "database", "widgets"):
            assert getattr(p, attr) == getattr(j, attr), attr
        for attr in ("user_home", "working_dir", "datasets_dir"):
            assert os.path.relpath(getattr(p, attr), tmp_path / "p") == \
                os.path.relpath(getattr(j, attr), tmp_path / "j")
        assert os.path.isdir(p.working_dir)
        for key in ("sml.training.module-name", "sml.training.username"):
            assert PCONF.get(key) == JCONF.get(key)
        assert p.get_widget("reinstall") == "true"
        assert p.get_widget("nope", "dflt") == j.get_widget("nope", "dflt")
        assert p.path_exists(p.working_dir) and not p.path_exists(
            str(tmp_path / "absent"))
        exp = pt.MlflowClient().get_experiment(pt._active_experiment["id"])
        assert exp.name == "Test Results/Experiments/job-17"
    finally:
        for m in (pt, jt):
            m._active_experiment["id"] = None
    assert pcw.get_clean_username("A.B-c d") == \
        jcw.get_clean_username("A.B-c d") == "a_b_c_d"
    assert (pcw.FILL_IN.VALUE, pcw.FILL_IN.LIST, pcw.FILL_IN.INT) == \
        (jcw.FILL_IN.VALUE, jcw.FILL_IN.LIST, jcw.FILL_IN.INT)


@pytest.fixture(scope="module")
def installs(tmp_path_factory):
    """Each package's `install_datasets` into a directory of its own."""
    import sml_tpu.compat
    import sml_tpu_torch.compat
    from sml_tpu import courseware as jcw
    saved = (sml_tpu_torch.compat.install_shims,
             sml_tpu.compat.install_shims)
    sml_tpu_torch.compat.install_shims = sml_tpu.compat.install_shims = \
        lambda: None
    try:
        base = tmp_path_factory.mktemp("classroom")
        j = jcw.ClassroomSetup(base_dir=str(base / "j"))
        p = pcw.ClassroomSetup(base_dir=str(base / "p"))
        return j.install_datasets(), p.install_datasets(), p
    finally:
        sml_tpu_torch.compat.install_shims, sml_tpu.compat.install_shims = \
            saved


@pytest.mark.parametrize("rel", [
    "airbnb/sf-listings/sf-listings-2019-03-06.csv",
    "dedup/people-with-dups.txt"])
def test_installed_text_files_are_the_jax_packages_bytes(installs, rel):
    jdir, pdir, _ = installs
    with open(os.path.join(pdir, rel), "rb") as a, \
            open(os.path.join(jdir, rel), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("rel, fmt", [
    ("airbnb/sf-listings/sf-listings-2019-03-06-clean.parquet", "parquet"),
    ("airbnb/sf-listings/sf-listings-2019-03-06-clean.delta", "delta"),
    ("movielens/ratings.parquet", "parquet")])
def test_the_jax_package_reads_the_installed_tables(spark, installs, rel,
                                                    fmt):
    from sml_tpu_torch.frame.session import get_session
    jdir, pdir, _ = installs
    want = spark.read.format(fmt).load(os.path.join(jdir, rel))
    # the JAX package reads the port's install, the port its own and the
    # JAX package's, each equal to the JAX package's own read
    got = spark.read.format(fmt).load(os.path.join(pdir, rel))
    assert got.toPandas().equals(want.toPandas())
    for d in (pdir, jdir):
        assert_same_frame(want, get_session().read.format(fmt).load(
            os.path.join(d, rel)))


def test_install_is_idempotent_and_reset_keeps_the_datasets(installs):
    _, pdir, setup = installs
    marker = os.path.join(pdir, "_SUCCESS")
    stamp = os.path.getmtime(marker)
    assert setup.install_datasets() == pdir
    assert os.path.getmtime(marker) == stamp
    open(os.path.join(setup.working_dir, "scratch.txt"), "w").close()
    setup.reset()
    assert os.listdir(setup.working_dir) == []
    assert os.path.getmtime(marker) == stamp


def test_readiness_polls_and_all_done(capsys):
    from sml_tpu import courseware as jcw

    class Query:
        isActive = True
        recentProgress = [{}, {}]

    pcw.until_stream_is_ready(Query(), min_batches=2, timeout_s=1)
    Query.recentProgress = []
    with pytest.raises(TimeoutError):
        pcw.untilStreamIsReady(Query(), min_batches=1, timeout_s=0.3)
    ns = {"model": 1, "rmse": 2.0, "_hidden": 3}
    assert pcw.all_done(ns) == jcw.all_done(ns)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]
