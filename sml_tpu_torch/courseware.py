"""The courseware harness: classroom setup, the answer checks, the
test log and the course's synthetic datasets.

The port's copy of `sml_tpu/courseware.py` (the reference's include
files, `SURVEY.md` section 1 L9):

- `ClassroomSetup` (`Classroom-Setup.py`): the per-user working
  directories, the `sml.training.*` keys, the course's import names
  (`compat.install_shims`), the CI experiment under `SML_JOB_ID`,
  `get_widget`, `path_exists`, and `install_datasets` / `reset`, which
  write the raw Airbnb CSV, the clean Airbnb table as parquet and as
  Delta, MovieLens's ratings as parquet and the dedup lab's
  colon-separated text, through the port's own writers (`frame/io.py`,
  `frame/parquet/`, `delta/table.py`);
- `TestResults` (`Class-Utility-Methods.py:158-256`): answers hashed by
  Spark's `hash()` (`native/hashing.py`, Murmur3), checked against the
  course's constants; `log_your_test`, `load_your_test_results` (a port
  DataFrame where the JAX package gives pandas) and `load_your_test_map`;
- `until_stream_is_ready`, `wait_for_model`, `all_done`, `FILL_IN`;
- `make_airbnb_dataset`, `make_movielens_dataset` (dicts of numpy
  columns) and `make_dedup_dataset` (a port DataFrame): the JAX
  package's draws from the same generators in the same order (NaN
  sprinkle included), so `createDataFrame(...)` of either holds the JAX
  package's rows in its order.
"""

from __future__ import annotations

import getpass
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .conf import GLOBAL_CONF
from .frame.column import object_array
from .frame.dataframe import DataFrame, concat_blocks
from .frame.io import read_csv_block, write_csv_file
from .frame.session import get_session
from .native.hashing import hash_columns
from .utils.profiler import wallclock


class FILL_IN:
    """Placeholders that keep unsolved lab cells runnable
    (`Class-Utility-Methods.py:356-363`)."""
    VALUE = None
    LIST: List = []
    SCHEMA = None
    DATAFRAME = None
    INT = 0


def get_username() -> str:
    try:
        return getpass.getuser()
    except Exception:  # no passwd entry (a container's uid)
        return os.environ.get("USER", "student")


def get_clean_username(username: Optional[str] = None) -> str:
    return re.sub(r"[^a-z0-9]", "_", (username or get_username()).lower())


class ClassroomSetup:
    """The classroom's configuration, the user's workspace and the
    dataset install."""

    def __init__(self, course_name: str = "sml-tpu",
                 base_dir: Optional[str] = None,
                 widgets: Optional[Dict[str, str]] = None):
        self.course_name = course_name
        self.username = get_username()
        self.clean_username = get_clean_username(self.username)
        base = base_dir or os.path.join(os.getcwd(), "_classroom")
        self.user_home = os.path.join(base, self.clean_username, course_name)
        self.working_dir = os.path.join(self.user_home, "working")
        self.datasets_dir = os.path.join(base, "_datasets", course_name)
        self.widgets = dict(widgets or {})
        os.makedirs(self.working_dir, exist_ok=True)
        GLOBAL_CONF.set("sml.training.module-name", course_name)
        # every notebook begins with `%run ./Includes/Classroom-Setup`, so
        # the setup also installs the course's import names: the lesson's
        # cells below it run unchanged on the port
        from .compat import install_shims
        install_shims()
        GLOBAL_CONF.set("sml.training.username", self.username)
        self.database = f"sml_{self.clean_username}_db"
        # run as a job: record into the job's experiment
        # (Classroom-Setup:83-92)
        if os.environ.get("SML_JOB_ID"):
            from . import tracking
            tracking.set_experiment(
                f"Test Results/Experiments/{os.environ['SML_JOB_ID']}")

    def get_widget(self, name: str, default: str = "") -> str:
        """A widget's value, else `default` (`Classroom-Setup.py:65-69`)."""
        return self.widgets.get(name, default)

    # -- datasets ---------------------------------------------------------
    def install_datasets(self, reinstall: bool = False) -> str:
        """Write the course's datasets under `datasets_dir` once (again
        with `reinstall`); returns the directory."""
        marker = os.path.join(self.datasets_dir, "_SUCCESS")
        if os.path.exists(marker) and not reinstall:
            return self.datasets_dir
        if os.path.exists(self.datasets_dir):
            shutil.rmtree(self.datasets_dir)
        os.makedirs(self.datasets_dir, exist_ok=True)
        session = get_session()
        airbnb = make_airbnb_dataset()
        raw_dir = os.path.join(self.datasets_dir, "airbnb", "sf-listings")
        os.makedirs(raw_dir, exist_ok=True)
        write_csv_file(airbnb, os.path.join(raw_dir,
                                            "sf-listings-2019-03-06.csv"))
        clean = session.createDataFrame(airbnb).dropna()._whole()
        session.createDataFrame(clean).write.mode("overwrite").parquet(
            os.path.join(raw_dir, "sf-listings-2019-03-06-clean.parquet"))
        session.createDataFrame(clean).write.format("delta") \
            .mode("overwrite").save(
                os.path.join(raw_dir, "sf-listings-2019-03-06-clean.delta"))
        ml_dir = os.path.join(self.datasets_dir, "movielens")
        os.makedirs(ml_dir, exist_ok=True)
        session.createDataFrame(make_movielens_dataset()).write \
            .mode("overwrite").parquet(os.path.join(ml_dir,
                                                    "ratings.parquet"))
        dedup_dir = os.path.join(self.datasets_dir, "dedup")
        os.makedirs(dedup_dir, exist_ok=True)
        write_csv_file(make_dedup_dataset()._whole(),
                       os.path.join(dedup_dir, "people-with-dups.txt"),
                       sep=":")
        with open(marker, "w") as f:
            f.write(str(wallclock()))
        return self.datasets_dir

    def path_exists(self, path: str) -> bool:
        return os.path.exists(path)

    def reset(self) -> None:
        """`Reset.py:10-22`: empty the working directory and install the
        datasets where they are missing."""
        if os.path.exists(self.working_dir):
            shutil.rmtree(self.working_dir)
        os.makedirs(self.working_dir, exist_ok=True)
        self.install_datasets(reinstall=False)


def make_airbnb_dataset(n: int = 10000, seed: int = 42
                        ) -> Dict[str, np.ndarray]:
    """SF-Airbnb-shaped listings table (schema of the course's cleaned
    set): 23 columns, text columns as object arrays."""
    rng = np.random.default_rng(seed)
    hoods = ["Mission", "South of Market", "Western Addition", "Castro",
             "Bernal Heights", "Haight Ashbury", "Noe Valley", "Outer Sunset",
             "Inner Richmond", "Nob Hill", "Pacific Heights", "Chinatown",
             "Downtown", "Marina", "Potrero Hill", "Russian Hill",
             "Outer Richmond", "Excelsior", "Twin Peaks", "Glen Park",
             "Bayview", "Inner Sunset", "Lakeshore", "North Beach",
             "Visitacion Valley", "Parkside", "Ocean View", "Mission Bay",
             "West of Twin Peaks", "Seacliff", "Presidio Heights",
             "Financial District", "Crocker Amazon", "Diamond Heights",
             "Golden Gate Park", "Presidio"]
    room_types = ["Entire home/apt", "Private room", "Shared room"]
    property_types = ["Apartment", "House", "Condominium", "Townhouse",
                      "Guest suite", "Boutique hotel"]
    bedrooms = rng.choice([0, 1, 2, 3, 4, 5], n,
                          p=[.08, .42, .28, .14, .06, .02]).astype(float)
    accommodates = np.clip(bedrooms * 2 + rng.integers(0, 3, n), 1,
                           16).astype(float)
    bathrooms = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0], n,
                           p=[.55, .15, .2, .06, .04])
    review_scores = np.clip(rng.normal(94, 7, n), 20, 100)
    hood_effect = rng.normal(0, 0.25, len(hoods))
    hood_idx = rng.integers(0, len(hoods), n)
    room_mult = np.array([1.0, 0.55, 0.35])
    room_idx = rng.choice(3, n, p=[.62, .33, .05])
    price = np.exp(4.1 + 0.32 * bedrooms + 0.06 * accommodates
                   + hood_effect[hood_idx] + rng.normal(0, 0.35, n)) \
        * room_mult[room_idx]
    # the dict's values are drawn in this order, as the JAX package's
    # DataFrame literal draws them
    cols = {
        "host_is_superhost": rng.choice(["t", "f"], n, p=[0.25, 0.75]),
        "instant_bookable": rng.choice(["t", "f"], n, p=[0.4, 0.6]),
        "host_total_listings_count": rng.integers(1, 20, n).astype(float),
        "neighbourhood_cleansed": np.array(hoods)[hood_idx],
        "latitude": 37.72 + rng.random(n) * 0.09,
        "longitude": -122.51 + rng.random(n) * 0.12,
        "property_type": rng.choice(property_types, n),
        "room_type": np.array(room_types)[room_idx],
        "accommodates": accommodates,
        "bathrooms": bathrooms,
        "bedrooms": bedrooms,
        "beds": np.maximum(bedrooms, 1) + rng.integers(0, 2, n),
        "bed_type": rng.choice(["Real Bed", "Futon", "Couch"], n,
                               p=[.94, .04, .02]),
        "minimum_nights": rng.integers(1, 30, n).astype(float),
        "number_of_reviews": rng.integers(0, 400, n).astype(float),
        "review_scores_rating": review_scores,
        "review_scores_accuracy": np.clip(rng.normal(9.6, 0.7, n), 2, 10),
        "review_scores_cleanliness": np.clip(rng.normal(9.5, 0.8, n), 2, 10),
        "review_scores_checkin": np.clip(rng.normal(9.7, 0.5, n), 2, 10),
        "review_scores_communication": np.clip(rng.normal(9.7, 0.5, n), 2,
                                               10),
        "review_scores_location": np.clip(rng.normal(9.6, 0.6, n), 2, 10),
        "review_scores_value": np.clip(rng.normal(9.4, 0.8, n), 2, 10),
        "price": np.round(price, 0),
    }
    out = {c: (v.astype(object) if v.dtype.kind == "U" else v.copy())
           for c, v in cols.items()}
    # sprinkle missing values like the raw course data (imputation targets)
    for c in ("bedrooms", "bathrooms", "review_scores_rating"):
        out[c][rng.random(n) < 0.03] = np.nan
    return out


def make_movielens_dataset(n_users: int = 1000, n_items: int = 400,
                           n_ratings: int = 50000, seed: int = 7
                           ) -> Dict[str, np.ndarray]:
    """MovieLens-shaped ratings (userId, movieId, rating in half stars,
    timestamp) from a rank-6 model plus noise, one row per (user, movie)
    pair: the first of the drawn duplicates, in draw order (pandas'
    `drop_duplicates` keeping the first)."""
    rng = np.random.default_rng(seed)
    rank = 6
    U = rng.normal(0, 0.6, (n_users, rank))
    V = rng.normal(0, 0.6, (n_items, rank))
    u = rng.integers(0, n_users, n_ratings)
    i = rng.integers(0, n_items, n_ratings)
    raw = (U[u] * V[i]).sum(1) + 3.4 + rng.normal(0, 0.4, n_ratings)
    cols = {"userId": u.astype(np.int64), "movieId": i.astype(np.int64),
            "rating": np.clip(np.round(raw * 2) / 2, 0.5, 5.0),
            "timestamp": rng.integers(9e8, 1e9, n_ratings)}
    _, first = np.unique(cols["userId"] * n_items + cols["movieId"],
                         return_index=True)
    keep = np.sort(first)
    return {c: v[keep] for c, v in cols.items()}


def make_dedup_dataset(n: int = 103000, n_unique: int = 100000,
                       seed: int = 11):
    """The people-with-dups table (`Labs/ML 00L:30-38`), as the port's
    DataFrame: the lab file's colon-separated schema, n rows of which
    n - n_unique duplicate others and differ only in name case and ssn
    format (hyphens dropped). The rows are shuffled as pandas'
    `sample(frac=1.0, random_state=seed)` shuffles them (a permutation
    from `np.random.RandomState(seed)`), so they come in the JAX
    package's order."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n_unique)
    cols = {
        "firstName": [f"Person{i}" for i in idx],
        "middleName": [f"M{i % 409}" for i in idx],
        "lastName": [f"Family{i % 977}" for i in idx],
        "gender": np.where(idx % 2 == 0, "F", "M").tolist(),
        "birthDate": [f"{1950 + i % 50}-{1 + i % 12:02d}-{1 + i % 28:02d}"
                      for i in idx],
        "salary": (35000 + (idx * 7919) % 150000).astype(np.int64),
        "ssn": [f"{900 + i // 10000:03d}-{(i // 100) % 100:02d}-"
                f"{i % 10000:04d}" for i in idx],
    }
    dup = rng.choice(n_unique, n - n_unique, replace=False)
    dups = {c: [v[i] for i in dup] for c, v in cols.items()}
    dups["firstName"] = [v.upper() for v in dups["firstName"]]
    dups["middleName"] = [v.lower() for v in dups["middleName"]]
    dups["ssn"] = [v.replace("-", "") for v in dups["ssn"]]
    order = np.random.RandomState(seed).permutation(n)
    block = {}
    for c, v in cols.items():
        whole = np.concatenate([np.asarray(v), np.asarray(dups[c])]) \
            if c == "salary" else object_array(list(v) + dups[c])
        block[c] = whole[order]
    return get_session().createDataFrame(block)


# ------------------------------------------------------- answer checks
class TestResults:
    """The hash-checked answer harness (`Class-Utility-Methods.py:
    158-256`)."""

    def __init__(self):
        self.results: List[Dict[str, Any]] = []

    @staticmethod
    def to_hash(value) -> int:
        """`abs(hash(str(value)))` as the course computes it in Spark
        (`Class-Utility-Methods.py:161-165`), through the port's Murmur3:
        hash("8") == 1276280174 and hash("100000") == 972882115
        (`Labs/ML 00L - Dedup Lab.py:89-90`). Java's
        `Math.abs(Integer.MIN_VALUE)` stays negative."""
        h = int(hash_columns([object_array([str(value)])], n=1)[0])
        return h if h == -(1 << 31) else abs(h)

    @staticmethod
    def _answer_str(answer) -> str:
        """The course's text of an answer (`Class-Utility-Methods.py:
        197-203`): None "null", booleans in lower case, else str()."""
        if answer is None:
            return "null"
        if answer is True:
            return "true"
        if answer is False:
            return "false"
        return str(answer)

    def validate_your_answer(self, what: str, expected_hash: int,
                             answer) -> bool:
        got = self.to_hash(self._answer_str(answer))
        passed = got == expected_hash
        self.results.append({"what": what, "passed": passed,
                             "expected": expected_hash, "got": got})
        print(f"Validate {what}: "
              f"{'passed' if passed else f'FAILED (hash {got})'}")
        return passed

    def validate_your_schema(self, what: str, df,
                             expected: Dict[str, str]) -> bool:
        actual = {f.name: f.dataType.simpleString() for f in df.schema.fields}
        missing = {k: v for k, v in expected.items() if actual.get(k) != v}
        passed = not missing
        self.results.append({"what": what, "passed": passed,
                             "expected": expected, "got": actual})
        print(f"Validate schema {what}: "
              f"{'passed' if passed else f'FAILED {missing}'}")
        return passed

    def summarize_your_results(self) -> str:
        lines = ["<html><body><table>",
                 "<tr><th>Test</th><th>Result</th></tr>"]
        for r in self.results:
            lines.append(f"<tr><td>{r['what']}</td>"
                         f"<td>{'passed' if r['passed'] else 'FAILED'}"
                         f"</td></tr>")
        lines.append("</table></body></html>")
        n_pass = sum(r["passed"] for r in self.results)
        print(f"{n_pass}/{len(self.results)} tests passed")
        return "\n".join(lines)

    @property
    def all_passed(self) -> bool:
        return all(r["passed"] for r in self.results)


_results = TestResults()
toHash = TestResults.to_hash
validateYourAnswer = _results.validate_your_answer
validateYourSchema = _results.validate_your_schema
summarizeYourResults = _results.summarize_your_results


def log_your_test(dir_path: str, name: str, value: float) -> None:
    """The grading log (`Class-Utility-Methods.py:233-256`): one CSV a
    test, `name,value`."""
    os.makedirs(dir_path, exist_ok=True)
    clean = re.sub(r"[^a-zA-Z0-9]", "_", name)
    write_csv_file({"name": object_array([name]),
                    "value": np.asarray([float(value)])},
                   os.path.join(dir_path, f"{clean}.csv"))


def load_your_test_results(dir_path: str):
    """Every logged test, in file-name order, as a port DataFrame of
    `name` and `value` (the JAX package returns a pandas frame)."""
    parts = [read_csv_block(os.path.join(dir_path, f), ",", True, True)
             for f in sorted(os.listdir(dir_path)) if f.endswith(".csv")]
    block = concat_blocks(parts) if parts else \
        {"name": object_array([]), "value": object_array([])}
    return DataFrame.from_block(block, session=get_session(),
                                num_partitions=1)


def load_your_test_map(dir_path: str) -> Dict[str, float]:
    rows = load_your_test_results(dir_path).collect()
    return {r["name"]: r["value"] for r in rows}


# ------------------------------------------------------------ readiness
def until_stream_is_ready(query, min_batches: int = 2,
                          timeout_s: float = 60.0) -> None:
    """Poll a streaming query until it has run `min_batches` batches
    (`Classroom-Setup.py:96-110`); TimeoutError after `timeout_s`."""
    start = wallclock()
    while wallclock() - start < timeout_s:
        if getattr(query, "isActive", False) and \
                len(getattr(query, "recentProgress", [])) >= min_batches:
            return
        time.sleep(0.2)
    raise TimeoutError("stream did not become ready in time")


untilStreamIsReady = until_stream_is_ready


def wait_for_model(name: str, version: int, stage: Optional[str] = None,
                   timeout_s: float = 60.0):
    """Registry-readiness polling (`Labs/ML 05L:179-199`): the model
    version once it is READY (and in `stage`, when given); TimeoutError
    after `timeout_s`."""
    from . import tracking
    client = tracking.MlflowClient()
    start = wallclock()
    while wallclock() - start < timeout_s:
        try:
            mv = client.get_model_version(name, version)
            if mv.status == "READY" and (stage is None or
                                         mv.current_stage == stage):
                return mv
        except ValueError:
            pass
        time.sleep(0.2)
    raise TimeoutError(f"model {name}/{version} not ready after {timeout_s}s")


def all_done(namespace: Dict[str, Any]) -> str:
    """Name what a lesson defined (`Class-Utility-Methods.py:297-351`)."""
    names = sorted(k for k in namespace if not k.startswith("_"))
    print(f"All done! Defined: {', '.join(names[:20])}")
    return "<b>All done!</b><br/>" + ", ".join(names)
