"""DataFrameReader / DataFrameWriter: the CSV and JSON halves.

The port's copy of `sml_tpu/frame/io.py` on the standard library's
`csv` and `json` (the JAX package reads and writes through pandas):

- `spark.read.csv` with header / inferSchema / sep / escape (`ML 01:34`,
  `Labs/ML 00L`): fields are read with `csv`, then typed as pandas'
  `read_csv` types them: pandas' NA strings are NULL; a column is int64
  when every field is an integer and none is NULL, else float64 when
  every non-NULL field is a number (parsed by pandas' own float parser,
  `xstrtod`, so the values are pandas' bits), else bool when every
  field is True/False text and none is NULL, else text. Without
  inferSchema every column is text.
- `spark.read.json`: JSON lines or one JSON array, columns in order of
  first appearance, typed as pandas types a list of dicts.
- The writers write one part file a partition (`part-00000.csv`, ...)
  and `_SUCCESS`, formatting cells as pandas' `to_csv` and `to_json
  (orient="records", lines=True)` do. The CSV writer also honours the
  `sep` option (Spark's); the JAX package's ignores it.
- Parquet through the port's own codec (`frame/parquet/`): every part
  file of a path read sorted, each a partition; writes of
  `part-%05d.snappy.parquet` a partition plus `_SUCCESS`, numbered on
  from the files there under `append`; `partitionBy` writes `k=v`
  directories of parquet whatever the format (the JAX package's rule),
  NULL keys as `k=nan`. `format("delta")` reads and writes through
  `delta/table.py`.
- `ParquetChunkSource` / `read_parquet_chunks`: parquet files streamed
  as `chunk_rows` blocks for the out-of-core fits, one row group read
  at a time.
"""

from __future__ import annotations

import csv as _csv
import glob
import json as _json
import os
import re
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..native.hashing import null_mask
from . import parquet as _pq
from ._chunks import ChunkSource
from .column import Block, block_len, infer_objects, object_array
from .dataframe import DataFrame, _key_tuples, coerce_to_schema, take_rows
from .types import StructType, parse_schema

#: pandas' default NA strings (`pandas._libs.parsers.STR_NA_VALUES`)
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}
_INF = {"inf": np.inf, "+inf": np.inf, "infinity": np.inf,
        "+infinity": np.inf, "-inf": -np.inf, "-infinity": -np.inf}
_INT = re.compile(r"\s*[+-]?[0-9]+\s*\Z")
_POW10 = [float(f"1e{k}") for k in range(309)]


def _to_bool(v) -> bool:
    return str(v).strip().lower() in ("true", "1", "yes")


def xstrtod(text: str) -> Optional[float]:
    """pandas' C parser's float (`precise_xstrtod`, what `read_csv` uses
    by default), or None where it takes the text for no number: at most
    17 digits are kept (a leading zero counts), the mantissa is built in
    a double and scaled by one power of ten."""
    s = text.lstrip(" \t\n\r\f\v")
    i, n = 0, len(s)
    neg = False
    if i < n and s[i] in "+-":
        neg = s[i] == "-"
        i += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while i < n and s[i].isdigit() and s[i].isascii():
        if digits < 17:
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        while digits < 17 and i < n and s[i].isdigit() and s[i].isascii():
            number = number * 10.0 + (ord(s[i]) - 48)
            i += 1
            digits += 1
            decimals += 1
        while i < n and s[i].isdigit() and s[i].isascii():
            i += 1
        exponent -= decimals
    if digits == 0:
        return None
    if neg:
        number = -number
    if i < n and s[i] in "eE":
        j = i + 1
        eneg = False
        if j < n and s[j] in "+-":
            eneg = s[j] == "-"
            j += 1
        e, edigits = 0, 0
        while edigits < 17 and j < n and s[j].isdigit() and s[j].isascii():
            e = e * 10 + (ord(s[j]) - 48)
            edigits += 1
            j += 1
        if edigits:
            exponent += -e if eneg else e
            i = j
    if exponent > 308:
        return None
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        if exponent < -616:
            number = 0.0
        else:
            number /= _POW10[-308 - exponent]
            number /= _POW10[308]
    else:
        number /= _POW10[-exponent]
    if number in (np.inf, -np.inf):
        return None
    if s[i:].strip(" \t\n\r\f\v"):
        return None
    return number


def _as_float(text: str) -> Optional[float]:
    got = xstrtod(text)
    return got if got is not None else _INF.get(text.lower())


def infer_column(fields: List[Optional[str]]) -> np.ndarray:
    """One CSV column (None for a NULL field) typed as pandas'
    `read_csv` types it."""
    present = [f for f in fields if f is not None]
    has_na = len(present) < len(fields)
    if not present:
        return np.full(len(fields), np.nan)
    if not has_na and all(_INT.match(f) for f in present):
        ints = [int(f) for f in present]
        if all(-2 ** 63 <= v < 2 ** 63 for v in ints):
            return np.asarray(ints, dtype=np.int64)
        if all(0 <= v < 2 ** 64 for v in ints):
            return np.asarray(ints, dtype=np.uint64)
    floats = []
    for f in present:
        v = _as_float(f)
        if v is None:
            break
        floats.append(v)
    else:
        it = iter(floats)
        return np.asarray([np.nan if f is None else next(it)
                           for f in fields], dtype=np.float64)
    if all(f in _TRUE or f in _FALSE for f in present):
        vals = [None if f is None else f in _TRUE for f in fields]
        return np.asarray(vals, dtype=bool) if not has_na \
            else object_array(vals)
    return object_array(fields)


def _mangle(names: List[str]) -> List[str]:
    """pandas' header names: an empty one "Unnamed: i", a repeat "a.1"."""
    out, seen = [], set()
    for i, name in enumerate(names):
        name = name or f"Unnamed: {i}"
        base, k = name, 0
        while name in seen:
            k += 1
            name = f"{base}.{k}"
        seen.add(name)
        out.append(name)
    return out


def read_csv_block(path: str, sep: str, header: bool, infer: bool,
                   escape: Optional[str] = None) -> Block:
    """One CSV file as a block (pandas' `read_csv(sep=sep, header=0 or
    None)`, with `dtype=str` when not inferring)."""
    kw: Dict[str, Any] = {"delimiter": sep, "quotechar": '"',
                          "doublequote": True}
    if escape and escape != '"':
        kw["escapechar"] = escape
    with open(path, newline="", encoding="utf-8") as fh:
        rows = [r for r in _csv.reader(fh, **kw) if r]
    if header:
        names, rows = (_mangle(rows[0]) if rows else []), rows[1:]
    else:
        width = max((len(r) for r in rows), default=0)
        names = [f"_c{i}" for i in range(width)]
    width = len(names)
    cols: List[List[Optional[str]]] = [[] for _ in names]
    for r in rows:
        if len(r) > width:
            raise ValueError(f"{path}: expected {width} fields, saw "
                             f"{len(r)}")
        for j in range(width):
            v = r[j] if j < len(r) else ""
            cols[j].append(None if v in NA_VALUES else v)
    if infer:
        return {n: infer_column(c) for n, c in zip(names, cols)}
    return {n: object_array(c) for n, c in zip(names, cols)}


def read_json_block(path: str) -> Block:
    """One JSON file (lines, or one array) as pandas' `json_normalize(
    rows, max_level=0)` types it."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read().strip()
    if text.startswith("["):
        rows = _json.loads(text)
    else:
        rows = [_json.loads(line) for line in text.splitlines()
                if line.strip()]
    names: Dict[str, None] = {}
    for r in rows:
        names.update(dict.fromkeys(r))
    return {n: infer_objects(object_array([r.get(n) for r in rows]))
            for n in names}


class DataFrameReader:
    def __init__(self, session):
        self._session = session
        self._format = "parquet"
        self._options: Dict[str, Any] = {}
        self._schema: Optional[StructType] = None

    def format(self, source: str) -> "DataFrameReader":  # noqa: A003
        self._format = source.lower()
        return self

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def options(self, **opts) -> "DataFrameReader":
        self._options.update(opts)
        return self

    def schema(self, s: Union[str, StructType]) -> "DataFrameReader":
        self._schema = parse_schema(s)
        return self

    def load(self, path: Optional[str] = None) -> DataFrame:
        if self._format == "delta":
            from ..delta.table import read_delta
            return read_delta(path, self._session, self._options)
        if self._format == "parquet":
            return self.parquet(path)
        if self._format == "csv":
            return self.csv(path)
        if self._format == "json":
            return self.json(path)
        raise ValueError(f"unknown format {self._format}")

    def csv(self, path: str, header: Optional[bool] = None,
            sep: Optional[str] = None, inferSchema: Optional[bool] = None,
            multiLine: Optional[bool] = None, escape: Optional[str] = None,
            schema: Optional[Union[str, StructType]] = None) -> DataFrame:
        o = self._options
        header = header if header is not None \
            else _to_bool(o.get("header", False))
        sep = sep or o.get("sep", o.get("delimiter", ","))
        infer = inferSchema if inferSchema is not None \
            else _to_bool(o.get("inferSchema", False))
        escape = escape or o.get("escape", None)
        if schema is not None:
            self._schema = parse_schema(schema)
        parts = []
        for f in _expand(path, (".csv", ".txt", ".tsv")):
            block = read_csv_block(f, sep, header,
                                   infer and self._schema is None, escape)
            if self._schema is not None:
                block = coerce_to_schema(block, self._schema)
            parts.append(block)
        return self._spread(parts)

    def json(self, path: str) -> DataFrame:
        return self._spread([read_json_block(f)
                             for f in _expand(path, (".json",))])

    def parquet(self, path: str) -> DataFrame:
        return self._spread([_pq.read_table(f)
                             for f in _expand(path, (".parquet",))],
                            split_single=False)

    def delta(self, path: str) -> DataFrame:
        return self.format("delta").load(path)

    def table(self, name: str) -> DataFrame:
        return self._session.table(name)

    def _spread(self, parts: List[Block],
                split_single: bool = True) -> DataFrame:
        if len(parts) == 1 and split_single:
            return DataFrame.from_block(parts[0], session=self._session)
        return DataFrame.from_partitions(parts or [{}],
                                         session=self._session)


# ------------------------------------------------------------ cell formats
def _csv_cells(v: np.ndarray) -> List[str]:
    """A column's cells as pandas' `to_csv` writes them."""
    if v.ndim == 2:
        from ..ml.linalg import DenseVector
        return [str(DenseVector(r)) for r in v]
    nulls = null_mask(v)
    kind = v.dtype.kind
    if kind == "f":
        text = [str(x) for x in v] if v.dtype.itemsize == 4 \
            else [repr(x) for x in v.tolist()]
    elif kind == "M":
        us = v.astype("datetime64[us]")
        ok = us[~nulls].astype(np.int64)
        if not (ok % 86_400_000_000).any():
            fmt = "%Y-%m-%d"
        elif not (ok % 1_000_000).any():
            fmt = "%Y-%m-%d %H:%M:%S"
        elif not (ok % 1000).any():
            fmt = "ms"
        else:
            fmt = "%Y-%m-%d %H:%M:%S.%f"
        text = [None if nulls[i] else (x.strftime(fmt) if fmt != "ms"
                                       else x.strftime("%Y-%m-%d %H:%M:%S.%f")
                                       [:-3])
                for i, x in enumerate(us.tolist())]
    else:
        text = [str(x) for x in v.tolist()]
    return ["" if nulls[i] else t for i, t in enumerate(text)]


def write_csv_file(block: Block, path: str, sep: str = ",",
                   header: bool = True) -> None:
    """One block as one CSV file, as pandas' `to_csv(path, index=False,
    sep=sep)` writes it."""
    cols = [_csv_cells(v) for v in block.values()]
    with open(path, "w", newline="", encoding="utf-8") as fh:
        w = _csv.writer(fh, delimiter=sep, lineterminator="\n")
        if header:
            w.writerow(list(block))
        w.writerows(zip(*cols))


def _ujson_float(x: float) -> str:
    """A float as pandas' `to_json` writes it (ujson at its default
    double_precision of 10)."""
    neg, v = x < 0, abs(x)
    if v > 1e16 - 1 or (v != 0.0 and v < 1e-15):
        return "%.10g" % x
    whole = int(v)
    tmp = (v - whole) * 1e10
    frac = int(tmp)
    diff = tmp - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= 10 ** 10:
        frac, whole = 0, whole + 1
    if frac:
        digits = str(frac).rjust(10, "0").rstrip("0")
        out = f"{whole}.{digits}"
    else:
        out = f"{whole}.0"
    return "-" + out if neg else out


def _json_cell(x) -> str:
    if x is None or (isinstance(x, float) and x != x):
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        return _ujson_float(x)
    if isinstance(x, (list, tuple)):
        return "[" + ",".join(_json_cell(y) for y in x) + "]"
    return _json.dumps(str(x)).replace("/", "\\/")


def _json_cells(v: np.ndarray) -> List[str]:
    if v.ndim == 2:
        return [_json_cell(r) for r in v.tolist()]
    if v.dtype.kind == "M":  # epoch milliseconds
        ms = v.astype("datetime64[ms]")
        return ["null" if np.isnat(x) else str(int(x.astype(np.int64)))
                for x in ms]
    nulls = null_mask(v)
    return ["null" if nulls[i] else _json_cell(x)
            for i, x in enumerate(v.tolist())]


class DataFrameWriter:
    def __init__(self, df: DataFrame):
        self._df = df
        self._format = "parquet"
        self._mode = "errorifexists"
        self._options: Dict[str, Any] = {}
        self._partition_by: List[str] = []

    def format(self, source: str) -> "DataFrameWriter":  # noqa: A003
        self._format = source.lower()
        return self

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m.lower()
        return self

    def option(self, key: str, value) -> "DataFrameWriter":
        self._options[key] = value
        return self

    def options(self, **opts) -> "DataFrameWriter":
        self._options.update(opts)
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def repartition(self, n: int) -> "DataFrameWriter":
        self._df = self._df.repartition(n)
        return self

    def save(self, path: str) -> None:
        if self._format == "delta":
            from ..delta.table import write_delta
            write_delta(self._df, path, mode=self._mode,
                        options=self._options,
                        partition_by=self._partition_by)
            return
        if self._format not in ("csv", "json", "parquet"):
            raise ValueError(f"unknown format {self._format}")
        if os.path.exists(path):
            if self._mode in ("error", "errorifexists"):
                raise FileExistsError(f"path already exists: {path}")
            if self._mode == "ignore":
                return
            if self._mode == "overwrite":
                import shutil
                shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path, exist_ok=True)
        parts = self._df._materialize()
        if self._partition_by:
            self._save_partitioned(path, parts)
            return
        existing = len(glob.glob(os.path.join(path, "part-*"))) \
            if self._mode == "append" else 0
        for i, p in enumerate(parts):
            name = os.path.join(path, f"part-{existing + i:05d}")
            if self._format == "csv":
                self._write_csv(p, name + ".csv")
            elif self._format == "json":
                self._write_json(p, name + ".json")
            else:
                _pq.write_table(p, name + ".snappy.parquet")
        open(os.path.join(path, "_SUCCESS"), "w").close()

    def _save_partitioned(self, path: str, parts) -> None:
        import uuid
        from .dataframe import concat_blocks
        for texts, body in partition_groups(concat_blocks(parts),
                                            self._partition_by):
            sub = os.path.join(path, *[f"{k}={t}" for k, t in
                                       zip(self._partition_by, texts)])
            os.makedirs(sub, exist_ok=True)
            # a unique name, so that append never overwrites a part
            _pq.write_table(body, os.path.join(
                sub, f"part-{uuid.uuid4().hex[:12]}.snappy.parquet"))
        open(os.path.join(path, "_SUCCESS"), "w").close()

    def _write_csv(self, block: Block, path: str) -> None:
        write_csv_file(block, path,
                       self._options.get("sep",
                                         self._options.get("delimiter", ",")),
                       _to_bool(self._options.get("header", False)))

    def _write_json(self, block: Block, path: str) -> None:
        names = [_json_cell(c) for c in block]
        cols = [_json_cells(v) for v in block.values()]
        lines = ["{" + ",".join(f"{n}:{c}" for n, c in zip(names, row)) + "}"
                 for row in zip(*cols)] if block_len(block) else []
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + ("\n" if lines else ""))

    def parquet(self, path: str, mode: Optional[str] = None) -> None:
        if mode:
            self._mode = mode.lower()
        self.format("parquet").save(path)

    def delta(self, path: str) -> None:
        self.format("delta").save(path)

    def csv(self, path: str, mode: Optional[str] = None,
            header: bool = False) -> None:
        if mode:
            self._mode = mode.lower()
        self._options.setdefault("header", header)
        self.format("csv").save(path)

    def json(self, path: str, mode: Optional[str] = None) -> None:
        if mode:
            self._mode = mode.lower()
        self.format("json").save(path)

    def saveAsTable(self, name: str) -> None:
        session = self._df._session
        if session is None:
            raise RuntimeError("no session")
        path = session.catalog._table_path(name)
        self.save(path)
        session.catalog._register_table(name, path, self._format)


def partition_text(v) -> str:
    """A partition value as its `k=v` directory names it (pandas'
    `str` of the group key: NULL is "nan")."""
    if v is None or (isinstance(v, float) and v != v):
        return "nan"
    return str(v)


def partition_groups(block: Block, keys: List[str]):
    """[(the key texts, the group's rows without the key columns)], the
    groups in order of first appearance (pandas' `groupby(sort=False,
    dropna=False)`)."""
    rows: Dict[tuple, List[int]] = {}
    for i, key in enumerate(_key_tuples(block, keys)):
        rows.setdefault(key, []).append(i)
    rest = {c: v for c, v in block.items() if c not in keys}
    out = []
    for key, idx in rows.items():
        first = idx[0]
        texts = [partition_text(block[k][first]) for k in keys]
        out.append((texts, take_rows(rest, np.asarray(idx, np.int64))))
    return out


class ParquetChunkSource(ChunkSource):
    """A `ChunkSource` over parquet part files that never holds a whole
    file: each file's row groups are read one at a time and cut into
    `chunk_rows` blocks, each a (rows, F) float64 matrix of the feature
    columns and the label column, if any. Files come in the order
    `read.parquet` reads them, so the rows come in the materialized
    frame's order."""

    def __init__(self, path: str, feature_cols: List[str],
                 label_col: Optional[str] = None,
                 chunk_rows: Optional[int] = None):
        self._files = _expand(path, (".parquet",))
        self.feature_cols = list(feature_cols)
        self.label_col = label_col
        self._chunk_rows = int(chunk_rows) if chunk_rows else None
        self.n_features = len(self.feature_cols)
        self.n_rows: Optional[int] = None

    def _iter_chunks(self):
        cols = self.feature_cols + ([self.label_col] if self.label_col
                                    else [])
        for f in self._files:
            for block in _pq.ParquetFile(f).iter_blocks(self.chunk_rows,
                                                        cols):
                X = np.column_stack([np.asarray(block[c], np.float64)
                                     for c in self.feature_cols])
                y = np.asarray(block[self.label_col], np.float64) \
                    if self.label_col else None
                yield X, y

    def fingerprint(self):
        sig = tuple((f, os.path.getmtime(f), os.path.getsize(f))
                    for f in self._files)
        return ("parquet", sig, tuple(self.feature_cols), self.label_col,
                self.chunk_rows)


def read_parquet_chunks(path: str, featureCols: List[str],
                        labelCol: Optional[str] = None,
                        chunkRows: Optional[int] = None
                        ) -> ParquetChunkSource:
    """A parquet file, directory or glob as a chunk source of the
    out-of-core fits (`ml/_chunked.py`, `fit_chunked`)."""
    return ParquetChunkSource(path, featureCols, labelCol, chunkRows)


def _expand(path: str, exts) -> List[str]:
    """Path may be a file, a directory of part-files, or a glob."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                if f.startswith(("_", ".")):
                    continue
                if any(f.endswith(e) for e in exts) or "." not in f:
                    out.append(os.path.join(root, f))
        if out:
            return out
        raise FileNotFoundError(f"no data files under {path}")
    hits = sorted(glob.glob(path))
    if hits:
        return hits
    raise FileNotFoundError(path)
