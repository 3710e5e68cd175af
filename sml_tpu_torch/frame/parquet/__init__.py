"""Parquet files, read and written by the port's own codec.

The JAX package reads and writes parquet through pyarrow
(`sml_tpu/frame/io.py`, `sml_tpu/delta/table.py`); the card's machine
has no pyarrow, so the port keeps this codec: the Thrift compact footer
and page headers (`_thrift.py`), the PLAIN, dictionary and RLE /
bit-packed encodings and page compression (`_encoding.py`), and the
`ARROW:schema` footer key pyarrow restores types from (`_arrow.py`).

Columns map to the frame's numpy columns (`frame/types.py`):

=====================  =============================================
frame column           parquet (every field OPTIONAL)
=====================  =============================================
float64 / float32      DOUBLE / FLOAT; NaN is NULL
int64 / int32          INT64 / INT32 (int8/16 and unsigned annotated)
bool                   BOOLEAN
text (object)          BYTE_ARRAY, STRING; None is NULL
bytes (object)         BYTE_ARRAY
datetime64[D]          INT32 DATE
datetime64[s/ms/us/ns] INT64 TIMESTAMP (MILLIS / MICROS / NANOS),
                       not adjusted to UTC
vector (2-D float)     the 3-level list<float> (`_pandas_to_arrow`'s
                       f32 rounding); a row of NaN is a NULL list
all-NULL (object)      INT32 of the Null logical type
=====================  =============================================

The writer writes one SNAPPY data page (v1, PLAIN values, RLE levels)
per column of a row group, row groups of at most `ROW_GROUP_ROWS` rows. The reader also takes dictionary pages with
dictionary-encoded (`PLAIN_DICTIONARY`, `RLE_DICTIONARY`) data pages
before PLAIN ones, data page v2, several pages and row groups, INT96
timestamps, REQUIRED columns and legacy converted types. Reading back:
a NULL in an integer column makes it float64 (NaN), in a boolean column
an object column (None), as pandas reads them; a list column whose rows
are all of one length is a 2-D float64 vector block, else an object
column of arrays. Nested types other than a list of a primitive raise
NotImplementedError naming the column.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..column import Block, block_len, object_array
from . import _arrow as A
from . import _encoding as E
from ._thrift import read_struct, write_struct

MAGIC = b"PAR1"
ROW_GROUP_ROWS = 1 << 20  # pyarrow's default
CREATED_BY = "sml_tpu_torch parquet writer"
_OPTIONAL, _REQUIRED, _REPEATED = 1, 0, 2
_DATA_PAGE, _DICT_PAGE, _DATA_PAGE_V2 = 0, 2, 3
_TIME_UNIT = {1: "ms", 2: "us", 3: "ns"}
_INT_CONVERTED = {11: (8, False), 12: (16, False), 13: (32, False),
                  14: (64, False), 15: (8, True), 16: (16, True),
                  17: (32, True), 18: (64, True)}


# ------------------------------------------------------------------ schema
class ColumnSpec:
    """One top-level field of a file: a primitive leaf ("flat"), or a
    list of a primitive ("list"), with its leaf's path, type and
    levels."""

    def __init__(self, name: str, kind: str, path: Tuple[str, ...],
                 leaf: dict, max_def: int, max_rep: int,
                 def_list: int = 0, def_rep: int = 0):
        self.name = name
        self.kind = kind
        self.path = path
        self.ptype = leaf.get(1)
        self.type_length = leaf.get(2, 0)
        self.value_kind = _value_kind(leaf, name)
        self.max_def = max_def
        self.max_rep = max_rep
        self.def_list = def_list  # lowest level at which the list is there
        self.def_rep = def_rep    # lowest level at which an element is


def _value_kind(el: dict, name: str) -> str:
    """What a leaf's values are: "text", "binary", "bool", "int<bits>",
    "uint<bits>", "float32", "float64", "date", "ts_<unit>", "null" or
    "raw"."""
    ptype, logical, conv = el.get(1), el.get(10) or {}, el.get(6)
    if 5 in logical or conv == 5:
        raise NotImplementedError(f"parquet column {name!r}: DECIMAL is "
                                  f"not supported")
    if 11 in logical:
        return "null"
    if ptype == E.BYTE_ARRAY:
        return "text" if (1 in logical or 4 in logical or 12 in logical
                          or conv in (0, 4, 19)) else "binary"
    if ptype == E.FIXED:
        return "binary"
    if ptype == E.BOOLEAN:
        return "bool"
    if ptype == E.FLOAT:
        return "float32"
    if ptype == E.DOUBLE:
        return "float64"
    if ptype == E.INT96:
        return "ts_ns"
    if 6 in logical or conv == 6:
        return "date"
    if 8 in logical:
        unit = next(iter(logical[8].get(2, {1: {}})))
        return "ts_" + _TIME_UNIT[unit]
    if conv in (9, 10):
        return "ts_ms" if conv == 9 else "ts_us"
    if 10 in logical:
        bits, signed = logical[10].get(1, 64), logical[10].get(2, True)
        return ("int" if signed else "uint") + str(bits)
    if conv in _INT_CONVERTED:
        bits, signed = _INT_CONVERTED[conv]
        return ("int" if signed else "uint") + str(bits)
    return "int32" if ptype == E.INT32 else "int64"


def _columns(elements: List[dict]) -> List[ColumnSpec]:
    """The top-level fields of a flattened schema (depth first, each
    group followed by its children)."""
    out, pos = [], 1
    for _ in range(elements[0].get(5, 0)):
        el = elements[pos]
        name = el[4].decode("utf-8")
        rep = el.get(3, _REQUIRED)
        d0 = int(rep != _REQUIRED)
        if not el.get(5):  # a primitive leaf
            if rep == _REPEATED:  # legacy: a repeated primitive is a list
                out.append(ColumnSpec(name, "list", (name,), el, 1, 1, 0, 1))
            else:
                out.append(ColumnSpec(name, "flat", (name,), el, d0, 0))
            pos += 1
            continue
        mid = elements[pos + 1]
        if el[5] != 1 or mid.get(3) != _REPEATED:
            raise NotImplementedError(f"parquet column {name!r}: nested "
                                      f"types other than a list are not "
                                      f"supported")
        mid_name = mid[4].decode("utf-8")
        if not mid.get(5):  # two-level list: repeated primitive
            out.append(ColumnSpec(name, "list", (name, mid_name), mid,
                                  d0 + 1, 1, d0, d0 + 1))
            pos += 2
            continue
        leaf = elements[pos + 2]
        if mid[5] != 1 or leaf.get(5):
            raise NotImplementedError(f"parquet column {name!r}: nested "
                                      f"types other than a list of a "
                                      f"primitive are not supported")
        d_leaf = d0 + 1 + int(leaf.get(3, _REQUIRED) != _REQUIRED)
        out.append(ColumnSpec(name, "list",
                              (name, mid_name, leaf[4].decode("utf-8")),
                              leaf, d_leaf, 1, d0, d0 + 1))
        pos += 3
    return out


# ------------------------------------------------------------------ reader
class ParquetFile:
    """A parquet file's footer, and its row groups read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size < 12:
                raise ValueError(f"{path}: not a parquet file "
                                 f"({size} bytes)")
            fh.seek(size - 8)
            tail = fh.read(8)
            if tail[4:] != MAGIC:
                what = "an encrypted" if tail[4:] == b"PARE" else "not a"
                raise ValueError(f"{path}: {what} parquet file")
            n = int.from_bytes(tail[:4], "little")
            fh.seek(size - 8 - n)
            meta, _ = read_struct(fh.read(n))
        self.meta = meta
        self.num_rows = int(meta.get(3, 0))
        self.columns = _columns(meta[2])
        self.row_groups = meta.get(4, [])

    def read_row_group(self, i: int,
                       columns: Optional[Sequence[str]] = None) -> Block:
        rg = self.row_groups[i]
        chunks = {tuple(p.decode("utf-8") for p in c[3][3]): c[3]
                  for c in rg[1]}
        with open(self.path, "rb") as fh:
            return {spec.name: _read_chunk(fh, spec, chunks[spec.path])
                    for spec in self._select(columns)}

    def read(self, columns: Optional[Sequence[str]] = None) -> Block:
        """Every row group's rows of `columns` (all by default)."""
        parts = [self.read_row_group(i, columns)
                 for i in range(len(self.row_groups))]
        if not parts:
            return {s.name: _empty(s) for s in self._select(columns)}
        return {c: _concat([p[c] for p in parts]) for c in parts[0]}

    def iter_blocks(self, rows: int, columns: Optional[Sequence[str]] = None
                    ) -> Iterator[Block]:
        """Blocks of `rows` rows (the last one shorter), across row
        groups, reading one row group at a time."""
        pending: List[Block] = []
        have = 0
        for i in range(len(self.row_groups)):
            pending.append(self.read_row_group(i, columns))
            have += block_len(pending[-1])
            while have >= rows:
                whole = _concat_blocks(pending)
                yield {c: v[:rows] for c, v in whole.items()}
                rest = {c: v[rows:] for c, v in whole.items()}
                pending, have = [rest], have - rows
        if have:
            yield _concat_blocks(pending)

    def _select(self, columns) -> List[ColumnSpec]:
        if columns is None:
            return self.columns
        by_name = {c.name: c for c in self.columns}
        missing = [c for c in columns if c not in by_name]
        if missing:
            raise KeyError(f"{self.path}: no column {missing[0]!r}")
        return [by_name[c] for c in columns]


def _concat(parts: List[np.ndarray]) -> np.ndarray:
    kinds = {p.dtype.kind for p in parts}
    if len(kinds) > 1 or len({p.shape[1:] for p in parts}) > 1:
        # e.g. int64 in one row group, float64 (a NULL) in another
        if kinds <= set("iuf") and all(p.ndim == 1 for p in parts):
            return np.concatenate([p.astype(np.float64) for p in parts])
        return object_array([x for p in parts for x in _rows(p)])
    return np.concatenate(parts)


def _rows(v: np.ndarray) -> list:
    if v.ndim == 2:
        return [None if np.isnan(r).all() else r for r in v]
    return v.tolist()


def _concat_blocks(parts: List[Block]) -> Block:
    return {c: _concat([p[c] for p in parts]) for c in parts[0]}


def _empty(spec: ColumnSpec) -> np.ndarray:
    if spec.kind == "list":
        return np.zeros((0, 0))
    return _assemble_flat(spec, None, _no_values(spec))


def _no_values(spec: ColumnSpec):
    k = spec.value_kind
    if k in ("text", "binary", "null"):
        return object_array([])
    return np.zeros(0, {"bool": bool, "float32": np.float32,
                        "float64": np.float64, "date": np.int32,
                        "int32": np.int32}.get(k, np.int64))


def _read_chunk(fh, spec: ColumnSpec, meta: dict) -> np.ndarray:
    codec = meta[4]
    start = meta[9]
    dict_off = meta.get(11)
    if dict_off is not None and 0 < dict_off < start:
        start = dict_off
    fh.seek(start)
    buf = fh.read(meta[7])
    want = meta[5]
    text = spec.value_kind == "text"
    dictionary = None
    defs, reps, values = [], [], []
    got, pos = 0, 0
    while got < want:
        if pos >= len(buf):
            raise ValueError(f"{spec.name}: column chunk ends after {got} "
                             f"of {want} values")
        header, pos = read_struct(buf, pos)
        ptype, usize, csize = header[1], header[2], header[3]
        body = buf[pos:pos + csize]
        pos += csize
        if ptype == _DICT_PAGE:
            page = E.decompress(codec, body, usize)
            dictionary, _ = E.decode_plain(page, 0, spec.ptype, header[7][1],
                                           spec.type_length, text)
            dictionary = _as_array(dictionary)
            continue
        if ptype == _DATA_PAGE:
            h = header[5]
            count, enc = h[1], h[2]
            page = E.decompress(codec, body, usize)
            p = 0
            r = d = None
            if spec.max_rep:
                ln = int.from_bytes(page[p:p + 4], "little")
                r = E.decode_hybrid(page, p + 4, p + 4 + ln,
                                    E.bit_width(spec.max_rep), count)
                p += 4 + ln
            if spec.max_def:
                ln = int.from_bytes(page[p:p + 4], "little")
                d = E.decode_hybrid(page, p + 4, p + 4 + ln,
                                    E.bit_width(spec.max_def), count)
                p += 4 + ln
        elif ptype == _DATA_PAGE_V2:
            h = header[8]
            count, enc = h[1], h[4]
            rlen, dlen = h[6], h[5]
            r = d = None
            if spec.max_rep:
                r = E.decode_hybrid(body, 0, rlen, E.bit_width(spec.max_rep),
                                    count)
            if spec.max_def:
                d = E.decode_hybrid(body, rlen, rlen + dlen,
                                    E.bit_width(spec.max_def), count)
            rest = body[rlen + dlen:]
            page = E.decompress(codec, rest, usize - rlen - dlen) \
                if h.get(7, True) else rest
            p = 0
        else:  # an index page
            continue
        present = count if d is None else int((d == spec.max_def).sum())
        if enc in (E.PLAIN_DICTIONARY, E.RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"{spec.name}: dictionary-encoded page "
                                 f"without a dictionary page")
            idx = E.decode_hybrid(page, p + 1, len(page), page[p], present) \
                if present else np.zeros(0, np.int64)
            values.append(dictionary[idx])
        elif enc == E.RLE and spec.ptype == E.BOOLEAN:  # v2 booleans
            ln = int.from_bytes(page[p:p + 4], "little")
            values.append(E.decode_hybrid(page, p + 4, p + 4 + ln, 1,
                                          present).astype(bool))
        elif enc == E.PLAIN:
            vals, _ = E.decode_plain(page, p, spec.ptype, present,
                                     spec.type_length, text)
            values.append(_as_array(vals))
        else:
            raise NotImplementedError(f"{spec.name}: parquet encoding "
                                      f"{enc} is not supported")
        defs.append(d)
        reps.append(r)
        got += count
    vals = _concat(values) if values else _no_values(spec)
    d = np.concatenate(defs) if spec.max_def and defs else None
    if spec.kind == "flat":
        return _assemble_flat(spec, d, vals)
    r = np.concatenate(reps) if reps else np.zeros(0, np.int64)
    return _assemble_list(spec, d, r, vals)


def _as_array(vals) -> np.ndarray:
    return vals if isinstance(vals, np.ndarray) else object_array(vals)


def _typed(spec: ColumnSpec, vals: np.ndarray) -> np.ndarray:
    """Non-NULL values as the frame holds them."""
    k = spec.value_kind
    if k == "date":
        return vals.astype(np.int64).astype("datetime64[D]")
    if k.startswith("ts_"):
        return vals.astype(np.int64).astype(f"datetime64[{k[3:]}]")
    if k.startswith("uint"):
        return vals.astype(f"int{k[4:]}").view(f"uint{k[4:]}")
    if k.startswith("int") and k not in ("int32", "int64"):
        return vals.astype(k)
    return vals


def _assemble_flat(spec: ColumnSpec, d: Optional[np.ndarray],
                   vals: np.ndarray) -> np.ndarray:
    k = spec.value_kind
    n = len(vals) if d is None else len(d)
    if k == "null":
        return object_array([None] * n)
    vals = _typed(spec, vals)
    if d is None or len(vals) == n:
        return vals
    present = d == spec.max_def
    if vals.dtype.kind == "f":
        out = np.full(n, np.nan, vals.dtype)
    elif vals.dtype.kind == "M":
        out = np.full(n, np.datetime64("NaT"), vals.dtype)
    elif vals.dtype.kind in "iu":
        out = np.full(n, np.nan)
    else:  # text, bytes, bool: an object column with None
        out = object_array([None] * n)
        vals = object_array(vals.tolist()) if vals.dtype.kind == "b" \
            else vals
    out[present] = vals
    return out


def _assemble_list(spec: ColumnSpec, d: Optional[np.ndarray],
                   r: np.ndarray, vals: np.ndarray) -> np.ndarray:
    m = len(r)
    if d is None:
        d = np.full(m, spec.max_def)
    starts = r == 0
    row = np.cumsum(starts) - 1
    n = int(starts.sum())
    has_list = d[starts] >= spec.def_list
    has_elem = d >= spec.def_rep
    lengths = np.bincount(row[has_elem], minlength=n)
    vals = _typed(spec, vals)
    numeric = vals.dtype.kind in "fiu"
    elems = np.full(int(has_elem.sum()), np.nan) if numeric \
        else object_array([None] * int(has_elem.sum()))
    elems[(d == spec.max_def)[has_elem]] = vals
    widths = set(lengths[has_list].tolist())
    if numeric and len(widths) <= 1 and not (lengths[~has_list]).any():
        width = widths.pop() if widths else 0
        out = np.full((n, width), np.nan)
        out[has_list] = elems.reshape(-1, width) if width \
            else np.zeros((int(has_list.sum()), 0))
        return out
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    return object_array([elems[bounds[i]:bounds[i + 1]] if has_list[i]
                         else None for i in range(n)])


def read_table(path: str, columns: Optional[Sequence[str]] = None) -> Block:
    """A parquet file's rows as a block of numpy columns."""
    return ParquetFile(path).read(columns)


# ------------------------------------------------------------------ writer
class _ColumnWriter:
    """One frame column's schema elements, Arrow field and page
    values."""

    def __init__(self, name: str, values: np.ndarray):
        self.name = name
        self.is_list = False
        self._prepare(values)

    def _leaf(self, ptype: int, converted=None, logical=None,
              atype: A.ArrowType = None) -> None:
        self.ptype, self.converted, self.logical = ptype, converted, logical
        self.atype = atype

    def _prepare(self, v: np.ndarray) -> None:
        self.v = v
        if v.ndim == 2 or (v.dtype.kind == "O" and _is_list_column(v)):
            self.is_list = True
            self._leaf(E.FLOAT, atype=A.list_type(A.float_type(32)))
            return
        kind = v.dtype.kind
        if kind in "US":
            self.v = v = object_array(v.tolist())
            kind = "O"
        if kind == "O":
            self._prepare_objects(v)
        elif kind == "f":
            if v.dtype.itemsize == 8:
                self._leaf(E.DOUBLE, atype=A.float_type(64))
            else:
                self.v = v.astype(np.float32)
                self._leaf(E.FLOAT, atype=A.float_type(32))
        elif kind == "b":
            self._leaf(E.BOOLEAN, atype=A.ArrowType(A.BOOL))
        elif kind in "iu":
            bits, signed = 8 * v.dtype.itemsize, kind == "i"
            ptype = E.INT64 if bits == 64 else E.INT32
            plain = signed and bits >= 32
            conv = None if plain else \
                {(8, True): 15, (16, True): 16, (8, False): 11,
                 (16, False): 12, (32, False): 13, (64, False): 14}[
                     (bits, signed)]
            logical = None if plain else \
                [(10, "struct", [(1, "i8", bits), (2, "bool", signed)])]
            self._leaf(ptype, conv, logical, A.int_type(bits, signed))
        elif kind == "M":
            unit = np.datetime_data(v.dtype)[0]
            if unit == "D":
                self._leaf(E.INT32, 6, [(6, "struct", [])], A.date_type())
                return
            if unit not in ("s", "ms", "us", "ns"):
                self.v = v = v.astype("datetime64[us]")
                unit = "us"
            stored = {"s": 1, "ms": 1, "us": 2, "ns": 3}[unit]
            logical = [(8, "struct", [(1, "bool", False),
                                      (2, "struct", [(stored, "struct",
                                                      [])])])]
            self._leaf(E.INT64, None, logical, A.timestamp_type(unit))
        else:
            raise TypeError(f"column {self.name!r}: no parquet type for "
                            f"numpy dtype {v.dtype}")

    def _prepare_objects(self, v: np.ndarray) -> None:
        from ...native.hashing import null_mask
        vals = v[~null_mask(v)].tolist()
        if not vals:
            self._leaf(E.INT32, None, [(11, "struct", [])],
                       A.ArrowType(A.NULL))
        elif all(isinstance(x, str) for x in vals):
            self._leaf(E.BYTE_ARRAY, 0, [(1, "struct", [])],
                       A.ArrowType(A.LARGE_UTF8))
        elif all(isinstance(x, bytes) for x in vals):
            self._leaf(E.BYTE_ARRAY, atype=A.ArrowType(A.BINARY))
        elif all(isinstance(x, (bool, np.bool_)) for x in vals):
            self._leaf(E.BOOLEAN, atype=A.ArrowType(A.BOOL))
        elif all(isinstance(x, (int, np.integer)) and
                 not isinstance(x, (bool, np.bool_)) for x in vals):
            self._leaf(E.INT64, atype=A.int_type(64, True))
        elif all(isinstance(x, (int, float, np.integer, np.floating)) and
                 not isinstance(x, (bool, np.bool_)) for x in vals):
            self._leaf(E.DOUBLE, atype=A.float_type(64))
        else:
            raise TypeError(f"column {self.name!r}: mixed or unsupported "
                            f"values ({type(vals[0]).__name__}, ...) for "
                            f"parquet")

    # the schema
    def elements(self) -> List[list]:
        name = self.name
        if not self.is_list:
            return [[(1, "i32", self.ptype), (3, "i32", _OPTIONAL),
                     (4, "binary", name), (6, "i32", self.converted),
                     (10, "struct", self.logical)]]
        return [[(3, "i32", _OPTIONAL), (4, "binary", name),
                 (5, "i32", 1), (6, "i32", 3),
                 (10, "struct", [(3, "struct", [])])],
                [(3, "i32", _REPEATED), (4, "binary", "list"),
                 (5, "i32", 1)],
                [(1, "i32", E.FLOAT), (3, "i32", _OPTIONAL),
                 (4, "binary", "element")]]

    def path(self) -> List[str]:
        return [self.name, "list", "element"] if self.is_list \
            else [self.name]

    def arrow_field(self) -> A.ArrowField:
        return A.ArrowField(self.name, self.atype)

    # the page
    def page(self, lo: int, hi: int) -> Tuple[bytes, int]:
        """(the uncompressed v1 page of rows [lo, hi), its level
        count)."""
        if self.is_list:
            return self._list_page(lo, hi)
        from ...native.hashing import null_mask
        v = self.v[lo:hi]
        nulls = null_mask(v) if v.dtype.kind in "fOM" else \
            np.zeros(len(v), bool)
        d = (~nulls).astype(np.int64)
        levels = E.encode_hybrid(d, 1)
        vals = v[~nulls]
        if self.ptype == E.BYTE_ARRAY:
            vals = [x.encode("utf-8") if isinstance(x, str) else bytes(x)
                    for x in vals.tolist()]
        elif self.ptype == E.BOOLEAN:
            vals = np.asarray(vals.tolist(), dtype=bool)
        elif vals.dtype.kind == "M":
            unit = np.datetime_data(vals.dtype)[0]
            if unit == "D":
                vals = vals.astype(np.int64).astype(np.int32)
            else:
                vals = vals.astype(np.int64) * (1000 if unit == "s" else 1)
        elif vals.dtype.kind == "u" and vals.dtype.itemsize >= 4:
            # UINT_32 / UINT_64 keep their bits in INT32 / INT64
            vals = vals.view(f"int{8 * vals.dtype.itemsize}")
        elif vals.dtype.kind == "O" and self.ptype != E.INT32:
            vals = np.asarray(vals.tolist(),
                              np.int64 if self.ptype == E.INT64
                              else np.float64)
        data = E.encode_plain(vals, self.ptype) \
            if len(vals) or self.ptype == E.BYTE_ARRAY else b""
        return len(levels).to_bytes(4, "little") + levels + data, len(v)

    def _list_page(self, lo: int, hi: int) -> Tuple[bytes, int]:
        v = self.v[lo:hi]
        if v.ndim == 2:
            rows = [None if len(r) and np.isnan(r).all() else r for r in v]
        else:
            rows = [None if x is None else np.asarray(x, np.float64)
                    for x in v.tolist()]
        defs, reps, vals = [], [], []
        for row in rows:
            if row is None:
                defs.append(0)
                reps.append(0)
            elif len(row) == 0:
                defs.append(1)
                reps.append(0)
            else:
                defs.extend([3] * len(row))
                reps.extend([0] + [1] * (len(row) - 1))
                vals.append(row)
        d = np.asarray(defs, np.int64)
        r = np.asarray(reps, np.int64)
        rl, dl = E.encode_hybrid(r, 1), E.encode_hybrid(d, 2)
        data = np.concatenate(vals).astype(np.float32) if vals \
            else np.zeros(0, np.float32)
        return (len(rl).to_bytes(4, "little") + rl +
                len(dl).to_bytes(4, "little") + dl +
                E.encode_plain(data, E.FLOAT)), len(d)


def _is_list_column(v: np.ndarray) -> bool:
    from ...native.hashing import null_mask
    vals = v[~null_mask(v)]
    return bool(len(vals)) and all(isinstance(x, (list, np.ndarray))
                                   for x in vals)


def write_table(block: Block, path: str) -> None:
    """Write a block of numpy columns as one snappy parquet file."""
    from ...native import snappy
    cols = [_ColumnWriter(str(c), v) for c, v in block.items()]
    n = block_len(block)
    out = bytearray(MAGIC)
    row_groups = []
    for lo in range(0, n, ROW_GROUP_ROWS):
        hi = min(n, lo + ROW_GROUP_ROWS)
        chunks, total, total_c = [], 0, 0
        for col in cols:
            raw, count = col.page(lo, hi)
            body = snappy.compress(raw)
            header = write_struct([
                (1, "i32", _DATA_PAGE), (2, "i32", len(raw)),
                (3, "i32", len(body)),
                (5, "struct", [(1, "i32", count), (2, "i32", E.PLAIN),
                               (3, "i32", E.RLE), (4, "i32", E.RLE)])])
            offset = len(out)
            out += header + body
            usize, csize = len(header) + len(raw), len(header) + len(body)
            total += usize
            total_c += csize
            chunks.append([(2, "i64", offset), (3, "struct", [
                (1, "i32", col.ptype),
                (2, "list:i32", [E.PLAIN, E.RLE]),
                (3, "list:binary", col.path()), (4, "i32", E.SNAPPY),
                (5, "i64", count), (6, "i64", usize), (7, "i64", csize),
                (9, "i64", offset)])])
        row_groups.append([(1, "list:struct", chunks), (2, "i64", total),
                           (3, "i64", hi - lo), (5, "i64", chunks[0][0][2]
                                                 if chunks else 4),
                           (6, "i64", total_c),
                           (7, "i16", len(row_groups))])
    schema = [[(3, "i32", _REQUIRED), (4, "binary", "schema"),
               (5, "i32", len(cols))]]
    for col in cols:
        schema.extend(col.elements())
    arrow = A.schema_metadata([c.arrow_field() for c in cols])
    footer = write_struct([
        (1, "i32", 2), (2, "list:struct", schema), (3, "i64", n),
        (4, "list:struct", row_groups),
        (5, "list:struct", [[(1, "binary", "ARROW:schema"),
                             (2, "binary", arrow)]]),
        (6, "binary", CREATED_BY),
        (7, "list:struct", [[(1, "struct", [])] for _ in cols])])
    out += footer + len(footer).to_bytes(4, "little") + MAGIC
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(out)
    os.replace(tmp, path)
