"""The `ARROW:schema` key of a parquet footer: the Arrow schema pyarrow
stores beside the parquet schema, and restores types from on read.

pyarrow writes the JAX package's frames with this key, and reads their
text columns back as `large_string` only because of it; the port writes
the same key, so that pyarrow (and with it the JAX package) reads a port
file to the same Arrow schema. The
value is the base64 of one encapsulated Arrow IPC message (the
continuation marker, the metadata length, the flatbuffer padded to 8
bytes, no body) whose header is a `Schema` (`Schema.fbs`,
`Message.fbs`, metadata version V5).

The flatbuffer is laid out front to back: every table's vtable just
before it, and everything a table refers to (strings, vectors, child
tables) after it, so that each offset is positive, as the format
requires; scalars sit at their natural alignment.
"""

from __future__ import annotations

import base64
import struct
from typing import Callable, List, Optional, Tuple

# Type union tags (Schema.fbs)
NULL, INT, FLOAT, BINARY, BOOL, DATE, TIMESTAMP, LIST, LARGE_UTF8 = \
    1, 2, 3, 4, 6, 8, 10, 12, 20
_TIME_UNITS = {"s": 0, "ms": 1, "us": 2, "ns": 3}


class ArrowType:
    """One Arrow type: its union tag, its type table's scalar fields
    (slot, format, value) and, for a list, its child field."""

    def __init__(self, tag: int, scalars=(),
                 child: Optional["ArrowField"] = None):
        self.tag = tag
        self.scalars = list(scalars)
        self.child = child


class ArrowField:
    def __init__(self, name: str, atype: ArrowType, nullable: bool = True):
        self.name = name
        self.atype = atype
        self.nullable = nullable


def int_type(bits: int, signed: bool) -> ArrowType:
    return ArrowType(INT, [(0, "<i", bits), (1, "<B", int(signed))])


def float_type(bits: int) -> ArrowType:
    return ArrowType(FLOAT, [(0, "<h", {16: 0, 32: 1, 64: 2}[bits])])


def date_type() -> ArrowType:  # days
    return ArrowType(DATE, [(0, "<h", 0)])


def timestamp_type(unit: str) -> ArrowType:
    return ArrowType(TIMESTAMP, [(0, "<h", _TIME_UNITS[unit])])


def list_type(item: ArrowType) -> ArrowType:
    return ArrowType(LIST, child=ArrowField("item", item))


class _Builder:
    def __init__(self):
        self.buf = bytearray(4)  # the root offset, patched at the end

    def _align(self, n: int) -> None:
        self.buf += bytes(-len(self.buf) % n)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def string(self, text: str) -> int:
        self._align(4)
        pos = len(self.buf)
        data = text.encode("utf-8")
        self.buf += struct.pack("<I", len(data)) + data + b"\0"
        return pos

    def vector(self, items: List[Callable[[], int]]) -> int:
        """A vector of offsets to what each callable writes."""
        self._align(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(items)) + bytes(4 * len(items))
        for k, write in enumerate(items):
            self._patch(pos + 4 + 4 * k, write())
        return pos

    def table(self, scalars: List[Tuple[int, str, int]],
              offsets: List[Tuple[int, Callable[[], int]]]) -> int:
        """A table of scalar fields (slot, struct format, value) and
        offset fields (slot, writer of the target); returns its
        position."""
        fields = [(slot, struct.calcsize(fmt), fmt, v)
                  for slot, fmt, v in scalars]
        fields += [(slot, 4, "<I", w) for slot, w in offsets]
        fields.sort(key=lambda f: -f[1])
        layout, size = [], 4  # after the soffset to the vtable
        for slot, width, fmt, v in fields:
            size += -size % width
            layout.append((slot, size, fmt, v))
            size += width
        size += -size % 4
        n_slots = 1 + max((f[0] for f in fields), default=-1)
        vt = [0] * n_slots
        for slot, at, _, _ in layout:
            vt[slot] = at
        self._align(2)
        vt_pos = len(self.buf)
        self.buf += struct.pack(f"<HH{n_slots}H", 4 + 2 * n_slots, size, *vt)
        self._align(8)
        pos = len(self.buf)
        self.buf += bytes(size)
        struct.pack_into("<i", self.buf, pos, pos - vt_pos)
        later = []
        for slot, at, fmt, v in layout:
            if callable(v):
                later.append((pos + at, v))
            else:
                struct.pack_into(fmt, self.buf, pos + at, v)
        for at, write in later:
            self._patch(at, write())
        return pos

    def finish(self, root: Callable[[], int]) -> bytes:
        self._patch(0, root())
        self._align(8)
        return bytes(self.buf)


def _field(b: _Builder, f: ArrowField) -> int:
    t = f.atype
    offsets = [(0, lambda: b.string(f.name)),
               (3, lambda: b.table(t.scalars, [])),
               (5, lambda: b.vector([] if t.child is None else
                                    [lambda: _field(b, t.child)]))]
    return b.table([(1, "<B", int(f.nullable)), (2, "<B", t.tag)], offsets)


def schema_message(fields: List[ArrowField]) -> bytes:
    """The encapsulated IPC message of a Schema of `fields`."""
    b = _Builder()

    def schema() -> int:
        return b.table([(0, "<h", 0)],  # little endian
                       [(1, lambda: b.vector(
                           [lambda f=f: _field(b, f) for f in fields]))])

    fb = b.finish(lambda: b.table(
        [(0, "<h", 4), (1, "<B", 1), (3, "<q", 0)],  # V5, Schema, no body
        [(2, schema)]))
    return b"\xff\xff\xff\xff" + struct.pack("<i", len(fb)) + fb


def schema_metadata(fields: List[ArrowField]) -> str:
    """The `ARROW:schema` value for `fields`."""
    return base64.b64encode(schema_message(fields)).decode("ascii")
