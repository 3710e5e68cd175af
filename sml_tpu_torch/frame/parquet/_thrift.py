"""Thrift's compact protocol, the encoding of parquet's footer and page
headers.

`read_struct` decodes any struct into a dict keyed by field id (nested
structs as dicts, lists as lists, binary fields as bytes), so that the
fields a reader does not know (statistics, column indexes, encryption,
key-value metadata) are decoded and ignored rather than breaking a read.
`write_struct` encodes a struct given as a list of `(field id, kind,
value)` triples, kinds "bool", "i8" (Thrift's byte), "i16", "i32",
"i64", "binary", "struct" and "list:<kind>" (a struct's value is again
such a list; fields whose value is None are left out).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# compact type ids
_TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, _SET, \
    _MAP, _STRUCT = range(1, 13)
_KINDS = {"bool": _TRUE, "i8": _BYTE, "i16": _I16, "i32": _I32,
          "i64": _I64, "binary": _BINARY, "struct": _STRUCT}


class ThriftError(ValueError):
    """A footer or page header that is not valid compact Thrift."""


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ThriftError("varint too long")


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(buf: bytes, pos: int, ttype: int) -> Tuple[Any, int]:
    if ttype in (_TRUE, _FALSE):  # a list element: one byte
        return buf[pos] == _TRUE, pos + 1
    if ttype == _BYTE:
        return struct.unpack_from("<b", buf, pos)[0], pos + 1
    if ttype in (_I16, _I32, _I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if ttype == _DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ttype == _BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ThriftError("truncated binary")
        return bytes(buf[pos:pos + n]), pos + n
    if ttype in (_LIST, _SET):
        head = buf[pos]
        pos += 1
        n, etype = head >> 4, head & 0x0F
        if n == 15:
            n, pos = _varint(buf, pos)
        out = []
        for _ in range(n):
            v, pos = _read_value(buf, pos, etype)
            out.append(v)
        return out, pos
    if ttype == _MAP:
        n, pos = _varint(buf, pos)
        out = {}
        if n:
            kv = buf[pos]
            pos += 1
            for _ in range(n):
                k, pos = _read_value(buf, pos, kv >> 4)
                v, pos = _read_value(buf, pos, kv & 0x0F)
                out[k] = v
        return out, pos
    if ttype == _STRUCT:
        return read_struct(buf, pos)
    raise ThriftError(f"unknown compact type {ttype}")


def read_struct(buf: bytes, pos: int = 0) -> Tuple[Dict[int, Any], int]:
    """(the struct at `pos` as {field id: value}, the position after
    it)."""
    out: Dict[int, Any] = {}
    last = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated struct")
        head = buf[pos]
        pos += 1
        if head == 0:
            return out, pos
        ttype, delta = head & 0x0F, head >> 4
        if delta:
            fid = last + delta
        else:
            raw, pos = _varint(buf, pos)
            fid = _zigzag(raw)
        if ttype in (_TRUE, _FALSE):
            out[fid] = ttype == _TRUE
        else:
            out[fid], pos = _read_value(buf, pos, ttype)
        last = fid


# ------------------------------------------------------------------ writer
def _put_varint(out: bytearray, n: int) -> None:
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _put_zigzag(out: bytearray, n: int) -> None:
    _put_varint(out, (n << 1) ^ (n >> 63))


def _type_of(kind: str) -> int:
    return _LIST if kind.startswith("list:") else _KINDS[kind]


def _put_value(out: bytearray, kind: str, value) -> None:
    if kind == "bool":  # a list element
        out.append(_TRUE if value else _FALSE)
    elif kind == "i8":
        out += struct.pack("<b", int(value))
    elif kind in ("i16", "i32", "i64"):
        _put_zigzag(out, int(value))
    elif kind == "binary":
        data = value.encode("utf-8") if isinstance(value, str) else value
        _put_varint(out, len(data))
        out += data
    elif kind == "struct":
        _put_struct(out, value)
    elif kind.startswith("list:"):
        elem = kind[5:]
        n = len(value)
        if n < 15:
            out.append((n << 4) | _type_of(elem))
        else:
            out.append(0xF0 | _type_of(elem))
            _put_varint(out, n)
        for v in value:
            _put_value(out, elem, v)
    else:
        raise ThriftError(f"unknown kind {kind}")


def _put_struct(out: bytearray, fields: List[Tuple[int, str, Any]]) -> None:
    last = 0
    for fid, kind, value in fields:
        if value is None:
            continue
        ttype = (_TRUE if value else _FALSE) if kind == "bool" \
            else _type_of(kind)
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | ttype)
        else:
            out.append(ttype)
            _put_zigzag(out, fid)
        if kind != "bool":
            _put_value(out, kind, value)
        last = fid
    out.append(0)


def write_struct(fields: List[Tuple[int, str, Any]]) -> bytes:
    out = bytearray()
    _put_struct(out, fields)
    return bytes(out)
