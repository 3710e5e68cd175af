"""Parquet's value encodings and page compression.

- PLAIN for every physical type: BOOLEAN bit-packed (least significant
  bit first), INT32 / INT64 / FLOAT / DOUBLE little endian, INT96 (the
  legacy timestamp: nanoseconds of the day, then the Julian day),
  BYTE_ARRAY (a 4-byte length before each value) and
  FIXED_LEN_BYTE_ARRAY.
- The RLE / bit-packed hybrid of definition and repetition levels and of
  dictionary indices: runs, each a varint header whose low bit says
  bit-packed (groups of 8 values) or repeated (one value, in the bytes
  its width needs).
- Page decompression: SNAPPY (`native/snappy.py`), GZIP (`zlib`) and
  UNCOMPRESSED. ZSTD, LZ4, LZ4_RAW, BROTLI and LZO raise
  NotImplementedError naming the codec.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
# encodings
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
# the codec the writer compresses with
SNAPPY = 1
_CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
                4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
_FIXED_WIDTH = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}
_JULIAN_EPOCH = 2_440_588  # the Julian day of 1970-01-01
_NS_A_DAY = 86_400_000_000_000


def decompress(codec: int, data: bytes, size: int) -> bytes:
    if codec == 0:
        return data
    if codec == SNAPPY:
        from ...native import snappy
        out = snappy.decompress(data)
    elif codec == 2:
        out = zlib.decompress(data, 47)  # gzip or zlib header
    else:
        raise NotImplementedError(
            f"parquet codec {_CODEC_NAMES.get(codec, codec)} is not "
            f"supported (SNAPPY, GZIP and UNCOMPRESSED are)")
    if len(out) != size:
        raise ValueError(f"parquet page decompressed to {len(out)} bytes, "
                         f"its header says {size}")
    return out


# --------------------------------------------------------------- hybrid
def bit_width(max_value: int) -> int:
    return int(max_value).bit_length()


def _varint(buf, pos: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _unpack_bits(buf, pos: int, width: int, count: int) -> np.ndarray:
    if width == 0:
        return np.zeros(count, np.int64)
    raw = np.frombuffer(buf, np.uint8, count * width // 8, pos)
    bits = np.unpackbits(raw, bitorder="little").reshape(count, width)
    return bits.astype(np.int64) @ (np.int64(1) << np.arange(width,
                                                             dtype=np.int64))


def decode_hybrid(buf, pos: int, end: int, width: int,
                  count: int) -> np.ndarray:
    """`count` values of the RLE / bit-packed hybrid in buf[pos:end]."""
    out = np.empty(count, np.int64)
    got = 0
    nbytes = (width + 7) // 8
    while got < count:
        if pos >= end:
            raise ValueError("parquet: RLE / bit-packed run past its data")
        header, pos = _varint(buf, pos)
        if header & 1:
            n = (header >> 1) * 8
            vals = _unpack_bits(buf, pos, width, n)
            pos += n * width // 8
            take = min(n, count - got)
            out[got:got + take] = vals[:take]
        else:
            n = header >> 1
            value = int.from_bytes(bytes(buf[pos:pos + nbytes]), "little")
            pos += nbytes
            take = min(n, count - got)
            out[got:got + take] = value
        got += take
    return out


def encode_hybrid(values: np.ndarray, width: int) -> bytes:
    """`values` as one repeated run when they are all equal, else one
    bit-packed run (padded to a group of 8)."""
    n = len(values)
    out = bytearray()
    if n == 0:
        return bytes(out)
    if (values == values[0]).all():
        _put_varint(out, n << 1)
        out += int(values[0]).to_bytes((width + 7) // 8, "little")
        return bytes(out)
    groups = -(-n // 8)
    padded = np.zeros(groups * 8, np.int64)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(width)) & 1).astype(np.uint8)
    _put_varint(out, (groups << 1) | 1)
    out += np.packbits(bits.ravel(), bitorder="little").tobytes()
    return bytes(out)


def _put_varint(out: bytearray, n: int) -> None:
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


# ---------------------------------------------------------------- PLAIN
def decode_plain(buf, pos: int, ptype: int, count: int,
                 type_length: int = 0, text: bool = False
                 ) -> Tuple[object, int]:
    """(`count` PLAIN values at `pos`, the position after them): a numpy
    array for the fixed-width types (INT96 as int64 nanoseconds since
    the epoch), a list of bytes for the byte arrays (of str, decoded as
    UTF-8, with `text`)."""
    if ptype in _FIXED_WIDTH:
        dt = np.dtype(_FIXED_WIDTH[ptype])
        vals = np.frombuffer(buf, dt, count, pos)
        return vals, pos + count * dt.itemsize
    if ptype == BOOLEAN:
        nbytes = (count + 7) // 8
        raw = np.frombuffer(buf, np.uint8, nbytes, pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(bool), \
            pos + nbytes
    if ptype == BYTE_ARRAY:
        out: List = [b""] * count
        mv = memoryview(buf)
        unpack = struct.Struct("<I").unpack_from
        as_value = (lambda m: str(m, "utf-8")) if text else bytes
        for i in range(count):
            n = unpack(buf, pos)[0]
            pos += 4
            out[i] = as_value(mv[pos:pos + n])
            pos += n
        if pos > len(buf):
            raise ValueError("parquet: BYTE_ARRAY values past their page")
        return out, pos
    if ptype == FIXED:
        mv = memoryview(buf)
        out = [bytes(mv[pos + i * type_length:pos + (i + 1) * type_length])
               for i in range(count)]
        return out, pos + count * type_length
    if ptype == INT96:
        raw = np.frombuffer(buf, np.uint8, 12 * count, pos).reshape(count, 12)
        nanos = raw[:, :8].copy().view("<i8").ravel()
        days = raw[:, 8:].copy().view("<i4").ravel().astype(np.int64)
        return (days - _JULIAN_EPOCH) * _NS_A_DAY + nanos, pos + 12 * count
    raise ValueError(f"parquet: unknown physical type {ptype}")


def encode_plain(values, ptype: int) -> bytes:
    """PLAIN bytes of `values` (a numpy array, or a list of bytes for
    BYTE_ARRAY)."""
    if ptype in _FIXED_WIDTH:
        return np.ascontiguousarray(values, _FIXED_WIDTH[ptype]).tobytes()
    if ptype == BOOLEAN:
        return np.packbits(np.asarray(values, np.uint8),
                           bitorder="little").tobytes()
    if ptype == BYTE_ARRAY:
        pack = struct.Struct("<I").pack
        return b"".join([pack(len(v)) + v for v in values])
    raise ValueError(f"parquet: no PLAIN writer for physical type {ptype}")
