// Snappy block compression for the parquet codec (frame/parquet).
//
// The raw snappy format (no framing): a varint of the uncompressed length,
// then elements, each a tag byte whose low two bits give its kind:
//   00 literal: length-1 in the upper six bits (< 60), or 60..63 meaning
//      1..4 little-endian bytes of length-1 follow; then the bytes;
//   01 copy, 1-byte offset: length 4..11 in bits 2-4, offset bits 8-10 in
//      bits 5-7, then the offset's low byte;
//   10 copy, 2-byte offset: length-1 in the upper six bits, then the
//      offset as 2 little-endian bytes;
//   11 copy, 4-byte offset: as 10 with 4 offset bytes.
// A copy may overlap its output (offset < length repeats a pattern).
//
// The compressor is a greedy matcher in 64 KiB blocks (so every offset fits
// two bytes), over a hash table of 4-byte windows: at each position it
// looks up the last position with the same window hash; on a 4-byte match
// it emits the pending literal and the longest copy, else it moves on,
// skipping faster through data that keeps failing to match (the skip
// heuristic of the reference implementation). The decompressor checks
// every length and offset against its buffers and reports a corrupt
// stream instead of reading or writing out of bounds.
//
// C ABI (ctypes): sizes are int64; a negative return is an error.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kBlock = 1 << 16;
constexpr int kHashBits = 14;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

inline uint8_t* put_varint(uint8_t* out, uint64_t v) {
  while (v >= 0x80) {
    *out++ = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  *out++ = static_cast<uint8_t>(v);
  return out;
}

uint8_t* emit_literal(uint8_t* out, const uint8_t* src, int64_t len) {
  int64_t n = len - 1;
  if (n < 60) {
    *out++ = static_cast<uint8_t>(n << 2);
  } else {
    int bytes = 0;
    uint8_t* tag = out++;
    while (n > 0) {
      *out++ = static_cast<uint8_t>(n & 0xff);
      n >>= 8;
      ++bytes;
    }
    *tag = static_cast<uint8_t>((59 + bytes) << 2);
  }
  std::memcpy(out, src, static_cast<size_t>(len));
  return out + len;
}

uint8_t* emit_copy_upto64(uint8_t* out, int64_t offset, int64_t len) {
  if (len < 12 && offset < 2048) {
    *out++ = static_cast<uint8_t>(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *out++ = static_cast<uint8_t>(offset & 0xff);
  } else {
    *out++ = static_cast<uint8_t>(2 | ((len - 1) << 2));
    *out++ = static_cast<uint8_t>(offset & 0xff);
    *out++ = static_cast<uint8_t>((offset >> 8) & 0xff);
  }
  return out;
}

uint8_t* emit_copy(uint8_t* out, int64_t offset, int64_t len) {
  // copies of at most 64 bytes; keep the last one at least 4 long
  while (len >= 68) {
    out = emit_copy_upto64(out, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    out = emit_copy_upto64(out, offset, 60);
    len -= 60;
  }
  return emit_copy_upto64(out, offset, len);
}

uint8_t* compress_block(const uint8_t* in, int64_t n, uint8_t* out,
                        uint16_t* table) {
  std::memset(table, 0, sizeof(uint16_t) << kHashBits);
  int64_t emit = 0;  // start of the pending literal
  if (n >= 15) {
    const int64_t limit = n - 4;  // last position a 4-byte window starts
    int64_t i = 1;
    uint32_t skip = 32;
    while (i <= limit) {
      uint32_t cur = load32(in + i);
      uint32_t h = hash32(cur);
      int64_t cand = table[h];
      table[h] = static_cast<uint16_t>(i);
      if (cand < i && load32(in + cand) == cur) {
        if (i > emit) out = emit_literal(out, in + emit, i - emit);
        int64_t len = 4;
        while (i + len < n && in[cand + len] == in[i + len]) ++len;
        out = emit_copy(out, i - cand, len);
        i += len;
        emit = i;
        skip = 32;
        if (i <= limit) {  // the window just before the new position
          table[hash32(load32(in + i - 1))] = static_cast<uint16_t>(i - 1);
        }
      } else {
        i += skip >> 5;
        ++skip;
      }
    }
  }
  if (emit < n) out = emit_literal(out, in + emit, n - emit);
  return out;
}

}  // namespace

extern "C" {

int64_t snappy_max_compressed_length(int64_t n) { return 32 + n + n / 6; }

// Compresses n bytes of `in` into `out` (at least
// snappy_max_compressed_length(n) bytes); returns the compressed length.
int64_t snappy_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  if (n < 0) return -1;
  uint16_t table[1 << kHashBits];
  uint8_t* p = put_varint(out, static_cast<uint64_t>(n));
  for (int64_t start = 0; start < n; start += kBlock) {
    int64_t len = n - start < kBlock ? n - start : kBlock;
    p = compress_block(in + start, len, p, table);
  }
  return p - out;
}

// The uncompressed length a stream declares, or -1 for a bad varint.
int64_t snappy_uncompressed_length(const uint8_t* in, int64_t n) {
  uint64_t v = 0;
  for (int shift = 0, i = 0; i < n && shift < 64; ++i, shift += 7) {
    v |= static_cast<uint64_t>(in[i] & 0x7f) << shift;
    if (!(in[i] & 0x80)) {
      return v > static_cast<uint64_t>(INT64_MAX) ? -1
                                                  : static_cast<int64_t>(v);
    }
  }
  return -1;
}

// Decompresses n bytes of `in` into `out` (out_cap bytes); returns the
// number of bytes written, which must be the declared length, or -1 for a
// corrupt stream.
int64_t snappy_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                          int64_t out_cap) {
  int64_t want = snappy_uncompressed_length(in, n);
  if (want < 0 || want > out_cap) return -1;
  int64_t ip = 0;
  while (ip < n && (in[ip] & 0x80)) ++ip;
  ++ip;
  int64_t op = 0;
  while (ip < n) {
    uint8_t tag = in[ip++];
    int kind = tag & 3;
    if (kind == 0) {
      int64_t len = tag >> 2;
      if (len >= 60) {
        int bytes = static_cast<int>(len - 59);
        if (ip + bytes > n) return -1;
        len = 0;
        for (int b = 0; b < bytes; ++b) {
          len |= static_cast<int64_t>(in[ip + b]) << (8 * b);
        }
        ip += bytes;
      }
      len += 1;
      if (ip + len > n || op + len > want) return -1;
      std::memcpy(out + op, in + ip, static_cast<size_t>(len));
      ip += len;
      op += len;
      continue;
    }
    int64_t len, offset;
    if (kind == 1) {
      if (ip + 1 > n) return -1;
      len = ((tag >> 2) & 7) + 4;
      offset = (static_cast<int64_t>(tag >> 5) << 8) | in[ip];
      ip += 1;
    } else if (kind == 2) {
      if (ip + 2 > n) return -1;
      len = (tag >> 2) + 1;
      offset = in[ip] | (static_cast<int64_t>(in[ip + 1]) << 8);
      ip += 2;
    } else {
      if (ip + 4 > n) return -1;
      len = (tag >> 2) + 1;
      offset = static_cast<int64_t>(load32(in + ip));
      ip += 4;
    }
    if (offset <= 0 || offset > op || op + len > want) return -1;
    const uint8_t* src = out + op - offset;
    if (offset >= len) {
      std::memcpy(out + op, src, static_cast<size_t>(len));
    } else {
      for (int64_t k = 0; k < len; ++k) out[op + k] = src[k];
    }
    op += len;
  }
  return op == want ? op : -1;
}

}  // extern "C"
