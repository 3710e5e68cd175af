// Murmur3_x86_32 hash kernels, Spark-semantics-compatible.
//
// The reference's hash-validation harness and `hash()` column function ride
// on Spark's Murmur3_x86_32 (seed 42): see
// `SML/Includes/Class-Utility-Methods.py:161-165` (toHash via spark hash())
// and hash-partitioned shuffles throughout L1. This is a from-scratch C++
// implementation of the same *algorithmic contract* (int/long/double/bytes
// mixing, per-trailing-byte tail, multi-column seed chaining) so hashes and
// hash-partition placement match the reference's observable behavior.
//
// Exposed C ABI (ctypes): vectorized hashers over contiguous arrays plus a
// bytes hasher over an offsets/len layout (Arrow string columns).

#include <cstdint>
#include <cstring>

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1b873593u;
  return k1;
}

static inline uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  h1 = h1 * 5 + 0xe6546b64u;
  return h1;
}

static inline uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  h1 ^= h1 >> 16;
  return h1;
}

static inline int32_t hash_int(int32_t input, int32_t seed) {
  uint32_t k1 = mix_k1((uint32_t)input);
  uint32_t h1 = mix_h1((uint32_t)seed, k1);
  return (int32_t)fmix(h1, 4);
}

static inline int32_t hash_long(int64_t input, int32_t seed) {
  uint32_t low = (uint32_t)input;
  uint32_t high = (uint32_t)(((uint64_t)input) >> 32);
  uint32_t k1 = mix_k1(low);
  uint32_t h1 = mix_h1((uint32_t)seed, k1);
  k1 = mix_k1(high);
  h1 = mix_h1(h1, k1);
  return (int32_t)fmix(h1, 8);
}

static inline int32_t hash_bytes(const uint8_t* data, int64_t len, int32_t seed) {
  uint32_t h1 = (uint32_t)seed;
  int64_t aligned = len - (len & 3);
  for (int64_t i = 0; i < aligned; i += 4) {
    uint32_t half_word;
    std::memcpy(&half_word, data + i, 4);  // little-endian load
    h1 = mix_h1(h1, mix_k1(half_word));
  }
  // Trailing bytes mixed one at a time (sign-extended), matching the
  // reference stack's observable tail behavior.
  for (int64_t i = aligned; i < len; i++) {
    int32_t b = (int8_t)data[i];
    h1 = mix_h1(h1, mix_k1((uint32_t)b));
  }
  return (int32_t)fmix(h1, (uint32_t)len);
}

extern "C" {

// Each hasher chains: out[i] = hash(value[i], seed=out[i]); callers initialize
// out[] to 42 (or previous column's hashes) to get multi-column chaining.
// null_mask may be nullptr; a null leaves the running hash unchanged.

void mm3_hash_i32(const int32_t* vals, const uint8_t* null_mask, int64_t n,
                  int32_t* inout) {
  for (int64_t i = 0; i < n; i++) {
    if (null_mask && null_mask[i]) continue;
    inout[i] = hash_int(vals[i], inout[i]);
  }
}

void mm3_hash_i64(const int64_t* vals, const uint8_t* null_mask, int64_t n,
                  int32_t* inout) {
  for (int64_t i = 0; i < n; i++) {
    if (null_mask && null_mask[i]) continue;
    inout[i] = hash_long(vals[i], inout[i]);
  }
}

void mm3_hash_f64(const double* vals, const uint8_t* null_mask, int64_t n,
                  int32_t* inout) {
  for (int64_t i = 0; i < n; i++) {
    if (null_mask && null_mask[i]) continue;
    double d = vals[i];
    if (d == 0.0) d = 0.0;  // normalize -0.0
    int64_t bits;
    std::memcpy(&bits, &d, 8);
    inout[i] = hash_long(bits, inout[i]);
  }
}

// Strings in Arrow layout: concatenated utf8 buffer + int64 offsets[n+1].
void mm3_hash_bytes_arr(const uint8_t* buf, const int64_t* offsets,
                        const uint8_t* null_mask, int64_t n, int32_t* inout) {
  for (int64_t i = 0; i < n; i++) {
    if (null_mask && null_mask[i]) continue;
    int64_t start = offsets[i];
    int64_t len = offsets[i + 1] - start;
    inout[i] = hash_bytes(buf + start, len, inout[i]);
  }
}

int32_t mm3_hash_one_bytes(const uint8_t* data, int64_t len, int32_t seed) {
  return hash_bytes(data, len, seed);
}

int32_t mm3_hash_one_i64(int64_t v, int32_t seed) { return hash_long(v, seed); }
int32_t mm3_hash_one_i32(int32_t v, int32_t seed) { return hash_int(v, seed); }

// Hash-partition assignment: pmod(hash, num_partitions) — the shuffle
// placement rule (non-negative modulo).
void mm3_partition(const int32_t* hashes, int64_t n, int32_t num_parts,
                   int32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    int32_t m = hashes[i] % num_parts;
    out[i] = m < 0 ? m + num_parts : m;
  }
}

}  // extern "C"
