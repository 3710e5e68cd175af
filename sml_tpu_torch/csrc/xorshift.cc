// Spark XORShiftRandom draw kernel (draw-for-draw randomSplit parity).
//
// Implements java.util.Random.nextDouble over Spark's XORShift next():
//   next(bits): s ^= s << 21; s ^= s >>> 35; s ^= s << 4;
//               return (int)(s & ((1L << bits) - 1));
//   nextDouble: ((next(26) << 27) + next(27)) * 2^-53
// (org/apache/spark/util/random/XORShiftRandom.scala). The caller passes
// the ALREADY-HASHED seed (XORShiftRandom.hashSeed of seed+partitionIndex
// — see frame/sampling.py, which owns the MurmurHash3 seed scramble over
// Spark's 64-BYTE buffer: ByteBuffer.allocate(java.lang.Long.SIZE) where
// Long.SIZE is 64 bits, i.e. 8 big-endian seed bytes + 56 zeros hashed
// with length-64 finalization).

#include <cstdint>

extern "C" {

void xorshift_fill_doubles(long long hashed_seed, long long n, double* out) {
  uint64_t s = (uint64_t)hashed_seed;
  const double unit = 1.0 / 9007199254740992.0;  // 2^-53
  for (long long i = 0; i < n; ++i) {
    uint64_t x = s ^ (s << 21);
    x ^= (x >> 35);
    x ^= (x << 4);
    s = x;
    uint64_t hi = x & ((1ULL << 26) - 1);
    x = s ^ (s << 21);
    x ^= (x >> 35);
    x ^= (x << 4);
    s = x;
    uint64_t lo = x & ((1ULL << 27) - 1);
    out[i] = (double)((hi << 27) + lo) * unit;
  }
}

}  // extern "C"
