// The SHA-256 round chain of one 64-byte block, as the consumer warp of
// csrc/sha256.cu runs it: 64 rounds on KW[t] = W[t] + K[t], which the
// producer warps left in shared memory.  csrc/latency_probe.cu includes it
// too, to time the round chain alone.  See csrc/sha256.cu for the design.

#pragma once

#include <stdint.h>

namespace sha256_round {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One round: the working variables a..h advance by KW[t].  h + KW[t] and d
// are summed apart from Σ1 + Ch, since h and d are known three rounds ahead.
// Ch and Maj are one three-input function each (one LOP3).
__device__ __forceinline__ void round(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                                      uint32_t& e, uint32_t& f, uint32_t& g, uint32_t& h,
                                      uint32_t kw) {
  const uint32_t hk = h + kw;
  const uint32_t hkd = hk + d;
  const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = g ^ (e & (f ^ g));
  const uint32_t big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) | (c & (a | b));
  h = g; g = f; f = e; e = big_s1 + ch + hkd;
  d = c; c = b; b = a; a = big_s1 + ch + hk + big_s0 + maj;
}

// v: the working variables a..h, advanced by 64 rounds.  kw: this lane's
// KW[0]; KW[t] is kw[t * kStride].
template <int kStride>
__device__ __forceinline__ void block(uint32_t (&v)[8], const uint32_t* kw) {
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    round(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], kw[t * kStride]);
  }
}

}  // namespace sha256_round
