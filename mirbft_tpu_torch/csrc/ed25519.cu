// Batched Ed25519 verification for the device auth plane, written for Hopper
// (sm_90a).
//
// ed25519_verify_kernel replaces the JAX package's verification program
//   (mirbft_tpu/ops/ed25519.py:372, `_verify_kernel_body`, jitted by
//   `_kernel_for`), with its contract: from the host packing of
//   `Ed25519BatchVerifier.pack_inputs` (ax, ay, r_bytes [B, 32] int32 bytes;
//   s_bits, h_bits [B, 256] int32 bits, little-endian) it writes one byte per
//   row, 1 exactly when compress([S]B + [h](-A)) == R.
//
// What it computes, verdict for verdict with the reference:
// - The cofactorless equation, compared as bytes: Q = [S]B + [h](-A) by one
//   interleaved double-scalar ladder (Straus/Shamir), 256 steps MSB first,
//   each a doubling and a unified addition of {identity, B, -A, B-A} picked
//   by the bit pair (s + 2h; any other value picks the identity, as the
//   reference's select does).  The formulas are the reference's (dbl-2008-hwcd
//   and add-2008-hwcd-3), so every coordinate stays congruent mod p to the
//   reference's at every step, whatever the inputs.
// - Strict R: Z is inverted (z^(p-2), by the standard chain of 254 squarings
//   and 11 multiplies), x and y are frozen to [0, p), and y with x's low bit
//   in bit 255 is compared with the 32 raw R bytes.  A non-canonical R (y >= p)
//   cannot match.  An R byte outside [0, 255] fails the row, as its int32
//   compare does in the reference.
// - S < L and the challenge h = SHA-512(R || A || M) mod L stay on the host;
//   padding rows arrive all zero, run like any row, and the host masks them.
//
// Field arithmetic: 8 x 32-bit limbs, radix 2^32, values kept below 2^256 and
// reduced mod 2p = 2^256 - 38 (2^256 = 38 mod p), so a carry out of the top
// limb folds back as 38.  Products are schoolbook 32 x 32 -> 64-bit
// multiplies (IMAD.WIDE.U32) with a carry per row.  The code is plain C++ on
// uint32_t / uint64_t: the same text builds for the host with a C++ compiler,
// which is how its arithmetic is checked without a card.
//
// What bounds it: one signature is ~4,640 field multiplies (256 doublings of 8
// and 256 additions of 8, the inversion's 265, and ~30 more), each 64 wide
// multiply-adds plus 8 for the fold: ~128 IMAD a multiply, ~600,000 a
// signature.  At the card's IMAD rate (64 lanes per SM per clock, 132 SMs) a
// wave of 1,024 signatures is ~0.04 ms of multiplies; its bytes (2.4 KB of
// inputs a row, mostly the two bit arrays) are far less.  What bounds this
// design is latency: one thread per signature puts a 1,024-row wave on 32
// warps, one on each of 32 SMs, and each warp's multiplies form a dependent
// chain of carries.  This is the simple, right first kernel: several threads
// per signature, or the field multiply on the tensor cores, are later work
// (ROADMAP.md).
//
// Layout: one warp per CTA, one row per thread, so waves up to 4,224 rows
// give every warp an SM of its own.  The four table points are kept in their
// cached form (Y-X, Y+X, 2d*T, 2Z) in a per-thread array indexed by the bit
// pair, which the compiler places on the local stack (L1-resident).
//
// Plain C interface for ctypes: the launcher takes device pointers, the row
// count and a cudaStream_t, launches on that stream without synchronising or
// allocating, and returns cudaGetLastError().

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace ed25519 {

struct Fe {
  uint32_t v[8];  // little-endian limbs of a value below 2^256, congruent mod p
};

struct Pt {
  Fe x, y, z, t;  // extended twisted Edwards coordinates (a = -1)
};

struct Cached {
  Fe ymx, ypx, t2d, z2;  // Y - X, Y + X, 2d * T, 2Z of a table point
};

__host__ __device__ __forceinline__ Fe fe_const(uint32_t v0, uint32_t v1, uint32_t v2,
                                                uint32_t v3, uint32_t v4, uint32_t v5,
                                                uint32_t v6, uint32_t v7) {
  Fe r;
  r.v[0] = v0; r.v[1] = v1; r.v[2] = v2; r.v[3] = v3;
  r.v[4] = v4; r.v[5] = v5; r.v[6] = v6; r.v[7] = v7;
  return r;
}

__host__ __device__ __forceinline__ Fe fe_small(uint32_t v) {
  return fe_const(v, 0, 0, 0, 0, 0, 0, 0);
}

// r + carry * 2^256 (carry <= 39) folded back below 2^256: 2^256 = 38 mod p.
// If r + 38 * carry wraps past 2^256 the wrapped value is below 38 * 39, so a
// second 38 cannot wrap again.
__host__ __device__ __forceinline__ void fe_fold(Fe& r, uint32_t carry) {
  uint64_t c = (uint64_t)carry * 38u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += r.v[k];
    r.v[k] = (uint32_t)c;
    c >>= 32;
  }
  r.v[0] += (uint32_t)c * 38u;
}

__host__ __device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)a.v[k] + b.v[k];
    r.v[k] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold(r, (uint32_t)c);
  return r;
}

// a - b: a borrow out of the top limb means the result is a - b + 2^256, so
// 38 more is subtracted; if that borrows too, the value sits just below 2^256
// and a last 38 comes off limb 0 without a borrow.
__host__ __device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t d = (uint64_t)a.v[k] - b.v[k] - borrow;
    r.v[k] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  uint32_t take = borrow * 38u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t d = (uint64_t)r.v[k] - take;
    r.v[k] = (uint32_t)d;
    take = (uint32_t)(d >> 63);
  }
  r.v[0] -= take * 38u;
  return r;
}

__host__ __device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1: never wraps.
      c += (uint64_t)a.v[i] * b.v[j] + w[i + j];
      w[i + j] = (uint32_t)c;
      c >>= 32;
    }
    w[i + 8] = (uint32_t)c;
  }
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)w[k + 8] * 38u + w[k];
    r.v[k] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold(r, (uint32_t)c);
  return r;
}

__host__ __device__ __forceinline__ Fe fe_sq_n(Fe a, int n) {
  for (int i = 0; i < n; ++i) a = fe_mul(a, a);
  return a;
}

// z^(p-2) = z^(2^255 - 21), by the chain of 254 squarings and 11 multiplies
// (z^0 -> 0, as the reference's exponentiation gives).
__host__ __device__ __noinline__ Fe fe_invert(const Fe& z) {
  const Fe z2 = fe_mul(z, z);
  const Fe z9 = fe_mul(fe_sq_n(z2, 2), z);
  const Fe z11 = fe_mul(z9, z2);
  const Fe z_5_0 = fe_mul(fe_mul(z11, z11), z9);       // 2^5 - 1
  const Fe z_10_0 = fe_mul(fe_sq_n(z_5_0, 5), z_5_0);    // 2^10 - 1
  const Fe z_20_0 = fe_mul(fe_sq_n(z_10_0, 10), z_10_0);  // 2^20 - 1
  const Fe z_40_0 = fe_mul(fe_sq_n(z_20_0, 20), z_20_0);  // 2^40 - 1
  const Fe z_50_0 = fe_mul(fe_sq_n(z_40_0, 10), z_10_0);  // 2^50 - 1
  const Fe z_100_0 = fe_mul(fe_sq_n(z_50_0, 50), z_50_0);  // 2^100 - 1
  const Fe z_200_0 = fe_mul(fe_sq_n(z_100_0, 100), z_100_0);  // 2^200 - 1
  const Fe z_250_0 = fe_mul(fe_sq_n(z_200_0, 50), z_50_0);    // 2^250 - 1
  return fe_mul(fe_sq_n(z_250_0, 5), z11);                   // 2^255 - 21
}

// The canonical representative in [0, p): a value below 2^256 = 2p + 38 needs
// at most two conditional subtractions of p.
__host__ __device__ __forceinline__ Fe fe_freeze(Fe x) {
  const Fe p = fe_const(0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                        0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu);
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    Fe d;
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t t = (uint64_t)x.v[k] - p.v[k] - borrow;
      d.v[k] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
    if (!borrow) x = d;
  }
  return x;
}

__host__ __device__ __forceinline__ Fe k2d() {  // 2d mod p
  return fe_const(0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
                  0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu);
}

// dbl-2008-hwcd (a = -1), as the reference's `_pt_double`.
__host__ __device__ __forceinline__ void pt_double(Pt& p) {
  const Fe a = fe_mul(p.x, p.x);
  const Fe b = fe_mul(p.y, p.y);
  const Fe zz = fe_mul(p.z, p.z);
  const Fe c = fe_add(zz, zz);
  const Fe h = fe_add(a, b);
  const Fe xy = fe_add(p.x, p.y);
  const Fe e = fe_sub(h, fe_mul(xy, xy));
  const Fe g = fe_sub(a, b);
  const Fe f = fe_add(c, g);
  p.x = fe_mul(e, f);
  p.y = fe_mul(g, h);
  p.z = fe_mul(f, g);
  p.t = fe_mul(e, h);
}

// add-2008-hwcd-3 (a = -1, k = 2d), as the reference's `_pt_add`, with the
// addend's factors precomputed: C = T1 * (2d T2), D = Z1 * (2 Z2).
__host__ __device__ __forceinline__ void pt_add(Pt& p, const Cached& q) {
  const Fe a = fe_mul(fe_sub(p.y, p.x), q.ymx);
  const Fe b = fe_mul(fe_add(p.y, p.x), q.ypx);
  const Fe c = fe_mul(p.t, q.t2d);
  const Fe d = fe_mul(p.z, q.z2);
  const Fe e = fe_sub(b, a);
  const Fe h = fe_add(b, a);
  const Fe f = fe_sub(d, c);
  const Fe g = fe_add(d, c);
  p.x = fe_mul(e, f);
  p.y = fe_mul(g, h);
  p.z = fe_mul(f, g);
  p.t = fe_mul(e, h);
}

__host__ __device__ __forceinline__ Cached to_cached(const Pt& p) {
  Cached c;
  c.ymx = fe_sub(p.y, p.x);
  c.ypx = fe_add(p.y, p.x);
  c.t2d = fe_mul(p.t, k2d());
  c.z2 = fe_add(p.z, p.z);
  return c;
}

// 32 int32 bytes, little-endian -> limbs; bytes are in [0, 255] by contract.
__host__ __device__ __forceinline__ Fe fe_from_bytes(const int32_t* b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r.v[k] = ((uint32_t)b[4 * k] & 0xffu) | (((uint32_t)b[4 * k + 1] & 0xffu) << 8) |
             (((uint32_t)b[4 * k + 2] & 0xffu) << 16) |
             (((uint32_t)b[4 * k + 3] & 0xffu) << 24);
  }
  return r;
}

// One row of the contract: 1 iff compress([S]B + [h](-A)) == R.
__host__ __device__ inline uint8_t verify_row(const int32_t* ax, const int32_t* ay,
                                              const int32_t* r_bytes,
                                              const int32_t* s_bits,
                                              const int32_t* h_bits) {
  const Fe one = fe_small(1);
  const Pt base = {
      fe_const(0x8f25d51au, 0xc9562d60u, 0x9525a7b2u, 0x692cc760u, 0xfdd6dc5cu,
               0xc0a4e231u, 0xcd6e53feu, 0x216936d3u),
      fe_const(0x66666658u, 0x66666666u, 0x66666666u, 0x66666666u, 0x66666666u,
               0x66666666u, 0x66666666u, 0x66666666u),
      one,
      fe_const(0xa5b7dda3u, 0x6dde8ab3u, 0x775152f5u, 0x20f09f80u, 0x64abe37du,
               0x66ea4e8eu, 0xd78b7665u, 0x67875f0fu),
  };
  // -A = (-x, y, 1, -x * y).
  const Fe neg_ax = fe_sub(fe_small(0), fe_from_bytes(ax));
  const Fe a_y = fe_from_bytes(ay);
  const Pt m_a = {neg_ax, a_y, one, fe_mul(neg_ax, a_y)};

  Cached table[4];
  table[0].ymx = one;  // the identity (0, 1, 1, 0)
  table[0].ypx = one;
  table[0].t2d = fe_small(0);
  table[0].z2 = fe_small(2);
  table[1] = to_cached(base);
  table[2] = to_cached(m_a);
  Pt b_m_a = base;
  pt_add(b_m_a, table[2]);
  table[3] = to_cached(b_m_a);

  Pt q = {fe_small(0), one, one, fe_small(0)};
  for (int i = 255; i >= 0; --i) {
    pt_double(q);
    int pick = s_bits[i] + 2 * h_bits[i];
    if (pick < 0 || pick > 3) pick = 0;
    pt_add(q, table[pick]);
  }

  const Fe z_inv = fe_invert(q.z);
  const Fe x = fe_freeze(fe_mul(q.x, z_inv));
  Fe y = fe_freeze(fe_mul(q.y, z_inv));
  y.v[7] |= (x.v[0] & 1u) << 31;
  const Fe r = fe_from_bytes(r_bytes);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) diff |= y.v[k] ^ r.v[k];
#pragma unroll
  for (int k = 0; k < 32; ++k) diff |= (uint32_t)r_bytes[k] & ~0xffu;
  return diff == 0 ? 1 : 0;
}

}  // namespace ed25519

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 32;  // one warp per CTA, one row per thread

__global__ void __launch_bounds__(kThreads)
ed25519_verify_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                      const int32_t* __restrict__ r_bytes,
                      const int32_t* __restrict__ s_bits,
                      const int32_t* __restrict__ h_bits, long long rows,
                      uint8_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  out[row] = ed25519::verify_row(ax + row * 32, ay + row * 32, r_bytes + row * 32,
                                 s_bits + row * 256, h_bits + row * 256);
}

}  // namespace

extern "C" int mirbft_ed25519_verify(const void* ax, const void* ay, const void* r_bytes,
                                     const void* s_bits, const void* h_bits,
                                     long long rows, void* out, void* stream) {
  const unsigned grid = (unsigned)((rows + kThreads - 1) / kThreads);
  ed25519_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)r_bytes,
      (const int32_t*)s_bits, (const int32_t*)h_bits, rows, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
