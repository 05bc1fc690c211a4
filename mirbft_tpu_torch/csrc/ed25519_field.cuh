// Field arithmetic mod p = 2^255 - 19 for the Ed25519 verify kernel
// (csrc/ed25519.cu) and the field probe of csrc/latency_probe.cu.
//
// 8 x 32-bit limbs, radix 2^32; values are kept below 2^256 and reduced mod
// 2p = 2^256 - 38 (2^256 = 38 mod p), so every function takes and returns
// values below 2^256 that are congruent mod p to the exact result; fe_freeze
// alone returns the canonical representative in [0, p).
//
// What bounds a multiply on Hopper is the high half of each 32 x 32-bit
// product: IMAD.WIDE.U32 issues at about a third of IMAD's rate on one
// scheduler (csrc/latency_probe.cu's issue probe), and fe_mul needs 64 of
// them plus 8 for the reduction, fe_sqr 28 + 8 + 8.  The rest is arranged so
// that the integer ALU pipe runs beside them: the products' words go into
// two accumulators by carry chains, one chain a row (mac4), the two
// accumulators' halves are added side by side, and a carry out of the top
// folds back as 38 with a branch for the all-but-never case of a carry that
// runs up the limbs.
//
// The PTX blocks write each carry chain as one asm statement (add.cc /
// addc.cc: IADD3 and IADD3.X passing the carry in a predicate), so a chain
// of n limbs is n dependent instructions and the products stay in register
// pairs (mul.wide.u32: IMAD.WIDE.U32 with no addend).  Written in C++ on
// uint64_t, nvcc turns each step of a chain into an add and a second add that
// moves the carry into a register, and pairs products with addends through
// extra moves.  Each block has its plain C++ equivalent under
// #ifndef __CUDA_ARCH__, which a host build runs: the host tests check those
// equivalents, and the card's checks the asm.

#ifndef MIRBFT_ED25519_FIELD_CUH_
#define MIRBFT_ED25519_FIELD_CUH_

#include <stdint.h>

namespace ed25519 {

struct Fe {
  uint32_t v[8];  // little-endian limbs of a value below 2^256, congruent mod p
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

__host__ __device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// r + carry * 2^256 (carry < 2^26) folded back below 2^256: 2^256 = 38 mod p.
// 38 * carry goes into limb 0; only when limb 0 wraps (all but never) does a
// carry run up the limbs, and if that wraps past 2^256 the value is below
// 38 * carry < 2^32 - 38, so a second 38 cannot wrap again.  The rare case
// is a branch, not a carry chain on every call.
__host__ __device__ __forceinline__ void fe_fold(Fe& r, uint32_t carry) {
  const uint32_t add = carry * 38u;
  const uint32_t v0 = r.v[0] + add;
  r.v[0] = v0;
  if (v0 < add) {
    uint32_t c = 1;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      r.v[k] += c;
      c = c && r.v[k] == 0;
    }
    r.v[0] += c * 38u;
  }
}

__host__ __device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t carry;
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]),
        "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7]), "=&r"(carry)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
#else
  uint64_t c = 0;
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)a.v[k] + b.v[k];
    r.v[k] = (uint32_t)c;
    c >>= 32;
  }
  carry = (uint32_t)c;
#endif
  fe_fold(r, carry);
  return r;
}

// a - b: a borrow out of the top limb means the result is a - b + 2^256, so
// 38 more is subtracted (a branch runs the borrow up the limbs in the rare
// case that limb 0 is below 38); if that borrows out of the top too, the
// value sits just below 2^256 and a last 38 comes off limb 0 without a
// borrow.
__host__ __device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t borrow;  // 0, or all ones after a borrow out of the top limb
#ifdef __CUDA_ARCH__
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]),
        "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7]), "=&r"(borrow)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
#else
  uint32_t bit = 0;
  for (int k = 0; k < 8; ++k) {
    const uint64_t d = (uint64_t)a.v[k] - b.v[k] - bit;
    r.v[k] = (uint32_t)d;
    bit = (uint32_t)(d >> 63);
  }
  borrow = 0u - bit;
#endif
  const uint32_t take = borrow & 38u;
  const uint32_t v0 = r.v[0];
  r.v[0] = v0 - take;
  if (v0 < take) {  // all but never: the borrow runs up the limbs
    uint32_t b = 1;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const uint32_t v = r.v[k];
      r.v[k] = v - b;
      b = b && v == 0;
    }
    r.v[0] -= b * 38u;
  }
  return r;
}

// a + b, or a - b when `negate`: one carry chain on b's words or their
// complements (a - b = a + ~b + 1 - 2^256).  The chain's excess over the
// value, +2^256 or -2^256, comes back as +38 or -38 (by fe_fold or as in
// fe_sub).
__host__ __device__ __forceinline__ Fe fe_addsub(const Fe& a, const Fe& b, bool negate) {
  const uint32_t mask = negate ? 0xffffffffu : 0u;
  Fe r;
  uint32_t carry;
#ifdef __CUDA_ARCH__
  asm("{\n\t"
      ".reg .u32 t;\n\t"
      "add.cc.u32 t, %25, %25;\n\t"  // the carry flag = negate
      "addc.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "}"
      : "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]),
        "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7]), "=&r"(carry)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0] ^ mask), "r"(b.v[1] ^ mask),
        "r"(b.v[2] ^ mask), "r"(b.v[3] ^ mask), "r"(b.v[4] ^ mask), "r"(b.v[5] ^ mask),
        "r"(b.v[6] ^ mask), "r"(b.v[7] ^ mask), "r"(mask));
#else
  uint64_t c = negate ? 1 : 0;
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)a.v[k] + (b.v[k] ^ mask);
    r.v[k] = (uint32_t)c;
    c >>= 32;
  }
  carry = (uint32_t)c;
#endif
  if (!negate) {
    fe_fold(r, carry);
  } else if (carry == 0) {  // a borrow: the value is r - 2^256, so 38 comes off
    const uint32_t v0 = r.v[0];
    r.v[0] = v0 - 38u;
    if (v0 < 38u) {  // all but never: the borrow runs up the limbs
      uint32_t b_ = 1;
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        const uint32_t v = r.v[k];
        r.v[k] = v - b_;
        b_ = b_ && v == 0;
      }
      r.v[0] -= b_ * 38u;
    }
  }
  return r;
}

// acc[o .. o + 8] += x0 y0 + x1 y1 2^64 + x2 y2 2^128 + x3 y3 2^192 (words
// o + 2m, o + 2m + 1 take the product x_m y_m), the carry out of word o + 7
// into word o + 8.  The caller keeps the sum below 2^(32 (o + 9)).
template <int o>
__host__ __device__ __forceinline__ void mac4(uint32_t (&acc)[17], uint32_t x0, uint32_t y0,
                                              uint32_t x1, uint32_t y1, uint32_t x2,
                                              uint32_t y2, uint32_t x3, uint32_t y3) {
  static_assert(o + 8 < 17, "mac4 runs past the accumulator");
#ifdef __CUDA_ARCH__
  asm("{\n\t"
      ".reg .u64 p0, p1, p2, p3;\n\t"
      ".reg .u32 l0, h0, l1, h1, l2, h2, l3, h3;\n\t"
      "mul.wide.u32 p0, %9, %10;\n\t"
      "mul.wide.u32 p1, %11, %12;\n\t"
      "mul.wide.u32 p2, %13, %14;\n\t"
      "mul.wide.u32 p3, %15, %16;\n\t"
      "mov.b64 {l0, h0}, p0;\n\t"
      "mov.b64 {l1, h1}, p1;\n\t"
      "mov.b64 {l2, h2}, p2;\n\t"
      "mov.b64 {l3, h3}, p3;\n\t"
      "add.cc.u32 %0, %0, l0;\n\t"
      "addc.cc.u32 %1, %1, h0;\n\t"
      "addc.cc.u32 %2, %2, l1;\n\t"
      "addc.cc.u32 %3, %3, h1;\n\t"
      "addc.cc.u32 %4, %4, l2;\n\t"
      "addc.cc.u32 %5, %5, h2;\n\t"
      "addc.cc.u32 %6, %6, l3;\n\t"
      "addc.cc.u32 %7, %7, h3;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "}"
      : "+r"(acc[o]), "+r"(acc[o + 1]), "+r"(acc[o + 2]), "+r"(acc[o + 3]),
        "+r"(acc[o + 4]), "+r"(acc[o + 5]), "+r"(acc[o + 6]), "+r"(acc[o + 7]),
        "+r"(acc[o + 8])
      : "r"(x0), "r"(y0), "r"(x1), "r"(y1), "r"(x2), "r"(y2), "r"(x3), "r"(y3));
#else
  const uint32_t x[4] = {x0, x1, x2, x3}, y[4] = {y0, y1, y2, y3};
  uint64_t c = 0;
  for (int m = 0; m < 4; ++m) {
    const uint64_t p = (uint64_t)x[m] * y[m];
    c += (uint64_t)acc[o + 2 * m] + (uint32_t)p;
    acc[o + 2 * m] = (uint32_t)c;
    c >>= 32;
    c += (uint64_t)acc[o + 2 * m + 1] + (uint32_t)(p >> 32);
    acc[o + 2 * m + 1] = (uint32_t)c;
    c >>= 32;
  }
  acc[o + 8] += (uint32_t)c;
#endif
}

// x[o .. o + 7] = the four products, as mac4 lays them out, over zeros.
template <int o>
__host__ __device__ __forceinline__ void mul4(uint32_t (&x)[17], uint32_t x0, uint32_t y0,
                                              uint32_t x1, uint32_t y1, uint32_t x2,
                                              uint32_t y2, uint32_t x3, uint32_t y3) {
  const uint64_t p[4] = {(uint64_t)x0 * y0, (uint64_t)x1 * y1, (uint64_t)x2 * y2,
                         (uint64_t)x3 * y3};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    x[o + 2 * m] = (uint32_t)p[m];
    x[o + 2 * m + 1] = (uint32_t)(p[m] >> 32);
  }
}

// w[lo .. lo + 7] = x[lo ..] + y[lo ..], returning the carry out.
template <int lo, int nx, int ny>
__host__ __device__ __forceinline__ uint32_t add8(uint32_t (&w)[16], const uint32_t (&x)[nx],
                                                  const uint32_t (&y)[ny]) {
  static_assert(lo + 8 <= nx && lo + 8 <= ny, "add8 runs past an addend");
  uint32_t carry;
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=&r"(w[lo]), "=&r"(w[lo + 1]), "=&r"(w[lo + 2]), "=&r"(w[lo + 3]),
        "=&r"(w[lo + 4]), "=&r"(w[lo + 5]), "=&r"(w[lo + 6]), "=&r"(w[lo + 7]),
        "=&r"(carry)
      : "r"(x[lo]), "r"(x[lo + 1]), "r"(x[lo + 2]), "r"(x[lo + 3]), "r"(x[lo + 4]),
        "r"(x[lo + 5]), "r"(x[lo + 6]), "r"(x[lo + 7]), "r"(y[lo]), "r"(y[lo + 1]),
        "r"(y[lo + 2]), "r"(y[lo + 3]), "r"(y[lo + 4]), "r"(y[lo + 5]), "r"(y[lo + 6]),
        "r"(y[lo + 7]));
#else
  uint64_t c = 0;
  for (int k = lo; k < lo + 8; ++k) {
    c += (uint64_t)x[k] + y[k];
    w[k] = (uint32_t)c;
    c >>= 32;
  }
  carry = (uint32_t)c;
#endif
  return carry;
}

// w_lo + 2^256 w_hi + 2^256 over, reduced below 2^256 (2^256 = 38 mod p):
// w_lo + 38 w_hi by one pass of two carry chains (the products' low words,
// then their high words a limb up), and its carry out (at most 39) folded
// with `over` (below 2^20).
__host__ __device__ __forceinline__ Fe fe_reduce(const uint32_t (&w)[16], uint32_t over) {
  Fe r;
  uint32_t carry;
#ifdef __CUDA_ARCH__
  asm("{\n\t"
      ".reg .u64 t0, t1, t2, t3, t4, t5, t6, t7;\n\t"
      ".reg .u32 l0, h0, l1, h1, l2, h2, l3, h3, l4, h4, l5, h5, l6, h6, l7, h7;\n\t"
      "mul.wide.u32 t0, %17, 38;\n\t"
      "mul.wide.u32 t1, %18, 38;\n\t"
      "mul.wide.u32 t2, %19, 38;\n\t"
      "mul.wide.u32 t3, %20, 38;\n\t"
      "mul.wide.u32 t4, %21, 38;\n\t"
      "mul.wide.u32 t5, %22, 38;\n\t"
      "mul.wide.u32 t6, %23, 38;\n\t"
      "mul.wide.u32 t7, %24, 38;\n\t"
      "mov.b64 {l0, h0}, t0;\n\t"
      "mov.b64 {l1, h1}, t1;\n\t"
      "mov.b64 {l2, h2}, t2;\n\t"
      "mov.b64 {l3, h3}, t3;\n\t"
      "mov.b64 {l4, h4}, t4;\n\t"
      "mov.b64 {l5, h5}, t5;\n\t"
      "mov.b64 {l6, h6}, t6;\n\t"
      "mov.b64 {l7, h7}, t7;\n\t"
      "add.cc.u32 %0, %9, l0;\n\t"
      "addc.cc.u32 %1, %10, l1;\n\t"
      "addc.cc.u32 %2, %11, l2;\n\t"
      "addc.cc.u32 %3, %12, l3;\n\t"
      "addc.cc.u32 %4, %13, l4;\n\t"
      "addc.cc.u32 %5, %14, l5;\n\t"
      "addc.cc.u32 %6, %15, l6;\n\t"
      "addc.cc.u32 %7, %16, l7;\n\t"
      "addc.u32 %8, h7, 0;\n\t"
      "add.cc.u32 %1, %1, h0;\n\t"
      "addc.cc.u32 %2, %2, h1;\n\t"
      "addc.cc.u32 %3, %3, h2;\n\t"
      "addc.cc.u32 %4, %4, h3;\n\t"
      "addc.cc.u32 %5, %5, h4;\n\t"
      "addc.cc.u32 %6, %6, h5;\n\t"
      "addc.cc.u32 %7, %7, h6;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "}"
      : "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]),
        "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7]), "=&r"(carry)
      : "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(w[4]), "r"(w[5]), "r"(w[6]),
        "r"(w[7]), "r"(w[8]), "r"(w[9]), "r"(w[10]), "r"(w[11]), "r"(w[12]), "r"(w[13]),
        "r"(w[14]), "r"(w[15]));
#else
  uint64_t c = 0;
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)w[k] + (uint64_t)w[k + 8] * 38u;
    r.v[k] = (uint32_t)c;
    c >>= 32;
  }
  carry = (uint32_t)c;
#endif
  fe_fold(r, carry + over);
  return r;
}

// a * b mod p for any a, b below 2^256; the result is below 2^256.  Row i of
// the schoolbook (b_i times a) splits into its products with even and odd
// j, each a run of disjoint word pairs (mac4): the even runs add into e at
// word i and the odd runs into d at word i + 1, two independent wavefronts
// of carry chains.  Their sum goes to fe_reduce as two halves added
// side by side: a carry out of the low half is 2^256 (38), one out of the
// high half 2^512 (38^2).
__host__ __device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t e[17], d[17], w[16];
#pragma unroll
  for (int k = 0; k < 17; ++k) e[k] = d[k] = 0;
  const uint32_t* x = a.v;
  const uint32_t* y = b.v;
  mul4<0>(e, x[0], y[0], x[2], y[0], x[4], y[0], x[6], y[0]);
  mul4<1>(d, x[1], y[0], x[3], y[0], x[5], y[0], x[7], y[0]);
  mac4<1>(e, x[0], y[1], x[2], y[1], x[4], y[1], x[6], y[1]);
  mac4<2>(d, x[1], y[1], x[3], y[1], x[5], y[1], x[7], y[1]);
  mac4<2>(e, x[0], y[2], x[2], y[2], x[4], y[2], x[6], y[2]);
  mac4<3>(d, x[1], y[2], x[3], y[2], x[5], y[2], x[7], y[2]);
  mac4<3>(e, x[0], y[3], x[2], y[3], x[4], y[3], x[6], y[3]);
  mac4<4>(d, x[1], y[3], x[3], y[3], x[5], y[3], x[7], y[3]);
  mac4<4>(e, x[0], y[4], x[2], y[4], x[4], y[4], x[6], y[4]);
  mac4<5>(d, x[1], y[4], x[3], y[4], x[5], y[4], x[7], y[4]);
  mac4<5>(e, x[0], y[5], x[2], y[5], x[4], y[5], x[6], y[5]);
  mac4<6>(d, x[1], y[5], x[3], y[5], x[5], y[5], x[7], y[5]);
  mac4<6>(e, x[0], y[6], x[2], y[6], x[4], y[6], x[6], y[6]);
  mac4<7>(d, x[1], y[6], x[3], y[6], x[5], y[6], x[7], y[6]);
  mac4<7>(e, x[0], y[7], x[2], y[7], x[4], y[7], x[6], y[7]);
  mac4<8>(d, x[1], y[7], x[3], y[7], x[5], y[7], x[7], y[7]);
  const uint32_t low = add8<0>(w, e, d);
  const uint32_t high = add8<8>(w, e, d);
  return fe_reduce(w, low + 38u * high);
}

// a^2 mod p for any a below 2^256, below 2^256: the 28 cross products a_i a_j
// (i < j) in seven runs of four (one run per mac4: each run's products land
// on words 2 apart), the runs at odd words adding into e and at even words
// into d; then 2 (e + d) plus the eight squares, each sum in two halves.
__host__ __device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  uint32_t e[17], d[17], s[16], sq[17], twice[17], w[16];
#pragma unroll
  for (int k = 0; k < 17; ++k) e[k] = d[k] = 0;
  const uint32_t* x = a.v;
  mul4<1>(e, x[0], x[1], x[1], x[2], x[2], x[3], x[3], x[4]);  // words 1, 3, 5, 7
  mac4<3>(e, x[0], x[3], x[1], x[4], x[2], x[5], x[3], x[6]);  // 3 .. 9
  mac4<5>(e, x[0], x[5], x[1], x[6], x[2], x[7], x[4], x[7]);  // 5 .. 11
  mac4<7>(e, x[0], x[7], x[4], x[5], x[5], x[6], x[6], x[7]);  // 7 .. 13
  mul4<2>(d, x[0], x[2], x[1], x[3], x[2], x[4], x[3], x[5]);  // 2 .. 8
  mac4<4>(d, x[0], x[4], x[1], x[5], x[2], x[6], x[3], x[7]);  // 4 .. 10
  mac4<6>(d, x[0], x[6], x[1], x[7], x[4], x[6], x[5], x[7]);  // 6 .. 12
  // s = e + d in halves, doubled: a carry out of the low half is worth 2^257
  // (2 * 38), one out of the high half 2^513 (2 * 38^2), s's top bit 2^512.
  const uint32_t low = add8<0>(s, e, d);
  const uint32_t high = add8<8>(s, e, d);
  const uint32_t top = s[15] >> 31;
  twice[16] = sq[16] = 0;
  twice[0] = s[0] << 1;
#pragma unroll
  for (int k = 1; k < 16; ++k) twice[k] = (s[k] << 1) | (s[k - 1] >> 31);
  mul4<0>(sq, x[0], x[0], x[1], x[1], x[2], x[2], x[3], x[3]);
  mul4<8>(sq, x[4], x[4], x[5], x[5], x[6], x[6], x[7], x[7]);
  const uint32_t low2 = add8<0>(w, sq, twice);
  const uint32_t high2 = add8<8>(w, sq, twice);
  return fe_reduce(w, 2u * low + low2 + 38u * (2u * high + top + high2));
}

__host__ __device__ __forceinline__ Fe fe_sq_n(Fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = fe_sqr(a);
  return a;
}

// z^(p-2) = z^(2^255 - 21), by the chain of 254 squarings and 11 multiplies
// (z = 0 mod p gives 0, as the reference's exponentiation does).
__host__ __device__ __forceinline__ Fe fe_invert(const Fe& z) {
  const Fe z2 = fe_sqr(z);
  const Fe z9 = fe_mul(fe_sq_n(z2, 2), z);
  const Fe z11 = fe_mul(z9, z2);
  const Fe z_5_0 = fe_mul(fe_sqr(z11), z9);              // 2^5 - 1
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
    x = fe_select(borrow == 0, d, x);
  }
  return x;
}

}  // namespace ed25519

#endif  // MIRBFT_ED25519_FIELD_CUH_
