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
//   by the bit pair (s + 2h in wrapping int32; any other value picks the
//   identity, as the reference's select does).  The formulas are the
//   reference's (dbl-2008-hwcd and add-2008-hwcd-3), so every coordinate
//   stays congruent mod p to the reference's at every step, whatever the
//   inputs.
// - Strict R: Z is inverted (z^(p-2), by the standard chain of 254 squarings
//   and 11 multiplies; z = 0 gives 0), x and y are frozen to [0, p), and y
//   with x's low bit in bit 255 is compared with the 32 raw R bytes.  A
//   non-canonical R (y >= p) cannot match.  An R byte outside [0, 255] fails
//   the row, as its int32 compare does in the reference.
// - S < L and the challenge h = SHA-512(R || A || M) mod L stay on the host;
//   padding rows arrive all zero, run like any row, and the host masks them.
//
// Layout: four lanes per signature, eight signatures per warp, one warp per
// CTA (a 1,024-row wave is 128 CTAs, one on each of 128 SMs).  Every stage of
// both formulas is four independent field multiplies (doubling: X^2, Y^2, Z^2,
// (X+Y)^2, then EF, GH, FG, EH; addition: (Y-X)(Y2-X2), (Y+X)(Y2+X2), Z 2Z2,
// T 2dT2, then the same four), so lane k of a group keeps coordinate k of Q
// (X, Y, Z, T) and runs the k-th multiply of each stage.  Between stages the
// products go to the lanes by __shfl_sync: in the doubling each lane takes
// all four and forms E, F, G, H; in the addition each takes the four its
// two operands need and forms them with a signed add.  Lane k also keeps its quarter of the three table
// points B, -A and B-A (cached form Y-X, Y+X, 2Z, 2dT: lane k the k-th) in
// registers and picks one with selects; the identity's quarter is a constant.
// The inversion runs on every lane of the group (the same z), after which
// lanes 0 and 1 multiply out x and y and lane 1 writes the verdict.  A
// partial last warp runs its spare groups on the last row and stores nothing
// from them, because every lane must take part in each shuffle.
//
// Field arithmetic (csrc/ed25519_field.cuh): 8 x 32-bit limbs mod
// 2^256 - 38, products by IMAD.WIDE.U32 and carry chains in PTX, a dedicated
// squaring (36 wide products, not 64).
//
// What bounds it: one signature is ~4,375 field multiplies (the setup's dozen,
// 256 doublings and 256 additions of 8 each, the inversion's 265, and 2 for x
// and y), each 64 wide products and the fold: at the card's IMAD rate (64
// lanes per SM per clock, 132 SMs) a wave of 1,024 signatures is ~0.04 ms of
// multiplies, and its bytes (2.4 KB of inputs a row) are less.  What bounds
// the design is one lane's chain: below ~4,000 rows each SM holds at most one
// warp a scheduler, so a launch lasts as long as the ~1,295 multiplies one
// lane runs in series (5 to set up, 4 a ladder step, the inversion's 265, 1
// for x or y) and the adds and shuffles between them.  On an H100 a
// multiply in that chain takes ~620 cycles and a squaring ~460 (its 72 or
// 44 IMAD.WIDE.U32 issue every ~6.8 cycles on one scheduler, and its carry
// chains depend on them); an add ~80 (csrc/latency_probe.cu's field and
// issue probes); a multiply is bound by issue, not by its own latency.  The
// inversion is ~12% of the chain.  Eight lanes a signature, a pair
// splitting each multiply's products, measured only 3% faster at 1,024 rows
// and 25% slower at 4,096 (PERF.md), so four lanes it is.
//
// Outside the field's PTX blocks the code is plain C++ on uint32_t /
// uint64_t, and each block has a C++ form.  The per-lane work is written
// against a group interface (`run` a phase on each lane, `pull` a value from
// another lane of the group): on the card a group is four threads and `pull`
// is __shfl_sync; built for the host with a C++ compiler (outside
// __CUDACC__), `HostGroup` holds the four lanes and runs them in turn between
// exchanges, which is how the same per-lane code is checked without a card.
//
// Plain C interface for ctypes: the launcher takes device pointers, the row
// count and a cudaStream_t, launches on that stream without synchronising or
// allocating, and returns cudaGetLastError().

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "ed25519_field.cuh"

namespace ed25519 {

__host__ __device__ __forceinline__ Fe k2d() {  // 2d mod p
  return fe_const(0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
                  0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu);
}

// Coordinate k of the base point B (X, Y, Z = 1, T = XY).
__host__ __device__ __forceinline__ Fe base_coordinate(int k) {
  const Fe x = fe_const(0x8f25d51au, 0xc9562d60u, 0x9525a7b2u, 0x692cc760u, 0xfdd6dc5cu,
                        0xc0a4e231u, 0xcd6e53feu, 0x216936d3u);
  const Fe y = fe_const(0x66666658u, 0x66666666u, 0x66666666u, 0x66666666u, 0x66666666u,
                        0x66666666u, 0x66666666u, 0x66666666u);
  const Fe t = fe_const(0xa5b7dda3u, 0x6dde8ab3u, 0x775152f5u, 0x20f09f80u, 0x64abe37du,
                        0x66ea4e8eu, 0xd78b7665u, 0x67875f0fu);
  return fe_select(k == 0, x, fe_select(k == 1, y, fe_select(k == 2, fe_small(1), t)));
}

// Quarter k of B's cached form (Y - X, Y + X, 2Z, 2dT), reduced mod p.
__host__ __device__ __forceinline__ Fe base_cached(int k) {
  const Fe ymx = fe_const(0xd740913eu, 0x9d103905u, 0xd140beb3u, 0xfd399f05u, 0x688f8a09u,
                          0xa5c18434u, 0x98f81267u, 0x44fd2f92u);
  const Fe ypx = fe_const(0xf58c3b85u, 0x2fbc93c6u, 0xfb8c0e19u, 0xcf932dc6u, 0x643d42c2u,
                          0x270b4898u, 0x33d4ba65u, 0x07cf9d3au);
  const Fe t2d = fe_const(0x877aaa68u, 0xabc91205u, 0xccaac49eu, 0x26d9e823u, 0xdd43598cu,
                          0x5a1b7dcbu, 0x9f0c65a8u, 0x6f117b68u);
  return fe_select(k == 0, ymx, fe_select(k == 1, ypx, fe_select(k == 2, fe_small(2), t2d)));
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

// One lane of a signature's group of four.
struct Lane {
  int k;        // 0..3: the coordinate of Q this lane keeps (X, Y, Z, T)
  Fe v;         // coordinate k of Q
  Fe tab[3];    // quarter k of the cached table points B, -A, B - A
  Fe send;      // what this lane gives at the next exchange
  Fe got[4];    // what it took
  uint8_t ok;   // the verdict (lane 1)
};

// Quarter k of the table point the bit pair picks; 0 and any value outside
// [1, 3] pick the identity, whose cached form is (1, 1, 2, 0).
__host__ __device__ __forceinline__ Fe pick_quarter(const Lane& l, int32_t pick) {
  const Fe identity = fe_small(l.k == 3 ? 0u : (l.k == 2 ? 2u : 1u));
  return fe_select(pick == 1, l.tab[0],
                   fe_select(pick == 2, l.tab[1], fe_select(pick == 3, l.tab[2], identity)));
}

struct FromLane0 {
  __host__ __device__ int operator()(int) const { return 0; }
};
struct FromLane1 {
  __host__ __device__ int operator()(int) const { return 1; }
};
struct FromLane2 {
  __host__ __device__ int operator()(int) const { return 2; }
};
struct FromLane3 {
  __host__ __device__ int operator()(int) const { return 3; }
};
struct FromPartner {  // X <-> Y, Z <-> T
  __host__ __device__ int operator()(int k) const { return k ^ 1; }
};

// Every lane takes the four lanes' `send` into got[0..3].
template <class G>
__host__ __device__ __forceinline__ void pull_all(G& g) {
  g.template pull<0>(FromLane0());
  g.template pull<1>(FromLane1());
  g.template pull<2>(FromLane2());
  g.template pull<3>(FromLane3());
}

// dbl-2008-hwcd (a = -1), as the reference's `_pt_double`: A = X^2,
// B = Y^2, C = 2Z^2, H = A + B, E = H - (X + Y)^2, G = A - B, F = C + G.
template <class G>
__host__ __device__ __forceinline__ void pt_double(G& g) {
  g.run([](Lane& l) { l.send = l.v; });
  g.template pull<0>(FromLane0());
  g.template pull<1>(FromLane1());
  g.run([](Lane& l) {
    l.send = fe_sqr(fe_select(l.k == 3, fe_add(l.got[0], l.got[1]), l.v));
  });
  pull_all(g);
  g.run([](Lane& l) {
    // Lane k computes coordinate k of X = EF, Y = GH, Z = FG, T = EH.
    const Fe h = fe_add(l.got[0], l.got[1]);
    const Fe gg = fe_sub(l.got[0], l.got[1]);
    const Fe e = fe_sub(h, l.got[3]);
    const Fe f = fe_add(fe_add(l.got[2], l.got[2]), gg);
    l.v = fe_mul(fe_select(l.k == 1, gg, fe_select(l.k == 2, f, e)),
                 fe_select(l.k == 0, f, fe_select(l.k == 2, gg, h)));
  });
}

// Sources of the second stage of the addition: lane k forms its two
// operands from the products A, B, D, C of lanes 0-3 as x = P[XFirst] -+
// P[XSecond], y = P[YFirst] -+ P[YSecond]: lane 0 E = B - A and F = D - C,
// lane 1 G = D + C and H = B + A, lane 2 F and G, lane 3 E and H.
struct XFirst {
  __host__ __device__ int operator()(int k) const { return k == 1 || k == 2 ? 2 : 1; }
};
struct XSecond {
  __host__ __device__ int operator()(int k) const { return k == 1 || k == 2 ? 3 : 0; }
};
struct YFirst {
  __host__ __device__ int operator()(int k) const { return k & 1 ? 1 : 2; }
};
struct YSecond {
  __host__ __device__ int operator()(int k) const { return k & 1 ? 0 : 3; }
};

// add-2008-hwcd-3 (a = -1, k = 2d), as the reference's `_pt_add`, with the
// addend cached: A = (Y - X)(Y2 - X2), B = (Y + X)(Y2 + X2), C = T (2d T2),
// D = Z (2 Z2), E = B - A, F = D - C, G = D + C, H = B + A.  Lanes 0-3 run
// A, B, D, C, and each lane pulls only the four products its two operands
// need.
template <class G>
__host__ __device__ __forceinline__ void pt_add(G& g, int32_t pick) {
  g.run([](Lane& l) { l.send = l.v; });
  g.template pull<0>(FromPartner());
  g.run([pick](Lane& l) {
    const Fe in = fe_select(l.k == 0, fe_sub(l.got[0], l.v),
                            fe_select(l.k == 1, fe_add(l.v, l.got[0]), l.v));
    l.send = fe_mul(in, pick_quarter(l, pick));
  });
  g.template pull<0>(XFirst());
  g.template pull<1>(XSecond());
  g.template pull<2>(YFirst());
  g.template pull<3>(YSecond());
  g.run([](Lane& l) {
    l.v = fe_mul(fe_addsub(l.got[0], l.got[1], l.k != 1),
                 fe_addsub(l.got[2], l.got[3], l.k == 0));
  });
}

// One signature on the group `g`, its lanes' `k` set: lane 1's `ok` is 1 iff
// compress([S]B + [h](-A)) == R.  Every lane reads the row.
template <class G>
__host__ __device__ __forceinline__ void verify_group(G& g, const int32_t* ax,
                                                      const int32_t* ay,
                                                      const int32_t* r_bytes,
                                                      const int32_t* s_bits,
                                                      const int32_t* h_bits) {
  // The table: B's quarter is a constant; -A = (-x, y, 1, -xy) cached is
  // (y + x, y - x, 2, 2d(-xy)); B - A starts as B.
  g.run([ax, ay](Lane& l) {
    const Fe neg_ax = fe_sub(fe_small(0), fe_from_bytes(ax));
    const Fe a_y = fe_from_bytes(ay);
    const Fe t2d = fe_mul(fe_mul(neg_ax, a_y), k2d());
    l.tab[0] = base_cached(l.k);
    l.tab[1] = fe_select(l.k == 0, fe_sub(a_y, neg_ax),
                         fe_select(l.k == 1, fe_add(a_y, neg_ax),
                                   fe_select(l.k == 2, fe_small(2), t2d)));
    l.v = base_coordinate(l.k);
  });
  pt_add(g, 2);  // B + (-A)
  g.run([](Lane& l) { l.send = l.v; });
  g.template pull<0>(FromPartner());
  g.run([](Lane& l) {
    const Fe z2_or_t2d = fe_select(l.k == 2, fe_add(l.v, l.v), fe_mul(l.v, k2d()));
    l.tab[2] = fe_select(l.k == 0, fe_sub(l.got[0], l.v),
                         fe_select(l.k == 1, fe_add(l.v, l.got[0]), z2_or_t2d));
    l.v = fe_small(l.k == 1 || l.k == 2 ? 1u : 0u);  // Q = the identity (0, 1, 1, 0)
  });

  // The bit pair of step i - 1 loads during step i.
  int32_t pick = (int32_t)((uint32_t)s_bits[255] + 2u * (uint32_t)h_bits[255]);
#pragma unroll 1
  for (int i = 255; i >= 0; --i) {
    const int32_t next =
        i > 0 ? (int32_t)((uint32_t)s_bits[i - 1] + 2u * (uint32_t)h_bits[i - 1]) : 0;
    pt_double(g);
    pt_add(g, pick);
    pick = next;
  }

  // Every lane inverts Z; lanes 0 and 1 take x and y; lane 1 compares.
  g.run([](Lane& l) { l.send = l.v; });
  g.template pull<0>(FromLane2());
  g.run([](Lane& l) { l.send = fe_freeze(fe_mul(l.v, fe_invert(l.got[0]))); });
  g.template pull<0>(FromLane0());
  g.run([r_bytes](Lane& l) {
    Fe y = l.send;
    y.v[7] |= (l.got[0].v[0] & 1u) << 31;
    const Fe r = fe_from_bytes(r_bytes);
    uint32_t diff = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) diff |= y.v[k] ^ r.v[k];
#pragma unroll
    for (int k = 0; k < 32; ++k) diff |= (uint32_t)r_bytes[k] & ~0xffu;
    l.ok = diff == 0 ? 1 : 0;
  });
}

constexpr int kLanesPerRow = 4;
constexpr int kThreads = 32;  // one warp per CTA
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;

// The row a group runs: its own, or in a partial last warp the last row (its
// verdict is not stored).
__host__ __device__ __forceinline__ long long group_row(long long group, long long rows) {
  return group < rows ? group : rows - 1;
}

#ifndef __CUDACC__
// A group on the host: the four lanes, each phase run on them in turn.
struct HostGroup {
  Lane lane[kLanesPerRow];
  template <class F>
  void run(F f) {
    for (Lane& l : lane) f(l);
  }
  template <int kSlot, class S>
  void pull(S src) {
    Fe sent[kLanesPerRow];
    for (int k = 0; k < kLanesPerRow; ++k) sent[k] = lane[k].send;
    for (Lane& l : lane) l.got[kSlot] = sent[src(l.k)];
  }
};

// The launch, run on the host group by group, whole warps of groups as on
// the card.
inline void verify_host(const int32_t* ax, const int32_t* ay, const int32_t* r_bytes,
                        const int32_t* s_bits, const int32_t* h_bits, long long rows,
                        uint8_t* out) {
  const long long groups = (rows + kRowsPerBlock - 1) / kRowsPerBlock * kRowsPerBlock;
  for (long long group = 0; group < groups; ++group) {
    const long long row = group_row(group, rows);
    HostGroup g;
    for (int k = 0; k < kLanesPerRow; ++k) g.lane[k].k = k;
    verify_group(g, ax + row * 32, ay + row * 32, r_bytes + row * 32, s_bits + row * 256,
                 h_bits + row * 256);
    if (group < rows) out[group] = g.lane[1].ok;
  }
}
#endif  // !__CUDACC__

}  // namespace ed25519

#ifdef __CUDACC__

namespace {

// A group on the card: this thread's lane; `pull` shuffles within the warp.
struct WarpGroup {
  ed25519::Lane lane;
  int base;  // the warp lane of the group's lane 0
  template <class F>
  __host__ __device__ __forceinline__ void run(F f) {
    f(lane);
  }
  template <int kSlot, class S>
  __host__ __device__ __forceinline__ void pull(S src) {
#ifdef __CUDA_ARCH__
    const int from = base + src(lane.k);
#pragma unroll
    for (int w = 0; w < 8; ++w)
      lane.got[kSlot].v[w] = __shfl_sync(0xffffffffu, lane.send.v[w], from);
#endif
  }
};

__global__ void __launch_bounds__(ed25519::kThreads)
ed25519_verify_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                      const int32_t* __restrict__ r_bytes,
                      const int32_t* __restrict__ s_bits,
                      const int32_t* __restrict__ h_bits, long long rows,
                      uint8_t* __restrict__ out) {
  const long long group =
      (long long)blockIdx.x * ed25519::kRowsPerBlock + threadIdx.x / ed25519::kLanesPerRow;
  const long long row = ed25519::group_row(group, rows);
  WarpGroup g;
  g.lane.k = threadIdx.x % ed25519::kLanesPerRow;
  g.base = threadIdx.x - g.lane.k;
  ed25519::verify_group(g, ax + row * 32, ay + row * 32, r_bytes + row * 32,
                        s_bits + row * 256, h_bits + row * 256);
  if (group < rows && g.lane.k == 1) out[group] = g.lane.ok;
}

}  // namespace

extern "C" int mirbft_ed25519_verify(const void* ax, const void* ay, const void* r_bytes,
                                     const void* s_bits, const void* h_bits,
                                     long long rows, void* out, void* stream) {
  const unsigned grid =
      (unsigned)((rows + ed25519::kRowsPerBlock - 1) / ed25519::kRowsPerBlock);
  ed25519_verify_kernel<<<grid, ed25519::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)r_bytes,
      (const int32_t*)s_bits, (const int32_t*)h_bits, rows, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
