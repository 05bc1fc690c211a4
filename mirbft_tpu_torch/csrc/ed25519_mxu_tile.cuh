// The registers and the K tile of the "mxu" Ed25519 verify kernel
// (csrc/ed25519_mxu.cu, whose head note describes the design): the
// kernel's constants and staged-operand layout, a register as the card's
// value or, outside `__CUDACC__`, as `Lanes<T>` (its 32 lanes' values, for
// the host build), and the K tile of the contraction with its lane
// constants.  csrc/latency_probe.cu's `tile` probe times the same code, so
// there is one copy of the tile.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MXU_INLINE __device__ __forceinline__
#define MXU_CALL __device__ __noinline__
#define MXU_TABLE __constant__ const
#else
#include <cstring>
#include <memory>
#define MXU_INLINE inline
#define MXU_CALL inline
#define MXU_TABLE static const
#endif
#include <stdint.h>

namespace mxu {

constexpr int kLimbs = 32;
constexpr int kSigs = 8;        // signatures a group: the MMA's N; warp s owns the s-th
constexpr int kTiles = 4;       // M tiles: tile q holds output limbs [8q, 8q + 8)
constexpr int kHalves = 2;      // the 32 K tiles of an M tile, in two halves
constexpr int kWarps = kTiles * kHalves;  // warp w: half w / 4 of M tile w % 4
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;       // independent multiplies contracted together
constexpr int kRow = 36;        // words a row of a product buffer (bank-conflict free)
constexpr int kAStride = 68;    // words a row of a nibbles
constexpr int kWStride = 84;    // words a row of packed b nibbles; 84 = 20 mod 32
constexpr int kWOffset = 16;    // w[s][kWOffset + j] for j in [-16, 64)
// 16 x (1008 + 65536 x 1008): a packed pair of nibble products t, biased by
// 1008 = 63 x 16 each (t + 1008 in [16, 2032]), times 16.
constexpr uint32_t kBias = (1008u + (1008u << 16)) << 4;

// The staged operands of a multiply: the a nibbles and the packed b nibbles.
struct Staged {
  int32_t an[kSigs][kAStride];
  int32_t w[kSigs][kWStride];
};

// ---------------------------------------------------------------------------
// Registers.  On the card a register is a value of its thread; on the host,
// `Lanes<T>` holds the 32 lanes' values and every operation runs lane-wise.
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
using I32 = int32_t;
using U32 = uint32_t;
using I64 = long long;
using Pred = bool;

MXU_INLINE U32 u32(I32 x) { return (U32)x; }
MXU_INLINE I32 s32(U32 x) { return (I32)x; }
MXU_INLINE I64 s64(I32 x) { return (I64)x; }
template <class T>
MXU_INLINE T sel(Pred c, T a, T b) {
  return c ? a : b;
}
MXU_INLINE I32 table_at(const uint8_t* t, I32 k) { return t[k]; }
MXU_INLINE I32 lane_id() { return (I32)(threadIdx.x & 31); }
MXU_INLINE I32 shfl(I32 v, I32 src) { return __shfl_sync(0xffffffffu, v, src); }
MXU_INLINE U32 prmt(U32 a, U32 b, unsigned s) { return __byte_perm(a, b, s); }
MXU_INLINE I32 lds(const int32_t* base, I32 i) { return base[i]; }
MXU_INLINE void lds2(const int32_t* base, I32 i, I32 out[2]) {
  const int2 v = *reinterpret_cast<const int2*>(base + i);
  out[0] = v.x;
  out[1] = v.y;
}
MXU_INLINE void sts(int32_t* base, I32 i, I32 v) { base[i] = v; }
MXU_INLINE I32 ldg(const int32_t* base, I64 i) { return base[i]; }
MXU_INLINE void sts2(int32_t* base, I32 i, const I32* v) {
  *reinterpret_cast<int2*>(base + i) = make_int2(v[0], v[1]);
}
MXU_INLINE void sts2_if(Pred p, int32_t* base, I32 i, const I32* v) {
  if (p) sts2(base, i, v);
}
MXU_INLINE void warp_sync() { __syncwarp(); }
// D += A B, one warp's m16n8k32 MMA of int8 A and uint8 B.
MXU_INLINE void mma(I32 d[4], const U32 a[4], const U32 b[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#else
template <class T>
struct Lanes {
  T v[32];
  Lanes() : v() {}
  Lanes(T x) {  // the same value in every lane
    for (T& e : v) e = x;
  }
  T& operator[](int i) { return v[i]; }
  const T& operator[](int i) const { return v[i]; }
#define MXU_LANEWISE(op)                                          \
  friend Lanes operator op(const Lanes& a, const Lanes& b) {      \
    Lanes r;                                                      \
    for (int i = 0; i < 32; ++i) r.v[i] = (T)(a.v[i] op b.v[i]);  \
    return r;                                                     \
  }
  MXU_LANEWISE(+)
  MXU_LANEWISE(-)
  MXU_LANEWISE(*)
  MXU_LANEWISE(&)
  MXU_LANEWISE(|)
  MXU_LANEWISE(^)
  MXU_LANEWISE(>>)
#undef MXU_LANEWISE
#define MXU_COMPARE(op)                                              \
  friend Lanes<bool> operator op(const Lanes& a, const Lanes& b) {   \
    Lanes<bool> r;                                                   \
    for (int i = 0; i < 32; ++i) r.v[i] = a.v[i] op b.v[i];          \
    return r;                                                        \
  }
  MXU_COMPARE(==)
  MXU_COMPARE(!=)
  MXU_COMPARE(<)
  MXU_COMPARE(<=)
  MXU_COMPARE(>=)
  MXU_COMPARE(&&)
#undef MXU_COMPARE
  // Left shifts as the card's: of the unsigned bits.
  friend Lanes operator<<(const Lanes& a, const Lanes& b) {
    Lanes r;
    for (int i = 0; i < 32; ++i) r.v[i] = (T)((uint32_t)a.v[i] << b.v[i]);
    return r;
  }
};
using I32 = Lanes<int32_t>;
using U32 = Lanes<uint32_t>;
using I64 = Lanes<long long>;
using Pred = Lanes<bool>;

inline U32 u32(const I32& x) {
  U32 r;
  for (int i = 0; i < 32; ++i) r[i] = (uint32_t)x[i];
  return r;
}
inline I32 s32(const U32& x) {
  I32 r;
  for (int i = 0; i < 32; ++i) r[i] = (int32_t)x[i];
  return r;
}
inline I64 s64(const I32& x) {
  I64 r;
  for (int i = 0; i < 32; ++i) r[i] = x[i];
  return r;
}
inline I32 table_at(const uint8_t* t, const I32& k) {
  I32 r;
  for (int i = 0; i < 32; ++i) r[i] = t[k[i]];
  return r;
}
template <class T>
inline Lanes<T> sel(const Pred& c, const Lanes<T>& a, const Lanes<T>& b) {
  Lanes<T> r;
  for (int i = 0; i < 32; ++i) r[i] = c[i] ? a[i] : b[i];
  return r;
}
inline I32 lane_id() {
  I32 r;
  for (int i = 0; i < 32; ++i) r[i] = i;
  return r;
}
inline I32 shfl(const I32& v, const I32& src) {
  I32 r;
  for (int i = 0; i < 32; ++i) r[i] = v[src[i] & 31];
  return r;
}
// __byte_perm: byte n of the result is byte (s >> 4n) & 7 of {b, a}.
inline U32 prmt(const U32& a, const U32& b, unsigned s) {
  U32 r;
  for (int i = 0; i < 32; ++i) {
    const uint64_t both = (uint64_t)a[i] | ((uint64_t)b[i] << 32);
    uint32_t out = 0;
    for (int n = 0; n < 4; ++n)
      out |= (uint32_t)((both >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
    r[i] = out;
  }
  return r;
}
inline I32 lds(const int32_t* base, const I32& i) {
  I32 r;
  for (int l = 0; l < 32; ++l) r[l] = base[i[l]];
  return r;
}
inline void lds2(const int32_t* base, const I32& i, I32 out[2]) {
  for (int k = 0; k < 2; ++k) out[k] = lds(base, i + k);
}
inline void sts(int32_t* base, const I32& i, const I32& v) {
  for (int l = 0; l < 32; ++l) base[i[l]] = v[l];
}
inline void sts2_if(const Pred& p, int32_t* base, const I32& i, const I32* v) {
  for (int l = 0; l < 32; ++l)
    if (p[l])
      for (int k = 0; k < 2; ++k) base[i[l] + k] = v[k][l];
}
inline void sts2(int32_t* base, const I32& i, const I32* v) { sts2_if(Pred(true), base, i, v); }
inline void warp_sync() {}
inline I32 ldg(const int32_t* base, const I64& i) {
  I32 r;
  for (int l = 0; l < 32; ++l) r[l] = base[i[l]];
  return r;
}
// D += A B for one warp's m16n8k32 MMA (A int8, B uint8), from the 32 lanes' fragments by
// the PTX ISA's layouts: A register r, byte b of lane (g, tig) is row
// g + 8 (r & 1), column 4 tig + b + 16 (r >> 1); B register r, byte b is row
// 4 tig + b + 16 r, column g; D element r is row g + 8 (r >> 1), column
// 2 tig + (r & 1).  The sums run over the nonzero entries of A's row.
inline void mma(I32 d[4], const U32 a[4], const U32 b[2]) {
  int32_t bm[32][8];
  int nonzero[16] = {}, at[16][32], weight[16][32];
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, tig = lane & 3;
    for (int r = 0; r < 4; ++r)
      for (int byte = 0; byte < 4; ++byte) {
        const int8_t v = (int8_t)(a[r][lane] >> (8 * byte));
        const int row = g + 8 * (r & 1);
        if (v) {
          at[row][nonzero[row]] = 4 * tig + byte + 16 * (r >> 1);
          weight[row][nonzero[row]++] = v;
        }
      }
    for (int r = 0; r < 2; ++r)
      for (int byte = 0; byte < 4; ++byte)
        bm[4 * tig + byte + 16 * r][g] = (uint8_t)(b[r][lane] >> (8 * byte));
  }
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, tig = lane & 3;
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r >> 1), col = 2 * tig + (r & 1);
      int32_t sum = 0;
      for (int e = 0; e < nonzero[row]; ++e) sum += weight[row][e] * bm[at[row][e]][col];
      d[r][lane] += sum;
    }
  }
}
#endif

// ---------------------------------------------------------------------------
// The K tiles of the contraction (see csrc/ed25519_mxu.cu's note): a lane's
// fold fragments, one tile, a block of 8 tiles of one weight, and the
// lane's constants.
// ---------------------------------------------------------------------------

// One A register of a lane where pair kk = 2g + odd of its tile has weight 1:
// byte b holds pair tig + {0, 8, 4, 12}[b] (0 where it is another).
MXU_INLINE U32 fold_fragment(const I32& g, const I32& tig, int odd) {
  const I32 d = g * 2 + odd - tig;  // 4 x {0, 2, 1, 3}[b] where it matches
  const I32 b = (((d >> 2) >> 1) | (((d >> 2) & 1) << 1)) & 3;
  return sel(Pred((d & 3) == 0), u32(I32(1) << (b * 8)), U32(0u));
}

// One tile: pairs i = i0 + h (the a nibbles at `ai`, staged times 16), b
// nibbles at `wi` + {0, 8} (h = 0) and `wi1` + {0, 8} (h = 1); products
// into the accumulators of 16 (t & 15) (lo) and (t >> 4) + 63 (hi).  One
// IMAD gives y = 16 ((t0 + 1008) + 65536 (t1 + 1008)) for two products:
// bytes 0 and 2 are 16 (t & 15) (their low nibbles are 0: t + 1008 < 4096),
// bytes 1 and 3 are (t >> 4) + 63, as uint8; one byte permute of two such
// words is a B register.
MXU_INLINE void tile(const int32_t* an, const int32_t* w, const I32& ai, const I32& wi,
                     const I32& wi1, const U32 a_frag[4], I32 lo[4], I32 hi[4]) {
  I32 a[2];
  lds2(an, ai, a);
  const U32 w0 = u32(lds(w, wi)), w1 = u32(lds(w, wi + 8));
  const U32 w2 = u32(lds(w, wi1)), w3 = u32(lds(w, wi1 + 8));
  const U32 y0 = w0 * u32(a[0]) + kBias, y1 = w1 * u32(a[0]) + kBias;
  const U32 y2 = w2 * u32(a[1]) + kBias, y3 = w3 * u32(a[1]) + kBias;
  const U32 b_lo[2] = {prmt(y0, y1, 0x6240), prmt(y2, y3, 0x6240)};
  const U32 b_hi[2] = {prmt(y0, y1, 0x7351), prmt(y2, y3, 0x7351)};
  mma(lo, a_frag, b_lo);
  mma(hi, a_frag, b_hi);
}

// The 8 tiles u = 8 blk + v, i0 = (16q + 16 blk + 2v) mod 64 (blk >= 1), of
// one weight: 38 while 16q + 2u < 64, else 1.
MXU_INLINE void tile_block(const Staged& st, int q, int blk, const I32& arow, const I32& wrow,
                           const I32& wrow1, const U32 one[4], const U32 wide[4], I32 lo[2][4],
                           I32 hi[2][4]) {
  const bool big = blk < 4 - q;
  const U32 a_frag[4] = {big ? wide[0] : one[0], big ? wide[1] : one[1], big ? wide[2] : one[2],
                         big ? wide[3] : one[3]};
  const I32 ai = arow + ((16 * q + 16 * blk) & 63), wi = wrow + (64 - 16 * blk),
            wi1 = wrow1 + (64 - 16 * blk);
#pragma unroll
  for (int v = 0; v < 8; ++v)
    tile(&st.an[0][0], &st.w[0][0], ai + 2 * v, wi - 2 * v, wi1 - 2 * v, a_frag, lo[v & 1],
         hi[v & 1]);
}

// A lane's constants of the contraction: its A registers of weight 1 and
// 38, and where its rows of the staged nibbles start.  The pairs of h = 1
// are the lane's at kk = tig + 1 (mod 4) + {0, 8, 4, 12}: its products take
// the b words of h = 0 (tig < 3) or those 4 nibbles lower (tig = 3), and
// its A registers differ from h = 0's.
struct LaneConsts {
  U32 one[4], wide[4];
  I32 g, tig, arow, wrow, wrow1;
};

MXU_INLINE LaneConsts lane_constants() {
  LaneConsts c;
  const I32 lane = lane_id(), tig1 = ((lane & 3) + 1) & 3;
  c.g = lane >> 2;
  c.tig = lane & 3;
  const U32 one[4] = {fold_fragment(c.g, c.tig, 0), fold_fragment(c.g, c.tig, 1),
                      fold_fragment(c.g, tig1, 0), fold_fragment(c.g, tig1, 1)};
  for (int r = 0; r < 4; ++r) {
    c.one[r] = one[r];
    c.wide[r] = one[r] * 38u;
  }
  c.arow = c.g * kAStride;
  c.wrow = c.g * kWStride + kWOffset + c.tig;
  c.wrow1 = c.wrow + tig1 - c.tig - 1;
  return c;
}

}  // namespace mxu
