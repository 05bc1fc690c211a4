// Batched Ed25519 verification with the field multiply's contraction on the
// tensor cores, written for Hopper (sm_90a): the "mxu" backend.
//
// ed25519_verify_mxu_kernel replaces the JAX package's "mxu" verification
//   program: `_verify_kernel_body` (mirbft_tpu/ops/ed25519.py:372) with the
//   field multiply `_mul_mxu` (:234) threaded through every point operation,
//   the table set-up and the inversion (`_kernel_for("mxu")`, :418).  Its
//   contract is the "vpu" kernel's (csrc/ed25519.cu): from the host packing
//   of `Ed25519BatchVerifier.pack_inputs` (ax, ay, r_bytes [B, 32] int32;
//   s_bits, h_bits [B, 256] int32) it writes one byte per row, 1 exactly when
//   compress([S]B + [h](-A)) == R.
//
// What it computes: the reference's program operation for operation, on the
// reference's representation, so every intermediate limb equals the JAX
// program's (and the plain twin's, `verify_torch(mul=_mul_mxu)`) and the
// verdicts follow.  A field element is 32 signed int32 limbs of radix 2^8
// under the loose invariant |limb| <= 511; add and sub are one `_carry`
// round, a multiply is `_mul_mxu` followed by four; the point formulas are
// `_pt_double` (dbl-2008-hwcd) and `_pt_add` (add-2008-hwcd-3, uncached, with
// the 2d factor as a multiply by the constant); the ladder runs 256 steps MSB
// first over {identity, B, -A, B - A} picked by s + 2h in wrapping int32; the
// inversion is the reference's square-and-multiply over the bits of p - 2
// (254 squarings, 252 multiplies); `_freeze` is six carry rounds, two
// sequential carries and two conditional subtractions of p.  Every row runs
// every step, branch free, so the rows of a block move in lockstep.
//
// The multiply (`_mul_mxu`): each limb splits into 4-bit nibbles, a & 15 in
// [0, 15] and a >> 4 in [-32, 31], 64 of them; the 4,096 nibble products
// t = an[i] bn[j] in [-992, 1024] split again into t & 15 and t >> 4, both
// int8; and the product is the contraction
//   c = t_lo Me + 16 t_hi Me + 16 t_lo Mo + 256 t_hi Mo
// with the reference's fold matrices Me, Mo [4096, 32] (entry 1 or 38 at
// column ((i + j) mod 64) / 2 for even, resp. odd, i + j; 38 = 2^256 mod p
// where i + j >= 64), then `_carry(c, 4)`.
//
// Exactness (design (a), int8): the tensor cores multiply int8 by int8 into
// int32 accumulators (mma.sync.m16n8k32.s32.s8.s8.s32), so every partial sum
// is an exact integer (|c| < 2^26), with no rounding argument needed; the
// weights 16 and 256 stay out of the B operand (16 x 38 = 608 does not fit
// int8) and are applied when the four int32 products are combined.  int8 also
// runs at twice bf16's dense rate.  Design (b), bf16 with f32 accumulators,
// would need each dot kept below 2^24 and gains nothing here.
//
// The contraction on the tensor cores.  A block verifies 16 signatures, the
// MMA's M: row r of the A operand is signature r.  Me and Mo are 256 KB each
// in int8, more than a block's shared memory, but they are bands: nibble pair
// (i, j) feeds output column ((i + j) mod 64) / 2 alone.  So the K dimension
// is cut along anti-diagonals: a K tile is the 32 pairs (i0 + h, S - i0 + kk)
// for h in {0, 1}, kk in [0, 16) (S a multiple of 16, i0 even), whose
// i + j = S + kk covers 16 consecutive positions.  Its even positions feed
// output limbs (S mod 64) / 2 + [0, 8), one N tile of Me, and its odd ones
// the same N tile of Mo; every other N tile of the tile is zero and is never
// issued.  Within the nonzero tile, B[kk, n] is the weight exactly when
// kk == 2n (Me) or 2n + 1 (Mo), and the weight is 1 for S < 64, 38 else: four
// constant B fragments, generated in registers from that index rule once per
// thread.  Tiles whose pairs fall outside [0, 64)^2 read zero nibbles.  Output
// limbs [8q, 8q + 8) take the tiles with S = 16q and S = 16q + 64: 40 tiles
// for every q, 160 in all, each four MMAs (t_lo and t_hi against Me and Mo),
// so 640 m16n8k32 MMAs a multiply for 16 rows.
//
// The A operand is formed by the threads in fragment order, from the nibbles
// staged in shared memory: a[r][i] as words, and b packed two nibbles a word,
// w[r][j] = bn[j] + 65536 bn[j + 4] (zero outside [0, 64)).  One IMAD gives
// two products, w a + 1024 (1 + 65536) = (t0 + 1024) + 65536 (t1 + 1024),
// both halves in [32, 2048]: t & 15 is the half's low nibble, t >> 4 its bits
// 4-11 less 64, turned into an int8 by two logic operations.  A thread's four
// bytes of a fragment register are the pairs kk = tig, tig + 8, tig + 4,
// tig + 12 of its row (the bytes of two packed words, interleaved); the B
// fragments follow the same order, which is all the K dimension needs.  Rows
// of w are 100 words apart (4 mod 32), so the 32 lanes of each fragment load
// hit 32 banks.
//
// Layout: one block of four warps for 16 signatures.  In a multiply, warp q
// runs the 40 tiles of output limbs [8q, 8q + 8) (its tensor cores, its share
// of the nibble products); every other field operation is row-local, and
// warp q runs it on rows [4q, 4q + 4), lane k on limb k (the carry passes go
// through shared memory to lane k + 1).  A multiply is: stage the nibbles
// (each warp its rows), a block barrier, the tiles, a block barrier, the carry
// (each warp its rows).  Field elements live in shared memory (`Shared::fe`,
// 2 KB each); the block takes ~81 KB of dynamic shared memory.  A partial
// last block runs its spare rows on the last row and stores nothing from them.
//
// What bounds it: one verification is 4,870 field multiplies (1 for -A's T,
// 9 for B - A, 256 x (8 + 9) in the ladder, 506 in the inversion, 2 for x and
// y).  Each is, a row, 4,096 nibble products and their two 4-bit halves,
// ~12,288 integer operations at the INT32 rate (132 SMs x 64 lanes), and
// 163,840 int8 multiply-adds in the MMAs issued (the dense formulation's
// [8192] x [8192, 32] x 2 is 524,288) at the int8 dense rate (1,979 TOPS).
// The integer work is the larger: ~3.7 ms for 1,024 rows against ~0.8 ms of
// MMAs (~2.6 dense).  What limits this design is one block's chain instead:
// 4,870 multiplies in series, each 40 tiles whose loads, integer work and
// MMAs the loop runs one after another, two block barriers and eight carry
// phases; a launch of up to one block per SM lasts that chain whatever its
// rows.  On an H100 that chain, not the bound, sets a launch's time (its
// times beside the vpu kernel's: PERF.md).  This is the simple, right
// design; making it fast is later work.
//
// Outside `__CUDACC__` this file is plain C++: `HostCtx` runs each phase on
// every lane of every warp in turn, and `mma_host` forms the product of the
// fragments by the PTX ISA's m16n8k32 fragment layouts, so the host build
// (g++, in the tests) checks the decomposition: the tiles, the packed
// products, the fragments and the combine, against the reference's
// `_mul_mxu` limb for limb.
//
// Plain C interface for ctypes: the launcher takes device pointers, the row
// count and a cudaStream_t, launches on that stream without synchronising or
// allocating, and returns the first CUDA error (setting the shared-memory
// size, or the launch).

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
constexpr int kRows = 16;                     // signatures a block: the MMA's M
constexpr int kWarps = 4;                     // warp q: output limbs [8q, 8q + 8)
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;  // and rows [4q, 4q + 4) elsewhere
constexpr int kTilesPerWarp = 40;
constexpr int kWStride = 100;  // words a row of packed b nibbles; 100 = 4 mod 32
constexpr int kWOffset = 16;   // w[r][kWOffset + j] for j in [-16, 84)
constexpr int kAStride = 66;   // words a row of a nibbles
constexpr int kCStride = 40;
constexpr int32_t kBias = 1024 + (1024 << 16);

// Field-element slots of `Shared::fe`.
enum Slot : int {
  kBX, kBY, kBZ, kBT,  // the base point B
  kMX, kMY, kMZ, kMT,  // -A
  kNX, kNY, kNZ, kNT,  // B - A
  kQX, kQY, kQZ, kQT,  // the ladder's accumulator Q
  kDX, kDY, kDZ, kDT,  // the addend the step's bit pair picks
  kK2D,                // 2d
  kT0, kT1, kT2, kT3, kT4, kT5, kT6, kT7, kT8, kT9, kT10, kT11,
  kSlots
};

struct Shared {
  int32_t fe[kSlots][kRows][kLimbs];
  int32_t w[kRows][kWStride];
  int32_t an[kRows][kAStride];
  int32_t c[kRows][kCStride];
  int32_t carry[kRows][kLimbs];
};

// Little-endian bytes of the constants, as the reference's int_to_limbs.
MXU_TABLE uint8_t kBaseX[32] = {
    0x1a, 0xd5, 0x25, 0x8f, 0x60, 0x2d, 0x56, 0xc9, 0xb2, 0xa7, 0x25, 0x95, 0x60, 0xc7, 0x2c, 0x69,
    0x5c, 0xdc, 0xd6, 0xfd, 0x31, 0xe2, 0xa4, 0xc0, 0xfe, 0x53, 0x6e, 0xcd, 0xd3, 0x36, 0x69, 0x21};
MXU_TABLE uint8_t kBaseT[32] = {
    0xa3, 0xdd, 0xb7, 0xa5, 0xb3, 0x8a, 0xde, 0x6d, 0xf5, 0x52, 0x51, 0x77, 0x80, 0x9f, 0xf0, 0x20,
    0x7d, 0xe3, 0xab, 0x64, 0x8e, 0x4e, 0xea, 0x66, 0x65, 0x76, 0x8b, 0xd7, 0x0f, 0x5f, 0x87, 0x67};
MXU_TABLE uint8_t k2D[32] = {
    0x59, 0xf1, 0xb2, 0x26, 0x94, 0x9b, 0xd6, 0xeb, 0x56, 0xb1, 0x83, 0x82, 0x9a, 0x14, 0xe0, 0x00,
    0x30, 0xd1, 0xf3, 0xee, 0xf2, 0x80, 0x8e, 0x19, 0xe7, 0xfc, 0xdf, 0x56, 0xdc, 0xd9, 0x06, 0x24};

MXU_INLINE int32_t base_y_limb(int k) { return k == 0 ? 0x58 : 0x66; }
MXU_INLINE int32_t p_limb(int k) { return k == 0 ? 0xed : (k == 31 ? 0x7f : 0xff); }
// Bit i of p - 2 = 2^255 - 21, for i < 255 (its low byte is 0xeb).
MXU_INLINE int inv_exp_bit(int i) { return i >= 8 ? 1 : (0xeb >> i) & 1; }

// ---------------------------------------------------------------------------
// The contraction's pieces, shared by the card and the host build.
// ---------------------------------------------------------------------------

// Tile t of output limbs [8q, 8q + 8): S and i0 (see the note above).
MXU_INLINE void tile_of(int q, int t, int& s0, int& i0) {
  const int first = 8 * (q + 1);  // tiles with S = 16q: i0 in [0, 16q + 14]
  if (t < first) {
    s0 = 16 * q;
    i0 = 2 * t;
  } else {             // S = 16q + 64: i0 in [16q, 62]
    s0 = 16 * q + 64;
    i0 = 16 * q + 2 * (t - first);
  }
}

// Pair kk of a tile that byte `byte` of a fragment register of lane group
// `tig` holds: kk = tig, tig + 8, tig + 4, tig + 12.
MXU_INLINE int pair_of(int tig, int byte) {
  return tig + 4 * ((byte & 1) * 2 + (byte >> 1));
}

// One B fragment register (both of a lane's registers are equal): weight
// `w` where pair kk feeds column n = groupID, i.e. kk == 2n + parity.
MXU_INLINE uint32_t b_fragment(int lane, int parity, int w) {
  const int n = lane >> 2, tig = lane & 3;
  uint32_t reg = 0;
  for (int byte = 0; byte < 4; ++byte)
    if (pair_of(tig, byte) == 2 * n + parity) reg |= (uint32_t)w << (8 * byte);
  return reg;
}

// The A fragments of one tile for one lane: t & 15 (lo) and t >> 4 (hi) of
// the pairs of rows n and n + 8 (registers 0 and 1: i = i0; 2 and 3: i0 + 1).
MXU_INLINE void a_fragments(const Shared& sh, int lane, int s0, int i0, uint32_t lo[4],
                            uint32_t hi[4]) {
  const int n = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int reg = 0; reg < 4; ++reg) {
    const int row = n + 8 * (reg & 1), h = reg >> 1;
    const int32_t a = sh.an[row][i0 + h];
    const int j = kWOffset + s0 - i0 - h + tig;
    // Products of pairs kk = tig, tig + 4 and tig + 8, tig + 12, biased by
    // 1024 each half: (t0 + 1024) + 65536 (t1 + 1024), both in [32, 2048].
    const uint32_t x01 = (uint32_t)(sh.w[row][j] * a + kBias);
    const uint32_t x23 = (uint32_t)(sh.w[row][j + 8] * a + kBias);
    lo[reg] = (x01 & 0x000f000fu) | ((x23 & 0x000f000fu) << 8);
    // (t + 1024) >> 4 in [2, 128] a byte; less 64 as int8: flip bits 6 and
    // 7, and bit 7 back where bit 6 was set.
    const uint32_t biased = ((x01 >> 4) & 0x00ff00ffu) | ((x23 << 4) & 0xff00ff00u);
    hi[reg] = biased ^ 0xc0c0c0c0u ^ ((biased << 1) & 0x80808080u);
  }
}

// Output limbs 8q + 2 tig + {0, 1} of rows n and n + 8 from the four
// accumulator tiles (C fragment order: row n col 2tig, 2tig + 1, row n + 8
// the same).
MXU_INLINE void combine(Shared& sh, int lane, int q, const int32_t acc[4][4]) {
  const int n = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n + 8 * (i >> 1), col = 8 * q + 2 * tig + (i & 1);
    // c = t_lo Me + 16 t_hi Me + 16 t_lo Mo + 256 t_hi Mo, in int32.
    sh.c[row][col] = acc[0][i] + 16 * acc[1][i] + 16 * acc[2][i] + 256 * acc[3][i];
  }
}

// ---------------------------------------------------------------------------
// Field operations.  `C` is the execution context: `lanes(f)` runs f(warp,
// lane) on every lane (then a warp barrier), `sync()` is a block barrier,
// `contract()` the tiles of the staged product, `sh()` the shared state.
// Row-local phases touch only the rows of their warp.
// ---------------------------------------------------------------------------

// `rounds` carry passes over slot `x`, in place: the reference's `_carry`
// (the floor shift makes negative limbs borrow; limb 31's carry folds onto
// limb 0 x 38).
template <class C>
MXU_CALL void fe_carry(C& ctx, int x, int rounds) {
  for (int round = 0; round < rounds; ++round) {
    ctx.lanes([&](int warp, int k) {
      Shared& sh = ctx.sh();
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = warp * kRowsPerWarp + i;
        sh.carry[row][k] = sh.fe[x][row][k] >> 8;
      }
    });
    ctx.lanes([&](int warp, int k) {
      Shared& sh = ctx.sh();
      const int32_t fold = k == 0 ? 38 : 1;
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = warp * kRowsPerWarp + i;
        sh.fe[x][row][k] = (sh.fe[x][row][k] & 0xff) + sh.carry[row][(k + 31) & 31] * fold;
      }
    });
  }
}

// dst = _carry(a + sign b, 1).
template <class C>
MXU_CALL void fe_addsub(C& ctx, int dst, int a, int b, int sign) {
  ctx.lanes([&](int warp, int k) {
    Shared& sh = ctx.sh();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      sh.fe[dst][row][k] = sh.fe[a][row][k] + sign * sh.fe[b][row][k];
    }
  });
  fe_carry(ctx, dst, 1);
}

template <class C>
MXU_INLINE void fe_add(C& ctx, int dst, int a, int b) {
  fe_addsub(ctx, dst, a, b, 1);
}

template <class C>
MXU_INLINE void fe_sub(C& ctx, int dst, int a, int b) {
  fe_addsub(ctx, dst, a, b, -1);
}

// dst = _mul_mxu(a, b): stage the nibbles, contract on the tensor cores,
// carry four rounds.  dst may be a or b.
template <class C>
MXU_CALL void fe_mul(C& ctx, int dst, int a, int b) {
  ctx.lanes([&](int warp, int k) {
    Shared& sh = ctx.sh();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      const int32_t av = sh.fe[a][row][k];
      sh.an[row][2 * k] = av & 15;
      sh.an[row][2 * k + 1] = av >> 4;
      // w[j] = bn[j] + 65536 bn[j + 4]: nibbles 2k, 2k + 1 and those of limb k + 2.
      const int32_t bv = sh.fe[b][row][k];
      const int32_t bu = k + 2 < kLimbs ? sh.fe[b][row][k + 2] : 0;
      sh.w[row][kWOffset + 2 * k] = (bv & 15) + 65536 * (bu & 15);
      sh.w[row][kWOffset + 2 * k + 1] = (bv >> 4) + 65536 * (bu >> 4);
      if (k < 2) {  // j = -4..-1: bn[j] = 0
        sh.w[row][kWOffset - 4 + 2 * k] = 65536 * (bv & 15);
        sh.w[row][kWOffset - 3 + 2 * k] = 65536 * (bv >> 4);
      }
    }
  });
  ctx.sync();
  ctx.contract();
  ctx.sync();
  ctx.lanes([&](int warp, int k) {
    Shared& sh = ctx.sh();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      sh.fe[dst][row][k] = sh.c[row][k];
    }
  });
  fe_carry(ctx, dst, 4);
}

// The zero borders of the packed b nibbles: j in [-16, -4) and [64, 84).
template <class C>
MXU_INLINE void clear_borders(C& ctx) {
  ctx.lanes([&](int warp, int k) {
    Shared& sh = ctx.sh();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      if (k < 12) sh.w[row][k] = 0;
      if (k < 20) sh.w[row][kWOffset + 64 + k] = 0;
    }
  });
}

// dst = z^(p - 2): the reference's `_inv`, squaring and multiplying over the
// bits of p - 2 below its leading one.  dst must differ from z.
template <class C>
MXU_CALL void fe_inv(C& ctx, int dst, int z) {
  ctx.lanes([&](int warp, int k) {
    Shared& sh = ctx.sh();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      sh.fe[dst][row][k] = sh.fe[z][row][k];
    }
  });
  for (int bit = 253; bit >= 0; --bit) {
    fe_mul(ctx, dst, dst, dst);
    if (inv_exp_bit(bit)) fe_mul(ctx, dst, dst, z);
  }
}

// Slot x to its canonical representative, the reference's `_freeze`: six
// carry rounds, then lane i of each warp takes row i of the warp through the
// sequential carries and the two conditional subtractions of p.
template <class C>
MXU_CALL void fe_freeze(C& ctx, int x) {
  fe_carry(ctx, x, 6);
  ctx.lanes([&](int warp, int k) {
    if (k >= kRowsPerWarp) return;
    int32_t* v = ctx.sh().fe[x][warp * kRowsPerWarp + k];
    for (int pass = 0; pass < 2; ++pass) {
      int32_t carry = 0;
      for (int i = 0; i < kLimbs; ++i) {
        const int32_t s = v[i] + carry;
        v[i] = s & 0xff;
        carry = s >> 8;
      }
      if (pass == 0) v[0] += 38 * carry;  // fold the top carry; the second is 0
    }
    for (int rep = 0; rep < 2; ++rep) {
      int32_t d[kLimbs];
      int32_t borrow = 0;
      for (int i = 0; i < kLimbs; ++i) {
        const int32_t s = v[i] - p_limb(i) - borrow;
        borrow = s < 0 ? 1 : 0;
        d[i] = s + (borrow << 8);
      }
      if (borrow == 0)
        for (int i = 0; i < kLimbs; ++i) v[i] = d[i];
    }
  });
}

// The reference's `_pt_double`: out = 2 p (slots of X, Y, Z, T; out may be p).
template <class C>
MXU_INLINE void pt_double(C& ctx, const int p[4], const int out[4]) {
  fe_mul(ctx, kT0, p[0], p[0]);  // a
  fe_mul(ctx, kT1, p[1], p[1]);  // b
  fe_mul(ctx, kT2, p[2], p[2]);  // zz
  fe_add(ctx, kT3, kT2, kT2);    // c
  fe_add(ctx, kT4, kT0, kT1);    // h
  fe_add(ctx, kT5, p[0], p[1]);  // xy
  fe_mul(ctx, kT5, kT5, kT5);
  fe_sub(ctx, kT6, kT4, kT5);    // e
  fe_sub(ctx, kT7, kT0, kT1);    // g
  fe_add(ctx, kT8, kT3, kT7);    // f
  fe_mul(ctx, out[0], kT6, kT8);
  fe_mul(ctx, out[1], kT7, kT4);
  fe_mul(ctx, out[2], kT8, kT7);
  fe_mul(ctx, out[3], kT6, kT4);
}

// The reference's `_pt_add`: out = p1 + p2 (out may be p1).
template <class C>
MXU_INLINE void pt_add(C& ctx, const int p1[4], const int p2[4], const int out[4]) {
  fe_sub(ctx, kT0, p1[1], p1[0]);
  fe_sub(ctx, kT1, p2[1], p2[0]);
  fe_mul(ctx, kT2, kT0, kT1);     // a
  fe_add(ctx, kT0, p1[1], p1[0]);
  fe_add(ctx, kT1, p2[1], p2[0]);
  fe_mul(ctx, kT3, kT0, kT1);     // b
  fe_mul(ctx, kT4, p1[3], p2[3]);
  fe_mul(ctx, kT4, kT4, kK2D);    // c
  fe_mul(ctx, kT5, p1[2], p2[2]); // zz
  fe_add(ctx, kT5, kT5, kT5);     // d
  fe_sub(ctx, kT6, kT3, kT2);     // e
  fe_sub(ctx, kT7, kT5, kT4);     // f
  fe_add(ctx, kT8, kT5, kT4);     // g
  fe_add(ctx, kT9, kT3, kT2);     // h
  fe_mul(ctx, out[0], kT6, kT7);
  fe_mul(ctx, out[1], kT8, kT9);
  fe_mul(ctx, out[2], kT7, kT8);
  fe_mul(ctx, out[3], kT6, kT9);
}

// The block's 16 signatures, rows first_row + [0, 16) of the wave (spare
// rows of a partial block run the last row).  `ok` gets each row's verdict.
template <class C>
MXU_INLINE void verify_block(C& ctx, const int32_t* ax, const int32_t* ay,
                             const int32_t* r_bytes, const int32_t* s_bits,
                             const int32_t* h_bits, long long rows, long long first_row,
                             uint8_t ok[kRowsPerWarp]) {
  auto src = [first_row, rows](int row) {
    const long long g = first_row + row;
    return g < rows ? g : rows - 1;
  };
  clear_borders(ctx);
  // Constants, -A = (-x, y, 1, -xy) and the identity as Q.
  ctx.lanes([&](int warp, int k) {
    Shared& sh = ctx.sh();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = warp * kRowsPerWarp + i;
      const long long g = src(row);
      sh.fe[kBX][row][k] = kBaseX[k];
      sh.fe[kBY][row][k] = base_y_limb(k);
      sh.fe[kBZ][row][k] = k == 0;
      sh.fe[kBT][row][k] = kBaseT[k];
      sh.fe[kK2D][row][k] = k2D[k];
      sh.fe[kMX][row][k] = 0 - ax[g * kLimbs + k];
      sh.fe[kMY][row][k] = ay[g * kLimbs + k];
      sh.fe[kMZ][row][k] = k == 0;
      sh.fe[kQX][row][k] = 0;
      sh.fe[kQY][row][k] = k == 0;
      sh.fe[kQZ][row][k] = k == 0;
      sh.fe[kQT][row][k] = 0;
    }
  });
  fe_carry(ctx, kMX, 1);  // _sub(0, ax)
  fe_mul(ctx, kMT, kMX, kMY);
  const int base[4] = {kBX, kBY, kBZ, kBT};
  const int neg_a[4] = {kMX, kMY, kMZ, kMT};
  const int b_neg_a[4] = {kNX, kNY, kNZ, kNT};
  const int q[4] = {kQX, kQY, kQZ, kQT};
  const int addend[4] = {kDX, kDY, kDZ, kDT};
  pt_add(ctx, base, neg_a, b_neg_a);

  for (int bit = 255; bit >= 0; --bit) {
    pt_double(ctx, q, q);
    // The reference's `_pt_select` on s + 2h in wrapping int32.
    ctx.lanes([&](int warp, int k) {
      Shared& sh = ctx.sh();
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = warp * kRowsPerWarp + i;
        const long long g = src(row);
        const int32_t pick = (int32_t)((uint32_t)s_bits[g * 256 + bit] +
                                       2u * (uint32_t)h_bits[g * 256 + bit]);
        for (int c = 0; c < 4; ++c) {
          int32_t v = c == 1 || c == 2 ? (k == 0) : 0;  // the identity (0, 1, 1, 0)
          if (pick == 1) v = sh.fe[base[c]][row][k];
          if (pick == 2) v = sh.fe[neg_a[c]][row][k];
          if (pick == 3) v = sh.fe[b_neg_a[c]][row][k];
          sh.fe[addend[c]][row][k] = v;
        }
      }
    });
    pt_add(ctx, q, addend, q);
  }

  // Compress Q: y / Z with the low bit of x / Z in bit 255, against R.
  fe_inv(ctx, kT10, kQZ);
  fe_mul(ctx, kT11, kQX, kT10);
  fe_mul(ctx, kT10, kQY, kT10);
  fe_freeze(ctx, kT11);
  fe_freeze(ctx, kT10);
  ctx.lanes([&](int warp, int k) {
    if (k >= kRowsPerWarp) return;
    Shared& sh = ctx.sh();
    const int row = warp * kRowsPerWarp + k;
    const int32_t* x = sh.fe[kT11][row];
    const int32_t* y = sh.fe[kT10][row];
    const int32_t* r = r_bytes + src(row) * kLimbs;
    bool same = true;
    for (int i = 0; i < kLimbs; ++i)
      same = same && (i == kLimbs - 1 ? y[i] + ((x[0] & 1) << 7) : y[i]) == r[i];
    ok[k] = same ? 1 : 0;
  });
}

#ifndef __CUDACC__
// ---------------------------------------------------------------------------
// The host build: every lane of every warp in turn.
// ---------------------------------------------------------------------------

// D += A B for one warp's m16n8k32 s8 MMA, from the 32 lanes' fragments by
// the PTX ISA's layouts: A register i, byte b of lane (n, tig) is row
// n + 8 (i & 1), column 4 tig + b + 16 (i >> 1); B register i, byte b is row
// 4 tig + b + 16 i, column n; D element i is row n + 8 (i >> 1), column
// 2 tig + (i & 1).  The sums skip the rows of B that are zero.
inline void mma_host(int32_t d[32][4], const uint32_t a[32][4], const uint32_t b[32][2]) {
  auto a_at = [a](int row, int col) {  // A[row][col] from its lane's fragment
    const int lane = 4 * (row & 7) + ((col & 15) >> 2), reg = (row >> 3) + 2 * (col >> 4);
    return (int32_t)(int8_t)(a[lane][reg] >> (8 * (col & 3)));
  };
  int8_t bm[32][8];
  for (int lane = 0; lane < 32; ++lane) {
    const int n = lane >> 2, tig = lane & 3;
    for (int i = 0; i < 2; ++i)
      for (int byte = 0; byte < 4; ++byte)
        bm[4 * tig + byte + 16 * i][n] = (int8_t)(b[lane][i] >> (8 * byte));
  }
  int nonzero[8][32], count[8] = {};
  for (int kk = 0; kk < 32; ++kk)
    for (int col = 0; col < 8; ++col)
      if (bm[kk][col]) nonzero[col][count[col]++] = kk;
  for (int lane = 0; lane < 32; ++lane) {
    const int n = lane >> 2, tig = lane & 3;
    for (int i = 0; i < 4; ++i) {
      const int row = n + 8 * (i >> 1), col = 2 * tig + (i & 1);
      int32_t sum = 0;
      for (int e = 0; e < count[col]; ++e)
        sum += a_at(row, nonzero[col][e]) * bm[nonzero[col][e]][col];
      d[lane][i] += sum;
    }
  }
}

struct HostCtx {
  std::unique_ptr<Shared> state{new Shared()};
  Shared& sh() { return *state; }
  template <class F>
  void lanes(F f) {
    for (int warp = 0; warp < kWarps; ++warp)
      for (int lane = 0; lane < 32; ++lane) f(warp, lane);
  }
  void sync() {}
  void contract() {
    for (int q = 0; q < kWarps; ++q) {
      uint32_t b[4][32][2];  // Me x 1, Me x 38, Mo x 1, Mo x 38
      for (int lane = 0; lane < 32; ++lane)
        for (int f = 0; f < 4; ++f)
          b[f][lane][0] = b[f][lane][1] = b_fragment(lane, f >> 1, f & 1 ? 38 : 1);
      int32_t acc[4][32][4] = {};
      for (int t = 0; t < kTilesPerWarp; ++t) {
        int s0, i0;
        tile_of(q, t, s0, i0);
        uint32_t lo[32][4], hi[32][4];
        for (int lane = 0; lane < 32; ++lane) a_fragments(sh(), lane, s0, i0, lo[lane], hi[lane]);
        const int wide = s0 >= 64 ? 1 : 0;
        mma_host(acc[0], lo, b[wide]);
        mma_host(acc[1], hi, b[wide]);
        mma_host(acc[2], lo, b[2 + wide]);
        mma_host(acc[3], hi, b[2 + wide]);
      }
      for (int lane = 0; lane < 32; ++lane) {
        int32_t mine[4][4];
        for (int f = 0; f < 4; ++f)
          for (int i = 0; i < 4; ++i) mine[f][i] = acc[f][lane][i];
        combine(sh(), lane, q, mine);
      }
    }
  }
};

// Rows of x into slot `slot` of a 16-row group (spare rows repeat the last).
inline void load_group(HostCtx& ctx, int slot, const int32_t* x, long long rows, long long first) {
  for (int row = 0; row < kRows; ++row) {
    const long long g = first + row < rows ? first + row : rows - 1;
    std::memcpy(ctx.sh().fe[slot][row], x + g * kLimbs, sizeof(int32_t) * kLimbs);
  }
}

inline void store_group(HostCtx& ctx, int slot, int32_t* out, long long rows, long long first) {
  for (int row = 0; row < kRows && first + row < rows; ++row)
    std::memcpy(out + (first + row) * kLimbs, ctx.sh().fe[slot][row], sizeof(int32_t) * kLimbs);
}

// out = _mul_mxu(a, b) for `rows` rows of 32 limbs, by the kernel's multiply.
inline void mul_host(const int32_t* a, const int32_t* b, int32_t* out, long long rows) {
  HostCtx ctx;
  clear_borders(ctx);
  for (long long first = 0; first < rows; first += kRows) {
    load_group(ctx, kT0, a, rows, first);
    load_group(ctx, kT1, b, rows, first);
    fe_mul(ctx, kT2, kT0, kT1);
    store_group(ctx, kT2, out, rows, first);
  }
}

// out = _inv(z) with the kernel's multiply.
inline void inv_host(const int32_t* z, int32_t* out, long long rows) {
  HostCtx ctx;
  clear_borders(ctx);
  for (long long first = 0; first < rows; first += kRows) {
    load_group(ctx, kT0, z, rows, first);
    fe_inv(ctx, kT1, kT0);
    store_group(ctx, kT1, out, rows, first);
  }
}
#endif  // !__CUDACC__

}  // namespace mxu

#ifdef __CUDACC__

namespace {

__device__ __forceinline__ void mma_s8(int32_t d[4], const uint32_t a[4], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(b));
}

// This thread's lane of the block.
struct DevCtx {
  int warp, lane;
  uint32_t b[4];  // B fragments: Me x 1, Me x 38, Mo x 1, Mo x 38
  __device__ __forceinline__ mxu::Shared& sh() {
    extern __shared__ __align__(16) unsigned char mxu_smem[];
    return *reinterpret_cast<mxu::Shared*>(mxu_smem);
  }
  template <class F>
  __device__ __forceinline__ void lanes(F f) {
    f(warp, lane);
    __syncwarp();
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  // Warp q's 40 tiles: output limbs [8q, 8q + 8) of the staged product.
  __device__ __noinline__ void contract() {
    int32_t acc[4][4] = {};
    mxu::Shared& s = sh();
#pragma unroll 1
    for (int t = 0; t < mxu::kTilesPerWarp; ++t) {
      int s0, i0;
      mxu::tile_of(warp, t, s0, i0);
      uint32_t lo[4], hi[4];
      mxu::a_fragments(s, lane, s0, i0, lo, hi);
      const bool wide = s0 >= 64;  // weight 38: selects, not an indexed array
      const uint32_t be = wide ? b[1] : b[0], bo = wide ? b[3] : b[2];
      mma_s8(acc[0], lo, be);
      mma_s8(acc[1], hi, be);
      mma_s8(acc[2], lo, bo);
      mma_s8(acc[3], hi, bo);
    }
    mxu::combine(s, lane, warp, acc);
  }
};

__global__ void __launch_bounds__(mxu::kThreads)
ed25519_verify_mxu_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                          const int32_t* __restrict__ r_bytes,
                          const int32_t* __restrict__ s_bits,
                          const int32_t* __restrict__ h_bits, long long rows,
                          uint8_t* __restrict__ out) {
  DevCtx ctx;
  ctx.warp = threadIdx.x / 32;
  ctx.lane = threadIdx.x % 32;
  for (int f = 0; f < 4; ++f) ctx.b[f] = mxu::b_fragment(ctx.lane, f >> 1, f & 1 ? 38 : 1);
  const long long first = (long long)blockIdx.x * mxu::kRows;
  uint8_t ok[mxu::kRowsPerWarp];
  mxu::verify_block(ctx, ax, ay, r_bytes, s_bits, h_bits, rows, first, ok);
  if (ctx.lane < mxu::kRowsPerWarp) {
    const long long row = first + ctx.warp * mxu::kRowsPerWarp + ctx.lane;
    if (row < rows) out[row] = ok[ctx.lane];
  }
}

}  // namespace

extern "C" int mirbft_ed25519_verify_mxu(const void* ax, const void* ay, const void* r_bytes,
                                         const void* s_bits, const void* h_bits,
                                         long long rows, void* out, void* stream) {
  const int bytes = (int)sizeof(mxu::Shared);
  cudaError_t err = cudaFuncSetAttribute(ed25519_verify_mxu_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + mxu::kRows - 1) / mxu::kRows);
  ed25519_verify_mxu_kernel<<<grid, mxu::kThreads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)r_bytes,
      (const int32_t*)s_bits, (const int32_t*)h_bits, rows, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
