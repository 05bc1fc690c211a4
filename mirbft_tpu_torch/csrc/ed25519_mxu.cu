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
// every step, branch free, so the rows of a group move in lockstep.
//
// The multiply (`_mul_mxu`): each limb splits into 4-bit nibbles, a & 15 in
// [0, 15] and a >> 4 in [-32, 31], 64 of them; the 4,096 nibble products
// t = an[i] bn[j] in [-992, 1024] split again into t & 15 and t >> 4; and the
// product is the contraction
//   c = t_lo Me + 16 t_hi Me + 16 t_lo Mo + 256 t_hi Mo
// with the reference's fold matrices Me, Mo [4096, 32] (entry 1 or 38 at
// column ((i + j) mod 64) / 2 for even, resp. odd, i + j; 38 = 2^256 mod p
// where i + j >= 64), then `_carry(c, 4)`.  The tensor cores multiply int8 A
// by uint8 B into int32 accumulators (mma.sync.m16n8k32.s32.s8.u8.s32):
// every partial sum is an exact integer.  B holds the two digits of each
// product as 16 (t & 15) in [0, 240] and (t >> 4) + 63 in [1, 127], so the
// contraction of 16 t_lo is shifted back by 4 bits, and the 63's, a known
// sum of the fold's weights for each output limb, are subtracted in int32
// (`bias_of`); the weights 16 and 256 are applied there too (16 x 38 = 608
// is no int8).
//
// The contraction, transposed: the fold is the A operand and the nibble
// products are B.  A group of 8 signatures is the MMA's N (B's column n is
// signature n).  Output position p = (i + j) mod 64 feeds limb p / 2 of Me
// (p even) or Mo (p odd), so the 16 positions [16q, 16q + 16) are one M tile:
// A's row r < 8 is Me's limb 8q + r, row 8 + r Mo's.  Every pair (i, j)
// feeds one position, so K is cut along anti-diagonals with wrap-around: tile
// u of M tile q holds, for h in {0, 1} and 16 positions p = 16q + kk, the
// pair i = i0 + h, j = (p - i) mod 64, i0 = (16q + 2u) mod 64, weight 38
// exactly when i > p.  The 32 tiles of an M tile cover its 1,024 pairs once,
// none padded.  Lane (n, tig) holds the pairs kk = tig + {0, 8, 4, 12} of
// h = 0 (K = 4 tig + b) and kk = (tig + 1) mod 4 + {0, 8, 4, 12} of h = 1
// (K = 16 + 4 tig + b), so its four A registers are distinct: each has a
// weight where the byte's pair feeds the register's row.  Tiles u >= 8 have
// one weight throughout (38 while 16q + 2u < 64, else 1), so their A
// registers are constants of the lane; the eight tiles u < 8 mix the two,
// and a lane selects each register by one compare of its row with u.  A
// multiply is 4 x 32 tiles, each two MMAs (the two digits), for 8
// signatures.
//
// The B registers: lane (n, tig) makes the products of signature n alone.
// The a nibbles are staged times 16 and the b nibbles packed two a word,
// w[j] = bn[j] + 65536 bn[(j + 4) mod 64], so one IMAD gives two products
// already placed: y = w (16 a) + 16 (1008 + 65536 x 1008) = 16 ((t0 + 1008)
// + 65536 (t1 + 1008)), both t + 1008 in [16, 2032], so bytes 0 and 2 of y
// are 16 (t & 15) (their low nibble is bits 12-15 of t + 1008: 0) and bytes 1
// and 3 are (t >> 4) + 63.  One byte permute (PRMT) of two such words is a
// B register.  Per tile a lane loads a pair of a nibbles (shared by its four
// lanes) and four packed words, and issues 4 IMADs and 4 permutes for its 8
// products, then the two MMAs; the tiles are unrolled with compile-time
// offsets (the wrap of j is folded into a copy of w's last 16 words before
// w[0]) and alternate between two sets of accumulators.
//
// Layout: one block of eight warps for a group of 8 signatures.  Warp s owns
// signature s: lane k holds limb k, a carry round is one shift, one
// `__shfl_sync` from lane k - 1 and one multiply-add (x 38 onto limb 0), and
// the signature's field elements rest in row s of the group's slots in
// shared memory.  The point formulas' independent multiplies go in batches
// of up to four (a ladder step's 17 in six: 3 + 1 + 4 and 4 + 1 + 4; their
// adds and subs in six too).  A batch: each warp stages its signature's
// nibbles of every operand pair, a block barrier, warp w contracts half
// w / 4 (16 tiles) of M tile w % 4 of every multiply into its half's product
// buffer, a block barrier, each warp sums its signature's two halves, takes
// off the bias and carries four rounds.  So a ladder step has 12 block
// barriers for its 17 multiplies, the inversion 2 a multiply: 4,094 for a
// verification's 4,870.  Adds and subs touch only the warp's own row and
// need none.  The picks of the 256 steps are read once, in the set-up.  The
// block takes ~63 KB of shared memory and 256 threads of at most 128
// registers, so two blocks share an SM.  A partial last group runs its spare
// rows on the last row and stores nothing from them.
//
// What bounds it: one verification is 4,870 field multiplies (1 for -A's T,
// 9 for B - A, 256 x (8 + 9) in the ladder, 506 in the inversion, 2 for x and
// y).  `chip_smoke.mxu_bound` counts the function's work: each multiply's
// 4,096 nibble products and their two 4-bit halves a row, ~12,288 integer
// operations at the INT32 rate (132 SMs x 64 lanes), against 131,072 int8
// multiply-adds at the dense int8 rate: ~3.7 ms for 1,024 rows.  That count
// is above this design's: a lane's 4 IMADs (FMA pipe) and 4 permutes (ALU
// pipe) make its 8 products a tile, one operation a product over two pipes.
// This design's own floor (`chip_smoke.mxu_design_floor`) is the issue of
// its MMAs: a group's multiply is 256 m16n8k32 on its SM's four
// sub-partitions, each holding its sub-partition's issue ~6 cycles (the
// `mma` probe of csrc/latency_probe.cu), ~400 cycles a multiply, ~1 ms a
// launch of up to 1,056 rows (one group an SM).  The kernel runs ~5x that.
// Its tiles alone run at that issue, their integer work hidden under the
// MMAs (the `tile` probe times the kernel's own `tile_block`); the
// contraction phase around them takes ~3x their issue, and the staging,
// two barriers and carries of each batch come on top.  Up to 1,056 rows
// (132 groups) a launch lasts one group's chain of multiplies; beyond, two
// groups share an SM.
//
// Not wgmma: a warpgroup MMA takes 64 rows of A, four M tiles, while a K
// tile's pairs feed one M tile, so three quarters of its work would be
// zeros on top of the fold's own sparsity, and its B comes from shared
// memory, so every nibble product would take a store and a load there.
// mma.sync keeps B in registers, as the lanes make it.
//
// The constants, the staged layout, the registers and the K tile are in
// csrc/ed25519_mxu_tile.cuh, which csrc/latency_probe.cu's `tile` probe runs
// too.  Outside `__CUDACC__` both files are plain C++: a register is `Lanes<T>`, its
// 32 lanes' values; every statement runs on all 32 lanes before the next
// (the warp in lockstep), `shfl` permutes lanes, `mma` forms each mma.sync
// from the 32 lanes' fragments by the PTX ISA's m16n8k32 layouts, and
// `HostCtx` runs each warp's part of a phase in turn between two barriers.
// So the host build (g++, in the tests) runs the kernel's own staging, tiles,
// fragments, combine, carries, point formulas and inversion against the
// reference limb for limb.
//
// Plain C interface for ctypes: the launcher takes device pointers, the row
// count and a cudaStream_t, launches on that stream without synchronising or
// allocating, and returns the first CUDA error (setting the shared-memory
// size, or the launch).

#include "ed25519_mxu_tile.cuh"

namespace mxu {

// Slots of the group's field elements: row s of a slot is signature s's.
enum Slot : int {
  kQX, kQY, kQZ, kQT,  // the ladder's accumulator Q
  kT0, kT1, kT2, kT3, kT4, kT5,
  // The table, in the order the step's pick s + 2h indexes it.
  kIX, kIY, kIZ, kIT,  // the identity (0, 1, 1, 0)
  kBX, kBY, kBZ, kBT,  // the base point B
  kMX, kMY, kMZ, kMT,  // -A
  kNX, kNY, kNZ, kNT,  // B - A
  kK2D,                // 2d
  kSlots,
  kAddend = kSlots     // + c: coordinate c of the entry the step picks
};

struct Shared {
  int32_t fe[kSlots][kSigs][kLimbs];
  Staged staged[kBatch];
  int32_t product[kBatch][kHalves][kSigs * kRow];  // each half's share of a product
  int32_t picks[256][kSigs];                       // table entry (0-3) of bit b, signature s
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

MXU_INLINE int32_t p_limb(int k) { return k == 0 ? 0xed : (k == 31 ? 0x7f : 0xff); }
// Bit i of p - 2 = 2^255 - 21, for i < 255 (its low byte is 0xeb).
MXU_INLINE int inv_exp_bit(int i) { return i >= 8 ? 1 : (0xeb >> i) & 1; }

// ---------------------------------------------------------------------------
// The contraction: half `half` of M tile q's 32 K tiles (`tile_block` and
// the eight mixed tiles of ed25519_mxu_tile.cuh), from the staged nibbles
// into limbs [8q, 8q + 8) of that half's product buffer (row s signature
// s's, `kRow` words apart).
// ---------------------------------------------------------------------------

MXU_INLINE void contract(const Staged& st, const LaneConsts& c, int q, int half,
                         int32_t* product) {
  const I32 &g = c.g, &tig = c.tig, &arow = c.arow, &wrow = c.wrow, &wrow1 = c.wrow1;
  const U32 *one = c.one, *wide = c.wide;
  I32 lo[2][4], hi[2][4];
  for (int set = 0; set < 2; ++set)
    for (int r = 0; r < 4; ++r) lo[set][r] = hi[set][r] = 0;
  if (half == 0) {
    // Tiles u < 8, i0 = 16q + 2u: the weight turns from 38 to 1 inside.
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const Pred below = g < u, upto = g <= u;
      const U32 a_frag[4] = {sel(below, wide[0], one[0]), sel(below, wide[1], one[1]),
                             sel(upto, wide[2], one[2]), sel(below, wide[3], one[3])};
      tile(&st.an[0][0], &st.w[0][0], arow + (16 * q + 2 * u), wrow - 2 * u, wrow1 - 2 * u,
           a_frag, lo[u & 1], hi[u & 1]);
    }
    tile_block(st, q, 1, arow, wrow, wrow1, one, wide, lo, hi);
  } else {
    tile_block(st, q, 2, arow, wrow, wrow1, one, wide, lo, hi);
    tile_block(st, q, 3, arow, wrow, wrow1, one, wide, lo, hi);
  }
  // Limb 8q + g of signatures 2 tig + e: c = t_lo Me + 16 t_hi Me +
  // 16 t_lo Mo + 256 t_hi Mo (rows g and g + 8 of the accumulators), less
  // the bias terms 63 (16 Me + 256 Mo) that `bias_of` adds up.
  for (int e = 0; e < 2; ++e) {
    const I32 me = ((lo[0][e] + lo[1][e]) >> 4) + (hi[0][e] + hi[1][e]) * 16;
    const I32 mo = lo[0][2 + e] + lo[1][2 + e] + (hi[0][2 + e] + hi[1][2 + e]) * 256;
    sts(product, (tig * 2 + e) * kRow + g + 8 * q, me + mo);
  }
}

// ---------------------------------------------------------------------------
// Field operations.  Warp s of a group owns signature s: lane k holds limb k
// of its elements, which rest in row s of the group's slots.  `C` is the
// execution context: `warps(f)` and `units(f)` run f(s) for this warp's s
// (on the host, for every warp in turn; `warps` is the signatures' work,
// `units` the contraction's), `sync()` is the block barrier, `sh()` the
// shared memory, `bit` the ladder step's.  Everything between two barriers
// touches the warp's own rows, or shared state no warp writes then.
// ---------------------------------------------------------------------------

// Row s of a slot, or of the table entry signature s picks at the step's bit
// (slot kAddend + c: coordinate c of the identity, B, -A or B - A).
template <class C>
MXU_INLINE int32_t* row_of(C& ctx, int slot, int s) {
  if (slot >= kAddend) slot = kIX + 4 * ctx.sh().picks[ctx.bit][s] + (slot - kAddend);
  return ctx.sh().fe[slot][s];
}

// `rounds` passes of the reference's `_carry` over N elements, in turn (the
// floor shift makes negative limbs borrow; limb 31's carry folds onto limb
// 0 x 38).
template <int N>
MXU_INLINE void fe_carry_n(I32 x[N], int rounds) {
  const I32 lane = lane_id();
  const I32 prev = (lane + 31) & 31;
  const I32 fold = sel(Pred(lane == 0), I32(38), I32(1));
  for (int round = 0; round < rounds; ++round)
    for (int i = 0; i < N; ++i) x[i] = (x[i] & 0xff) + shfl(x[i] >> 8, prev) * fold;
}

MXU_INLINE void fe_carry(I32& x, int rounds) { fe_carry_n<1>(&x, rounds); }

// One add (sign 1) or sub (-1) of a batch: dst, a, b as a byte each.
MXU_INLINE int add_op(int dst, int a, int b, int sign) {
  return dst | (a << 8) | (b << 16) | (sign < 0 ? 1 << 24 : 0);
}

// dst_i = _carry(a_i + sign_i b_i, 1) for the N <= 4 independent adds and
// subs ops[i], their carries in turn.  A destination may be an operand of
// the batch.
template <int N, class C>
MXU_CALL void fe_addsub_n(C& ctx, int op0, int op1, int op2, int op3) {
  const int ops[kBatch] = {op0, op1, op2, op3};
  ctx.warps([&](int s) {
    const I32 lane = lane_id();
    I32 sums[N];
    for (int i = 0; i < N; ++i) {
      const I32 a = lds(row_of(ctx, (ops[i] >> 8) & 0xff, s), lane);
      const I32 b = lds(row_of(ctx, (ops[i] >> 16) & 0xff, s), lane);
      sums[i] = ops[i] >> 24 ? a - b : a + b;
    }
    fe_carry_n<N>(sums, 1);
    for (int i = 0; i < N; ++i) sts(row_of(ctx, ops[i] & 0xff, s), lane, sums[i]);
  });
}

// The bias terms of limb k of a product, 63 (16 S(2k) + 256 S(2k + 1)):
// S(p) = (p + 1) + 38 (63 - p) is the sum of the fold's weights at output
// position p (p + 1 pairs i + j = p, 63 - p pairs i + j = p + 64), each of
// whose (t >> 4) + 63 carries the 63.
MXU_INLINE I32 bias_of(const I32& k) { return (I32(40123) - k * 1258) * 1008; }

// One multiply of a batch: dst, a, b as a byte each.
MXU_INLINE int op(int dst, int a, int b) { return dst | (a << 8) | (b << 16); }

// The contraction of the n staged multiplies: warp w runs half w / 4 of M
// tile w % 4 of each.
template <class C>
MXU_CALL void contract_batch(C& ctx, int n) {
  ctx.units([&](int w) {
    const int q = w % kTiles, half = w / kTiles;
    const LaneConsts c = lane_constants();
    for (int i = 0; i < n; ++i)
      contract(ctx.sh().staged[i], c, q, half, ctx.sh().product[i][half]);
  });
}

// dst_i = _mul_mxu(a_i, b_i) for the N <= 4 independent multiplies ops[i]:
// every warp stages its signature's nibbles of each, a block barrier, the
// contraction, a block barrier, each warp sums its signature's two halves
// of each product, takes off the bias and carries four rounds.  A
// destination may be an operand of the batch.
template <int N, class C>
MXU_CALL void fe_mul_n(C& ctx, int op0, int op1, int op2, int op3) {
  const int ops[kBatch] = {op0, op1, op2, op3};
  ctx.warps([&](int s) {
    const I32 lane = lane_id();
    I32 a[N], b[N];
    for (int i = 0; i < N; ++i) {
      a[i] = lds(row_of(ctx, (ops[i] >> 8) & 0xff, s), lane);
      b[i] = lds(row_of(ctx, ops[i] >> 16, s), lane);
    }
    for (int i = 0; i < N; ++i) {
      Staged& st = ctx.sh().staged[i];
      // a nibbles 2k, 2k + 1: a & 15 and a >> 4 of limb k, times 16 (see
      // `tile`).
      const I32 an[2] = {(a[i] & 15) * 16, (a[i] >> 4) * 16};
      sts2(&st.an[s][0], lane * 2, an);
      // Packed b nibbles w[j] = bn[j] + 65536 bn[j + 4], j = 2k, 2k + 1: the
      // nibbles of limbs k and k + 2 (mod 32); w[48, 64) again at w[-16, 0).
      const I32 u = shfl(b[i], (lane + 2) & 31);
      const I32 w[2] = {(b[i] & 15) + (u & 15) * 65536, (b[i] >> 4) + (u >> 4) * 65536};
      sts2(&st.w[s][kWOffset], lane * 2, w);
      sts2_if(Pred(lane >= 24), &st.w[s][kWOffset], lane * 2 - 64, w);
    }
  });
  ctx.sync();
  contract_batch(ctx, N);
  ctx.sync();
  ctx.warps([&](int s) {
    const I32 lane = lane_id(), at = lane + s * kRow, bias = bias_of(lane);
    I32 x[N];
    for (int i = 0; i < N; ++i)
      x[i] = lds(ctx.sh().product[i][0], at) + lds(ctx.sh().product[i][1], at) - bias;
    fe_carry_n<N>(x, 4);
    for (int i = 0; i < N; ++i) sts(row_of(ctx, ops[i] & 0xff, s), lane, x[i]);
  });
}

template <class C>
MXU_INLINE void fe_mul(C& ctx, int dst, int a, int b) {
  fe_mul_n<1>(ctx, op(dst, a, b), 0, 0, 0);
}

// dst = z.
template <class C>
MXU_CALL void fe_copy(C& ctx, int dst, int z) {
  ctx.warps([&](int s) {
    const I32 lane = lane_id();
    sts(row_of(ctx, dst, s), lane, lds(row_of(ctx, z, s), lane));
  });
}

// dst = z^(p - 2): the reference's `_inv`, squaring and multiplying over the
// bits of p - 2 below its leading one.  dst must differ from z.
template <class C>
MXU_CALL void fe_inv(C& ctx, int dst, int z) {
  fe_copy(ctx, dst, z);
  for (int bit = 253; bit >= 0; --bit) {
    fe_mul(ctx, dst, dst, dst);
    if (inv_exp_bit(bit)) fe_mul(ctx, dst, dst, z);
  }
}

// Row `e`'s canonical representative into v (in every lane), the reference's
// `_freeze`: six carry rounds (lane k limb k), then the sequential carries
// and the two conditional subtractions of p on all 32 limbs.
MXU_INLINE void fe_freeze(int32_t* e, I32 v[kLimbs]) {
  const I32 lane = lane_id();
  I32 x = lds(e, lane);
  fe_carry(x, 6);
  sts(e, lane, x);
  warp_sync();
  for (int i = 0; i < kLimbs; ++i) v[i] = lds(e, I32(i));
  for (int pass = 0; pass < 2; ++pass) {
    I32 carry = 0;
    for (int i = 0; i < kLimbs; ++i) {
      const I32 t = v[i] + carry;
      v[i] = t & 0xff;
      carry = t >> 8;
    }
    if (pass == 0) v[0] = v[0] + carry * 38;  // fold the top carry; the second is 0
  }
  for (int rep = 0; rep < 2; ++rep) {
    I32 d[kLimbs];
    I32 borrow = 0;
    for (int i = 0; i < kLimbs; ++i) {
      const I32 t = v[i] - p_limb(i) - borrow;
      borrow = sel(Pred(t < 0), I32(1), I32(0));
      d[i] = t + borrow * 256;
    }
    for (int i = 0; i < kLimbs; ++i) v[i] = sel(Pred(borrow == 0), d[i], v[i]);
  }
}

// The reference's `_pt_double`: out = 2 p (slots of X, Y, Z, T; out may be
// p).  Its 8 multiplies in three batches, its adds and subs in three.
template <class C>
MXU_INLINE void pt_double(C& ctx, const int p[4], const int out[4]) {
  fe_mul_n<3>(ctx, op(kT0, p[0], p[0]), op(kT1, p[1], p[1]), op(kT2, p[2], p[2]), 0);  // a, b, zz
  fe_addsub_n<3>(ctx, add_op(kT2, kT2, kT2, 1), add_op(kT3, kT0, kT1, 1),  // c, h
                 add_op(kT4, p[0], p[1], 1), 0);                           // xy
  fe_mul(ctx, kT4, kT4, kT4);
  fe_addsub_n<2>(ctx, add_op(kT4, kT3, kT4, -1), add_op(kT0, kT0, kT1, -1), 0, 0);  // e, g
  fe_addsub_n<1>(ctx, add_op(kT1, kT2, kT0, 1), 0, 0, 0);                          // f
  fe_mul_n<4>(ctx, op(out[0], kT4, kT1), op(out[1], kT0, kT3),  // e f, g h
              op(out[2], kT1, kT0), op(out[3], kT4, kT3));        // f g, e h
}

// The reference's `_pt_add`: out = p1 + p2 (out may be p1).  Its 9
// multiplies in three batches, its adds and subs in three.
template <class C>
MXU_INLINE void pt_add(C& ctx, const int p1[4], const int p2[4], const int out[4]) {
  fe_addsub_n<4>(ctx, add_op(kT0, p1[1], p1[0], -1), add_op(kT1, p2[1], p2[0], -1),
                 add_op(kT2, p1[1], p1[0], 1), add_op(kT3, p2[1], p2[0], 1));
  fe_mul_n<4>(ctx, op(kT0, kT0, kT1), op(kT1, kT2, kT3),            // a, b
              op(kT2, p1[3], p2[3]), op(kT3, p1[2], p2[2]));           // t1 t2, zz
  fe_mul(ctx, kT2, kT2, kK2D);   // c
  fe_addsub_n<3>(ctx, add_op(kT3, kT3, kT3, 1), add_op(kT5, kT1, kT0, 1),  // d, h
                 add_op(kT0, kT1, kT0, -1), 0);                            // e
  fe_addsub_n<2>(ctx, add_op(kT4, kT3, kT2, -1), add_op(kT2, kT3, kT2, 1), 0, 0);  // f, g
  fe_mul_n<4>(ctx, op(out[0], kT0, kT4), op(out[1], kT2, kT5),  // e f, g h
              op(out[2], kT4, kT2), op(out[3], kT0, kT5));        // f g, e h
}

// Row of the wave that signature s of the group runs (spare signatures of a
// partial last group run the last row).
MXU_INLINE long long group_row(int s, long long first, long long rows) {
  return first + s < rows ? first + s : rows - 1;
}

// The table (the identity, B, 2d, -A = (-x, y, 1, -xy) and B - A) and the
// picks of every step: each warp its signature's rows.
template <class C>
MXU_CALL void setup(C& ctx, const int32_t* ax, const int32_t* ay, const int32_t* s_bits,
                    const int32_t* h_bits, long long rows, long long first) {
  ctx.warps([&](int s) {
    const I32 k = lane_id(), zero = 0, one = sel(Pred(k == 0), I32(1), zero);
    const long long g = group_row(s, first, rows);
    auto put = [&](int slot, const I32& x) { sts(ctx.sh().fe[slot][s], k, x); };
    put(kIX, zero);
    put(kIY, one);
    put(kIZ, one);
    put(kIT, zero);
    put(kBX, table_at(kBaseX, k));
    put(kBY, sel(Pred(k == 0), I32(0x58), I32(0x66)));
    put(kBZ, one);
    put(kBT, table_at(kBaseT, k));
    put(kK2D, table_at(k2D, k));
    I32 mx = zero - ldg(ax, I64(g * kLimbs) + s64(k));
    fe_carry(mx, 1);  // _sub(0, ax)
    put(kMX, mx);
    put(kMY, ldg(ay, I64(g * kLimbs) + s64(k)));
    put(kMZ, one);
    // The reference's `_pt_select` index s + 2h in wrapping int32, kept
    // where it is 1, 2 or 3 (B, -A, B - A) and 0 (the identity) for
    // anything else; lane l takes bits l + 32t.
    for (int t = 0; t < 8; ++t) {
      const I32 bit = k + 32 * t;
      const I64 at = I64(g * 256) + s64(bit);
      const I32 pick = s32(u32(ldg(s_bits, at)) + u32(ldg(h_bits, at)) * 2u);
      sts(&ctx.sh().picks[0][s], bit * kSigs, sel(Pred(pick >= 1 && pick <= 3), pick, zero));
    }
  });
  fe_mul(ctx, kMT, kMX, kMY);
  const int base[4] = {kBX, kBY, kBZ, kBT};
  const int neg_a[4] = {kMX, kMY, kMZ, kMT};
  const int b_neg_a[4] = {kNX, kNY, kNZ, kNT};
  pt_add(ctx, base, neg_a, b_neg_a);
}

// One ladder step at `bit`: Q = 2Q, then Q += the table entry s + 2h picks.
template <class C>
MXU_CALL void ladder_step(C& ctx, int bit) {
  const int q[4] = {kQX, kQY, kQZ, kQT};
  const int addend[4] = {kAddend, kAddend + 1, kAddend + 2, kAddend + 3};
  pt_double(ctx, q, q);
  ctx.bit = bit;
  pt_add(ctx, q, addend, q);
}

// The group's 8 signatures, rows first + [0, 8) of the wave: f(s, ok) with
// signature s's verdict in every lane of warp s.
template <class C, class F>
MXU_INLINE void verify_group(C& ctx, const int32_t* ax, const int32_t* ay,
                             const int32_t* r_bytes, const int32_t* s_bits,
                             const int32_t* h_bits, long long rows, long long first, F f) {
  setup(ctx, ax, ay, s_bits, h_bits, rows, first);
  const int q[4] = {kQX, kQY, kQZ, kQT};
  for (int c = 0; c < 4; ++c) fe_copy(ctx, q[c], kIX + c);  // Q = the identity
  for (int bit = 255; bit >= 0; --bit) ladder_step(ctx, bit);

  // Compress Q: y / Z with the low bit of x / Z in bit 255, against R.
  fe_inv(ctx, kT0, kQZ);
  fe_mul_n<2>(ctx, op(kT1, kQX, kT0), op(kT2, kQY, kT0), 0, 0);
  ctx.warps([&](int s) {
    I32 x[kLimbs], y[kLimbs];
    fe_freeze(ctx.sh().fe[kT1][s], x);
    fe_freeze(ctx.sh().fe[kT2][s], y);
    const long long row = group_row(s, first, rows) * kLimbs;
    y[kLimbs - 1] = y[kLimbs - 1] + (x[0] & 1) * 128;
    Pred same = true;
    for (int i = 0; i < kLimbs; ++i) same = same && y[i] == ldg(r_bytes, I64(row + i));
    f(s, sel(same, I32(1), I32(0)));
  });
}

#ifndef __CUDACC__
// ---------------------------------------------------------------------------
// The host build: each warp's part of every phase in turn.
// ---------------------------------------------------------------------------

struct HostCtx {
  std::unique_ptr<Shared> state{new Shared()};
  int bit = 0;
  Shared& sh() { return *state; }
  void sync() {}
  template <class F>
  void warps(F f) {
    for (int s = 0; s < kSigs; ++s) f(s);
  }
  template <class F>
  void units(F f) {
    for (int w = 0; w < kWarps; ++w) f(w);
  }
};

// Rows [first, first + 8) of x into slot `slot` (spare rows repeat the last).
inline void load_group(HostCtx& ctx, int slot, const int32_t* x, long long rows,
                       long long first) {
  for (int s = 0; s < kSigs; ++s)
    std::memcpy(ctx.sh().fe[slot][s], x + group_row(s, first, rows) * kLimbs,
                sizeof(int32_t) * kLimbs);
}

inline void store_group(HostCtx& ctx, int slot, int32_t* out, long long rows, long long first) {
  for (int s = 0; s < kSigs && first + s < rows; ++s)
    std::memcpy(out + (first + s) * kLimbs, ctx.sh().fe[slot][s], sizeof(int32_t) * kLimbs);
}

// out = _mul_mxu(a, b) for `rows` rows of 32 limbs, by the kernel's multiply.
inline void mul_host(const int32_t* a, const int32_t* b, int32_t* out, long long rows) {
  HostCtx ctx;
  for (long long first = 0; first < rows; first += kSigs) {
    load_group(ctx, kT0, a, rows, first);
    load_group(ctx, kT1, b, rows, first);
    fe_mul(ctx, kT2, kT0, kT1);
    store_group(ctx, kT2, out, rows, first);
  }
}

// out = _inv(z) with the kernel's multiply.
inline void inv_host(const int32_t* z, int32_t* out, long long rows) {
  HostCtx ctx;
  for (long long first = 0; first < rows; first += kSigs) {
    load_group(ctx, kT1, z, rows, first);
    fe_inv(ctx, kT0, kT1);
    store_group(ctx, kT0, out, rows, first);
  }
}

// The table of (ax, ay) and the picks by the kernel's set-up, then one
// ladder step at `bit` from Q = q[0..3] (each [rows, 32]); the new Q into
// out[0..3].
inline void ladder_step_host(const int32_t* const q[4], const int32_t* ax, const int32_t* ay,
                             const int32_t* s_bits, const int32_t* h_bits, int bit,
                             int32_t* const out[4], long long rows) {
  HostCtx ctx;
  for (long long first = 0; first < rows; first += kSigs) {
    setup(ctx, ax, ay, s_bits, h_bits, rows, first);
    for (int c = 0; c < 4; ++c) load_group(ctx, kQX + c, q[c], rows, first);
    ladder_step(ctx, bit);
    for (int c = 0; c < 4; ++c) store_group(ctx, kQX + c, out[c], rows, first);
  }
}
#endif  // !__CUDACC__

}  // namespace mxu

#ifdef __CUDACC__

namespace {

// This thread's warp of the block: the signature it owns.
struct DevCtx {
  int warp, bit;
  __device__ __forceinline__ mxu::Shared& sh() {
    extern __shared__ __align__(16) unsigned char mxu_smem[];
    return *reinterpret_cast<mxu::Shared*>(mxu_smem);
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  template <class F>
  __device__ __forceinline__ void warps(F f) {
    f(warp);
  }
  template <class F>
  __device__ __forceinline__ void units(F f) {
    f(warp);
  }
};

__global__ void __launch_bounds__(mxu::kThreads, 2)
ed25519_verify_mxu_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                          const int32_t* __restrict__ r_bytes,
                          const int32_t* __restrict__ s_bits,
                          const int32_t* __restrict__ h_bits, long long rows,
                          uint8_t* __restrict__ out) {
  DevCtx ctx;
  ctx.warp = threadIdx.x / 32;
  ctx.bit = 0;
  const long long first = (long long)blockIdx.x * mxu::kSigs;
  mxu::verify_group(ctx, ax, ay, r_bytes, s_bits, h_bits, rows, first, [&](int s, int ok) {
    if (threadIdx.x % 32 == 0 && first + s < rows) out[first + s] = (uint8_t)ok;
  });
}

}  // namespace

extern "C" int mirbft_ed25519_verify_mxu(const void* ax, const void* ay, const void* r_bytes,
                                         const void* s_bits, const void* h_bits,
                                         long long rows, void* out, void* stream) {
  const int bytes = (int)sizeof(mxu::Shared);
  cudaError_t err = cudaFuncSetAttribute(ed25519_verify_mxu_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + mxu::kSigs - 1) / mxu::kSigs);
  ed25519_verify_mxu_kernel<<<grid, mxu::kThreads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)r_bytes,
      (const int32_t*)s_bits, (const int32_t*)h_bits, rows, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
