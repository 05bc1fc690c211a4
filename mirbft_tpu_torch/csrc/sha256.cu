// Batched SHA-256 for the device hash plane: the two kernels that carry every
// device hash wave of a Recording, written for Hopper (sm_90a).
//
// sha256_lanes_kernel replaces the JAX package's lanes-major Pallas kernel
//   (ops/sha256_pallas_lanes.py:37, `_kernel`).
// sha256_batch_kernel replaces its batch-major Pallas kernel
//   (ops/sha256_pallas.py:58, `_sha256_tile_kernel`) and, on the card, the
//   vmapped-scan program (ops/sha256.py `sha256_batch_kernel`): both share the
//   [B, L, 16] -> [B, 8] contract.
//
// What bounds them on an H100: 32-bit integer ALU work.  One 64-byte block
// costs 1,384 sm_90 instructions counted at their fan-in (a rotate is one
// SHF, any two- or three-input logic such as ch, maj or a three-way xor one
// LOP3, up to three addends one IADD3): 64 rounds x (6 SHF + 4 LOP3 + 4
// IADD3), 48 schedule words x (4 SHF + 2 SHR + 2 LOP3 + 2 IADD3), and the 8
// state adds.  The 1,024 shifts and logic ops run only on the INT32 pipe; the
// adds may also issue as IMAD on the FMA pipe.  That is ~16 INT32-pipe
// instructions per byte read, against the card's ~5 per byte of HBM
// bandwidth, so memory traffic is negligible and the kernels are
// operation-bound.
//
// What the design does about it: one thread per message, the eight working
// variables and the rolling 16-word schedule window in registers, the 64
// rounds fully unrolled so every schedule index and round constant is a
// compile-time constant (no local memory, K from the constant bank).  The
// TPU kernel's sequential block grid axis with its state in VMEM scratch
// becomes a loop over the message's blocks inside the thread; the loop stops
// at the message's own block count, so padding blocks and padding rows
// (n_blocks == 0, which emit H0) cost no rounds.  Staging rows through shared
// memory, funnel-shift rotates and more messages per thread are left for a
// later tuning pass.
//
// Words are the numeric big-endian values the host packer writes (it
// byteswaps on the host), and the digest words come out as numeric state
// words, exactly what `digests_from_words` expects.
//
// Plain C interface for ctypes: each launcher takes device pointers, sizes
// and a cudaStream_t, launches on that stream without synchronising, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesTile = 8 * 128;  // messages per lanes-major tile
constexpr int kThreads = 64;         // small blocks spread small waves over SMs

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, uint32_t n) {
  return (x >> n) | (x << (32u - n));
}

__device__ __forceinline__ void init_state(uint32_t (&s)[8]) {
  s[0] = 0x6A09E667u; s[1] = 0xBB67AE85u; s[2] = 0x3C6EF372u; s[3] = 0xA54FF53Au;
  s[4] = 0x510E527Fu; s[5] = 0x9B05688Cu; s[6] = 0x1F83D9ABu; s[7] = 0x5BE0CD19u;
}

// One compression: the state advances by one 16-word block (w is consumed as
// the rolling schedule window).
__device__ __forceinline__ void compress(uint32_t (&s)[8], uint32_t (&w)[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + big_s1 + ch + kK[t] + wt;
    const uint32_t big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = big_s0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

// blocks [tiles, L, 16, 8, 128], n_blocks [tiles, 1, 8, 128] -> out
// [tiles, 8, 8, 128].  Thread g hashes message g: lane g % 1024 of tile
// g / 1024.  Word t of block b for the tile's 1024 messages is contiguous,
// so a warp's 32 loads of one word are one coalesced 128-byte transaction.
__global__ void __launch_bounds__(kThreads)
sha256_lanes_kernel(const uint32_t* __restrict__ blocks,
                    const uint32_t* __restrict__ n_blocks,
                    uint32_t* __restrict__ out, long long messages, int L) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= messages) return;
  const long long tile = g / kLanesTile;
  const int lane = (int)(g % kLanesTile);
  const uint32_t nb = n_blocks[g];
  const int live = nb < (uint32_t)L ? (int)nb : L;

  uint32_t s[8];
  init_state(s);
  const uint32_t* src = blocks + tile * (long long)L * 16 * kLanesTile + lane;
  for (int b = 0; b < live; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = src[(long long)(b * 16 + t) * kLanesTile];
    compress(s, w);
  }
  uint32_t* dst = out + tile * 8 * kLanesTile + lane;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i * kLanesTile] = s[i];
}

// blocks [B, L, 16], n_blocks [B] -> out [B, 8].  One thread per row; each
// block of a row is read as four 16-byte loads.
__global__ void __launch_bounds__(kThreads)
sha256_batch_kernel(const uint32_t* __restrict__ blocks,
                    const uint32_t* __restrict__ n_blocks,
                    uint32_t* __restrict__ out, long long rows, int L) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const uint32_t nb = n_blocks[row];
  const int live = nb < (uint32_t)L ? (int)nb : L;

  uint32_t s[8];
  init_state(s);
  const uint4* src = reinterpret_cast<const uint4*>(blocks + row * (long long)L * 16);
  for (int b = 0; b < live; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = src[b * 4 + q];
      w[4 * q + 0] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
    compress(s, w);
  }
  uint32_t* dst = out + row * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = s[i];
}

unsigned grid_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int mirbft_sha256_lanes(const void* blocks, const void* n_blocks,
                                   void* out, long long tiles, long long L,
                                   void* stream) {
  const long long messages = tiles * kLanesTile;
  sha256_lanes_kernel<<<grid_for(messages), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const uint32_t*)n_blocks, (uint32_t*)out,
      messages, (int)L);
  return (int)cudaGetLastError();
}

extern "C" int mirbft_sha256_batch(const void* blocks, const void* n_blocks,
                                   void* out, long long rows, long long L,
                                   void* stream) {
  sha256_batch_kernel<<<grid_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const uint32_t*)n_blocks, (uint32_t*)out, rows,
      (int)L);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
