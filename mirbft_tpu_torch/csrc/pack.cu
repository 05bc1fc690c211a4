// SHA-256 wave packing on the card, written for Hopper (sm_90a).
//
// pack_wave_kernel replaces no TPU kernel.  It takes over host work: the
// JAX package pads and packs every wave on the host (`pack_messages`,
// mirbft_tpu/ops/sha256.py:242) and ships the kernel-ready words, and so
// did the port until this kernel.  Now the host stages the wave's raw bytes
// once, with each row's byte offset and length, in a pinned buffer that
// crosses in one copy, and this kernel writes exactly the words that
// `pack_messages` writes for either layout:
// - batch: blocks [batch, bucket, 16] for sha256_batch_kernel;
// - lanes: blocks [tiles, bucket, 16, 8, 128] for sha256_lanes_kernel, word
//   t of block b of message m = tile * 1024 + sub * 128 + lane at
//   [tile, b, t, sub, lane];
// and n_blocks (flat [batch] in both layouts: a lanes tile's [1, 8, 128]
// is message order).  A row's padded stream is its bytes, the 0x80
// terminator, zeros, and its bit length as a big-endian 64-bit integer in
// the last 8 bytes of its last block ((len + 8) / 64 + 1 blocks); blocks
// past that, and every word of the padding rows past the real ones, are 0;
// each word is the big-endian reading of its 4 bytes.
//
// What bounds it: bytes.  It reads each message byte once and writes every
// word of the wave once (a 4,096 x 640-byte wave at a 16-block bucket:
// 2.6 MB in, 4.2 MB out, ~2 us at 3.35 TB/s); per word a handful of
// integer operations.  So one pass: a CTA takes 128 rows (one lane row of
// a lanes tile) and one block index, and each thread a 16-byte quarter of
// a row's 64-byte block (four neighbouring threads on one row's block).
// The quarter's bytes come in as 16-byte vector loads: the aligned
// granule that holds its first byte and, when the row's bytes are not
// 16-byte aligned, the next one; the quarter is cut out of that 32-byte
// window in registers (byte permutes), byte-swapped to big-endian words,
// and the terminator, zeros and bit length are merged in registers where
// the quarter passes the row's end.  Stores:
// - batch layout: the quarter's four words as one 16-byte store, 64
//   contiguous bytes a row;
// - lanes layout: into a shared [128][17]-word tile (the odd stride keeps
//   the transposing read free of bank conflicts), then, after a barrier,
//   word t of the 128 rows as 512 contiguous bytes.
// A granule that runs past the end of `raw`, or any granule when `raw` is
// not 16-byte aligned, is read byte by byte (bytes past the end read 0,
// and are never kept).
//
// Outside the kernel and its launcher the code is plain C++: built for the
// host with a C++ compiler (outside __CUDACC__), `pack_host` runs the same
// grid CTA by CTA, each CTA's two passes thread by thread, through the same
// index math, which is how the layout is checked without a card.
//
// Plain C interface for ctypes: the launcher takes device pointers, the
// sizes and a cudaStream_t, launches on that stream without synchronising
// or allocating, and returns cudaGetLastError().

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace pack {

constexpr int kRows = 128;     // rows a CTA: one lane row of a lanes tile
constexpr int kThreads = 256;
constexpr int kWords = 16;     // words of a 64-byte block
constexpr int kQuarters = 4;   // 16-byte quarters of a block
constexpr int kStride = 17;    // shared tile row, in words
constexpr int kSub = 8, kLanes = 128, kTile = kSub * kLanes;

enum Layout : int { kBatch = 0, kLanesMajor = 1 };

struct Args {
  const uint8_t* raw;         // the wave's bytes
  long long raw_bytes;        // bytes readable at raw
  int vec;                    // raw is 16-byte aligned: whole granules load as vectors
  const long long* offsets;   // [n]: row i's first byte in raw
  const int32_t* lengths;     // [n]: row i's length in bytes
  long long n;                // real rows
  long long batch;            // rows of the wave (padding rows past n)
  long long bucket;           // blocks a row
  int layout;
  uint32_t* blocks;           // the packed words, in `layout`
  uint32_t* n_blocks;         // [batch]
};

__host__ __device__ inline uint32_t blocks_of(long long len) {
  return (uint32_t)((len + 8) / 64 + 1);
}

// __byte_perm: byte k of the result is byte (s >> 4k) & 7 of y:x.
__host__ __device__ inline uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= (uint32_t)((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
  return r;
#endif
}

// Granule g of raw (its 16 bytes from raw + 16 g) as four little-endian
// words.
__host__ __device__ inline void load_granule(const Args& a, long long g, uint32_t out[4]) {
#ifdef __CUDA_ARCH__
  if (a.vec && (g + 1) * 16 <= a.raw_bytes) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.raw) + g);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
    return;
  }
#endif
  for (int k = 0; k < 4; ++k) {
    uint32_t word = 0;
    for (int j = 0; j < 4; ++j) {
      const long long p = g * 16 + 4 * k + j;
      if (p < a.raw_bytes) word |= (uint32_t)a.raw[p] << (8 * j);
    }
    out[k] = word;
  }
}

// Word k (0..7) of the window lo:hi, by selects (no indexed registers).
__host__ __device__ inline uint32_t window_word(const uint32_t lo[4], const uint32_t hi[4],
                                                int k) {
  uint32_t v = lo[0];
  v = k == 1 ? lo[1] : v;
  v = k == 2 ? lo[2] : v;
  v = k == 3 ? lo[3] : v;
  v = k == 4 ? hi[0] : v;
  v = k == 5 ? hi[1] : v;
  v = k == 6 ? hi[2] : v;
  v = k == 7 ? hi[3] : v;
  return v;
}

// Byte p (at or past len) of a row's padded stream: the terminator, zeros,
// and the bit length, big-endian, in the last 8 bytes of the last block.
__host__ __device__ inline uint32_t tail_byte(long long len, long long p) {
  if (p == len) return 0x80u;
  const long long end = (long long)blocks_of(len) * 64;
  if (p >= end - 8) {
    const unsigned long long bits = (unsigned long long)len * 8ull;
    return (uint32_t)((bits >> (8 * (end - 1 - p))) & 0xFFull);
  }
  return 0u;
}

// Quarter q (words 4q..4q+3) of block b of row m, as pack_messages stores
// them (big-endian words).
__host__ __device__ inline void quarter_words(const Args& a, long long m, long long b, int q,
                                              uint32_t out[4]) {
  out[0] = out[1] = out[2] = out[3] = 0u;
  if (m >= a.n) return;
  const long long len = a.lengths[m];
  const long long p0 = b * 64 + 16 * q;
  if (p0 >= (long long)blocks_of(len) * 64) return;
  uint32_t d[4] = {0u, 0u, 0u, 0u};  // the row's bytes p0.., little-endian words
  if (p0 < len) {
    const long long s = a.offsets[m] + p0;
    const long long g = s >> 4;
    const int r = (int)(s & 15);
    const long long have = len - p0 < 16 ? len - p0 : 16;
    uint32_t lo[4], hi[4] = {0u, 0u, 0u, 0u};
    load_granule(a, g, lo);
    if (r + have > 16) load_granule(a, g + 1, hi);
    const int i = r >> 2;
    const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(r & 3);
    uint32_t u[5];
    for (int k = 0; k < 5; ++k) u[k] = window_word(lo, hi, i + k);
    for (int k = 0; k < 4; ++k) d[k] = byte_perm(u[k], u[k + 1], sel);
  }
  if (p0 + 16 <= len) {
    for (int k = 0; k < 4; ++k) out[k] = byte_perm(d[k], 0u, 0x0123u);
    return;
  }
  for (int k = 0; k < 4; ++k) {
    uint32_t word = 0;
    for (int j = 0; j < 4; ++j) {
      const long long p = p0 + 4 * k + j;
      const uint32_t byte = p < len ? (d[k] >> (8 * j)) & 0xFFu : tail_byte(len, p);
      word |= byte << (24 - 8 * j);
    }
    out[k] = word;
  }
}

// The CTAs of a launch: (row groups, blocks a row).
__host__ __device__ inline long long groups_of(long long batch) {
  return (batch + kRows - 1) / kRows;
}

// Pass 1 of CTA (g, b), index i of kRows * kQuarters: row l = i / 4 of the
// group builds its quarter q = i % 4.  Batch layout: stored at once; lanes
// layout: into the tile.
__host__ __device__ inline void pass_build(const Args& a, long long g, long long b, int i,
                                           uint32_t* tile) {
  const int l = i >> 2, q = i & 3;
  const long long m = g * kRows + l;
  if (m >= a.batch) return;
  uint32_t w[4];
  quarter_words(a, m, b, q, w);
  if (a.layout == kBatch) {
    uint32_t* dst = a.blocks + (m * a.bucket + b) * kWords + 4 * q;
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#else
    for (int k = 0; k < 4; ++k) dst[k] = w[k];
#endif
  } else {
    for (int k = 0; k < 4; ++k) tile[l * kStride + 4 * q + k] = w[k];
  }
}

// Pass 2 of CTA (g, b), lanes layout only: index i of kWords * kRows, word
// w = i / 128 of row l = i % 128, to [tile, b, w, sub, lane].
__host__ __device__ inline void pass_store_lanes(const Args& a, long long g, long long b, int i,
                                                 const uint32_t* tile) {
  const int w = i / kRows, l = i % kRows;
  const long long t = g / kSub, sub = g % kSub;
  a.blocks[((t * a.bucket + b) * kWords + w) * kTile + sub * kLanes + l] = tile[l * kStride + w];
}

// n_blocks of row l of group g (written by the CTAs of block 0).
__host__ __device__ inline void pass_counts(const Args& a, long long g, int l) {
  const long long m = g * kRows + l;
  if (m < a.batch) a.n_blocks[m] = m < a.n ? blocks_of(a.lengths[m]) : 0u;
}

#ifndef __CUDACC__
// The launch on the host: every CTA in turn, each pass over its threads.
inline void pack_host(const Args& a) {
  uint32_t tile[kRows * kStride];
  for (long long g = 0; g < groups_of(a.batch); ++g) {
    for (long long b = 0; b < a.bucket; ++b) {
      for (int i = 0; i < kRows * kQuarters; ++i) pass_build(a, g, b, i, tile);
      if (a.layout == kLanesMajor)
        for (int i = 0; i < kRows * kWords; ++i) pass_store_lanes(a, g, b, i, tile);
      if (b == 0)
        for (int l = 0; l < kRows; ++l) pass_counts(a, g, l);
    }
  }
}
#endif  // !__CUDACC__

}  // namespace pack

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(pack::kThreads) pack_wave_kernel(const pack::Args a) {
  __shared__ uint32_t tile[pack::kRows * pack::kStride];
  const long long g = blockIdx.x, b = blockIdx.y;
  for (int i = threadIdx.x; i < pack::kRows * pack::kQuarters; i += pack::kThreads)
    pack::pass_build(a, g, b, i, tile);
  if (a.layout == pack::kLanesMajor) {
    __syncthreads();
    for (int i = threadIdx.x; i < pack::kRows * pack::kWords; i += pack::kThreads)
      pack::pass_store_lanes(a, g, b, i, tile);
  }
  if (b == 0 && threadIdx.x < pack::kRows) pack::pass_counts(a, g, threadIdx.x);
}

}  // namespace

extern "C" int mirbft_pack_wave(const void* raw, long long raw_bytes, const void* offsets,
                                const void* lengths, long long n, long long batch, long long bucket, int layout,
                                void* blocks, void* n_blocks, void* stream) {
  if (layout != pack::kBatch && layout != pack::kLanesMajor) return (int)cudaErrorInvalidValue;
  if (n < 0 || batch < n || bucket < 1 || bucket > 65535) return (int)cudaErrorInvalidValue;
  if (layout == pack::kLanesMajor && batch % pack::kTile) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const pack::Args a{(const uint8_t*)raw,
                     raw_bytes,
                     ((uintptr_t)raw & 15) == 0,
                     (const long long*)offsets,
                     (const int32_t*)lengths,
                     n,
                     batch,
                     bucket,
                     layout,
                     (uint32_t*)blocks,
                     (uint32_t*)n_blocks};
  const dim3 grid((unsigned)pack::groups_of(batch), (unsigned)bucket);
  pack_wave_kernel<<<grid, pack::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
