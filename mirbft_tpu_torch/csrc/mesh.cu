// The device mesh's per-shard count, written for Hopper (sm_90a).
//
// mesh_count_kernel replaces the shard bodies of two plain-JAX programs of
// the JAX package's device mesh (mirbft_tpu/parallel/mesh.py:73, :104),
// the part of each shard's program after its hash or verify stage:
// - `distributed_verify_step` (mesh.py:83-91): count the rows of the shard
//   whose digest differs from its expected digest in any of its 8 words;
// - `sharded_ed25519_verify` (mesh.py:125-134): AND each verdict with its
//   structural validity (written back in place: the shard's verdicts are
//   `ok & valid`), and count the real rows that are not ok.
// The hash and verify stages are the port's SHA-256 and Ed25519 kernels
// (csrc/sha256.cu, csrc/ed25519.cu); the reference's `psum` of the counts
// over the mesh is an all-reduce of these one-word counts, outside the
// kernel (mirbft_tpu_torch/parallel/mesh.py).  So the digests and verdicts
// stay on the device and one word a shard leaves it.
//
// What bounds it: bytes.  A digest row reads 64 bytes (its 8 words and the
// 8 expected), a verdict row reads 3 bytes and writes one; a row's
// operations are a handful of integer instructions.  At 3.35 TB/s even
// 4,096 digest rows are 0.08 us of memory traffic, under the launch's own
// cost, so the design keeps to one pass and ONE operation on the stream: a
// grid-stride loop over the rows (16-byte loads of a digest row's two
// halves), each thread's count summed by warp shuffles, the warps' sums by
// the first warp.  A launch of one block stores its sum as the count.  In a
// launch of several, each block adds its sum and a ticket of one in a
// single 64-bit atomicAdd on the stream's accumulator word (the sum in the
// low half, the blocks done in the high half); the block that draws the
// last ticket holds the whole count in what the add returned, stores it and
// zeroes the accumulator for the stream's next launch.  So no block waits
// on another, nothing zeroes the count before the launch, and the
// accumulator is zeroed once, when the wrapper first allocates it.
// Integer sums are exact in any order, so the count is the same whatever
// order the blocks finish in.
//
// Outside the kernel and its launcher the code is plain C++: built for the
// host with a C++ compiler (outside __CUDACC__), `count_host` runs the same
// grid (`grid_of`) thread by thread, each thread's grid-stride rows in turn
// and the sums in the order the card's reduction adds them, and each
// block's add into the accumulator in block order, which is how the design
// is checked without a card.
//
// Plain C interface for ctypes: the launcher takes device pointers, the
// row count and a cudaStream_t, launches on that stream without
// synchronising or allocating, and returns cudaGetLastError().

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace mesh {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Enough blocks to fill the card's 132 SMs a few times over; a longer
// shard loops.
constexpr long long kMaxBlocks = 132 * 4;

enum Mode : int { kDigests = 0, kVerdicts = 1 };

// One launch's pointers (a shard's rows) and its mode.
struct Args {
  int mode;
  const uint32_t* words;     // [rows, 8], kDigests
  const uint32_t* expected;  // [rows, 8], kDigests
  uint8_t* ok;               // [rows], kVerdicts: ok & valid written back
  const uint8_t* valid;      // [rows], kVerdicts
  const uint8_t* real;       // [rows], kVerdicts
  long long rows;
  uint32_t* count;  // one word
  unsigned long long* acc;  // the stream's accumulator: 0 between launches
};

// The accumulator's add of one block of a launch of several: its sum in the
// low half, one ticket in the high half.
__host__ __device__ inline unsigned long long ticket_of(uint32_t block_sum) {
  return (1ull << 32) | (unsigned long long)block_sum;
}

// The last of `blocks` blocks is the one whose add found blocks - 1 tickets.
__host__ __device__ inline bool is_last(unsigned long long before, long long blocks) {
  return (long long)(before >> 32) == blocks - 1;
}

// Blocks of a launch over `rows` rows (at least one, so that a launch over
// no rows still runs the reduction's code path).
__host__ __device__ inline long long grid_of(long long rows) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

struct Half {
  uint32_t x, y, z, w;
};

__host__ __device__ inline Half load_half(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return Half{v.x, v.y, v.z, v.w};
#else
  return Half{p[0], p[1], p[2], p[3]};
#endif
}

__host__ __device__ inline uint32_t half_diff(const uint32_t* a, const uint32_t* b) {
  const Half u = load_half(a), v = load_half(b);
  return (u.x ^ v.x) | (u.y ^ v.y) | (u.z ^ v.z) | (u.w ^ v.w);
}

// Row i's contribution to the count (0 or 1); in verdict mode it also
// writes the row's ok & valid back.
__host__ __device__ inline uint32_t row_flag(const Args& a, long long i) {
  if (a.mode == kDigests) {
    const uint32_t* w = a.words + i * 8;
    const uint32_t* e = a.expected + i * 8;
    return (half_diff(w, e) | half_diff(w + 4, e + 4)) != 0u;
  }
  const uint32_t ok = (a.ok[i] != 0) & (a.valid[i] != 0);
  a.ok[i] = (uint8_t)ok;
  return (uint32_t)(a.real[i] != 0) & (ok ^ 1u);
}

// One thread's rows: first, first + stride, ... below rows.
__host__ __device__ inline uint32_t thread_count(const Args& a, long long first,
                                                 long long stride) {
  uint32_t n = 0;
  for (long long i = first; i < a.rows; i += stride) n += row_flag(a, i);
  return n;
}

#ifndef __CUDACC__
// The launch on the host: the same grid, each thread's rows in turn, the
// warps' and the block's sums in the order the card adds them; a launch of
// one block stores its sum, a launch of several adds each block's ticket
// into the accumulator in block order, and the last block stores the count
// and zeroes the accumulator.
inline void count_host(const Args& a) {
  const long long blocks = grid_of(a.rows), stride = blocks * kThreads;
  for (long long b = 0; b < blocks; ++b) {
    uint32_t warp_sums[kWarps];
    for (int w = 0; w < kWarps; ++w) {
      uint32_t lanes[32];
      for (int l = 0; l < 32; ++l) lanes[l] = thread_count(a, b * kThreads + w * 32 + l, stride);
      for (int off = 16; off > 0; off >>= 1)
        for (int l = 0; l + off < 32; ++l) lanes[l] += lanes[l + off];
      warp_sums[w] = lanes[0];
    }
    uint32_t lanes[32] = {0};
    for (int w = 0; w < kWarps; ++w) lanes[w] = warp_sums[w];
    for (int off = 16; off > 0; off >>= 1)
      for (int l = 0; l + off < 32; ++l) lanes[l] += lanes[l + off];
    const uint32_t block_sum = lanes[0];
    if (blocks == 1) {
      *a.count = block_sum;
      continue;
    }
    const unsigned long long before = *a.acc;
    *a.acc += ticket_of(block_sum);
    if (is_last(before, blocks)) {
      *a.count = (uint32_t)before + block_sum;
      *a.acc = 0;
    }
  }
}
#endif  // !__CUDACC__

}  // namespace mesh

#ifdef __CUDACC__

namespace {

__device__ __forceinline__ uint32_t warp_sum(uint32_t n) {
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xFFFFFFFFu, n, off);
  return n;
}

__global__ void __launch_bounds__(mesh::kThreads) mesh_count_kernel(const mesh::Args a) {
  __shared__ uint32_t warp_sums[mesh::kWarps];
  const long long stride = (long long)gridDim.x * mesh::kThreads;
  const long long first = (long long)blockIdx.x * mesh::kThreads + threadIdx.x;
  const uint32_t n = warp_sum(mesh::thread_count(a, first, stride));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = n;
  __syncthreads();
  if (warp == 0) {
    const uint32_t block = warp_sum(lane < mesh::kWarps ? warp_sums[lane] : 0u);
    if (lane == 0) {
      if (gridDim.x == 1) {
        *a.count = block;
      } else {
        const unsigned long long before = atomicAdd(a.acc, mesh::ticket_of(block));
        if (mesh::is_last(before, gridDim.x)) {
          *a.count = (uint32_t)before + block;
          *a.acc = 0ull;
        }
      }
    }
  }
}

}  // namespace

// `acc` is the stream's accumulator word (8 bytes, zero before the first
// launch; every launch leaves it zero).
extern "C" int mirbft_mesh_count(int mode, const void* words, const void* expected, void* ok,
                                 const void* valid, const void* real, long long rows,
                                 void* count, void* acc, void* stream) {
  if (mode != mesh::kDigests && mode != mesh::kVerdicts) return (int)cudaErrorInvalidValue;
  const mesh::Args a{mode,
                     (const uint32_t*)words,
                     (const uint32_t*)expected,
                     (uint8_t*)ok,
                     (const uint8_t*)valid,
                     (const uint8_t*)real,
                     rows,
                     (uint32_t*)count,
                     (unsigned long long*)acc};
  mesh_count_kernel<<<(unsigned)mesh::grid_of(rows), mesh::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
