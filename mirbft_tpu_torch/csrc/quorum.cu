// The quorum plane's wave scan with the fused wave's digest gate, written for
// Hopper (sm_90a).
//
// quorum_accumulate_kernel replaces two plain-JAX programs in one launch:
// - the quorum scan (mirbft_tpu/ops/quorum.py:66, `_kernel`, exported as
//   `accumulate_body` and jitted by `device_accumulate`): per wave of a
//   stream, OR the wave's source bit into each touched (slot, digest) mask
//   word, count the touches whose bit was new, and return every touch's
//   post-count and newbit;
// - the digest gate of the fused wave (mirbft_tpu/ops/fused.py:113-118):
//   a touch with digest_rows >= 0 counts only if row clip(digest_rows) of
//   [prev_words; digests] equals its 8 claimed words and that row's group
//   tag equals the touch's.  The concatenation is never built: row r reads
//   prev_words[r] below P and digests[r - P] from there.  With no rows at
//   all (P + B = 0, the tables `device_accumulate` passes, whose digest_rows
//   are all -1) a gated touch fails closed.
//
// What it computes, bit for bit with the JAX program (not with the numpy
// `host_accumulate`, which raises on what JAX clamps or drops):
// - The source's word and bit are its floor quotient and remainder by 32
//   (an arithmetic shift and a mask), so source -1 is word -1, bit 31.
// - Every index is taken from the end when negative.  Reads (the old mask
//   word, the post-count) then clamp to the edge; writes (the OR, the count
//   add) still out of range are dropped.  So a slot >= W reads row W-1's
//   word and count and changes nothing; a source of 300 reads word 7 and
//   leaves the masks alone while its count still grows.
// - Every touch of a wave reads its old word before any touch writes, so a
//   (slot, digest) pair touched twice in one wave is new twice and counts
//   twice, as the JAX scan's vectorised gather then scatter does.  The mask
//   word changes only where a touch is new, and then to old | bit: the JAX
//   program's scatter-max of old | bit writes exactly that.
// The result is the same whatever order the atomics run in: OR and integer
// add commute.
//
// Layout: one CTA runs the whole stream (the waves are a sequential scan:
// each reads the words and counts the last one wrote), its threads striding
// over the K touches of a wave, so K is not tied to the block size.  Masks
// and counts stay in device memory (512 KiB at W = 4,096, D = 4); each wave
// is three phases split by barriers: read (gate, old word, newbit), write
// (atomicOr of the bit, atomicAdd of one), post (read the count).  The post
// phase of wave n and the read phase of wave n + 1 are both reads, so they
// share a phase: two barriers a wave.  Reads go through L2 (ld.cg), where
// the atomics land, so no thread sees a stale L1 line.
//
// What bounds it: not bytes (a stream of N waves of K touches moves ~100 B a
// touch) nor operations, but its chain of dependent phases: each wave waits
// for the last one's atomics to reach L2 and come back, two barriers a wave,
// and a launch's fixed cost on top.  At the fused wave's shapes (N = 8 or
// 64, K = 8) it is launch-bound: a few microseconds.  Spreading the waves
// over CTAs would need a grid-wide barrier per wave, dearer than a CTA's.
//
// Outside the kernel and its launcher the code is plain C++: built for the
// host with a C++ compiler (outside __CUDACC__), `accumulate_host` runs the
// same three phases over every touch in turn, which is how the scan is
// checked without a card.
//
// Plain C interface for ctypes: the launcher takes device pointers, the
// sizes and a cudaStream_t, launches on that stream without synchronising or
// allocating, and returns cudaGetLastError().

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace quorum {

constexpr int kMaskWords = 8;
constexpr int kMaxThreads = 1024;

// One launch's tensors and sizes (masks and counts are updated in place).
struct Stream {
  uint32_t* masks;  // [W, D, 8]
  int32_t* counts;  // [W, D]
  long long W, D;
  const int32_t* sources;  // [N]
  const int32_t* touches;  // [N, K, 2]
  const uint8_t* valid;    // [N, K]
  long long N, K;
  const uint32_t* prev_words;  // [P, 8]
  long long P;
  const uint32_t* digests;  // [B, 8]
  long long B;
  const int32_t* digest_rows;   // [N, K], -1: ungated
  const uint32_t* claimed;      // [N, K, 8]
  const int32_t* row_groups;    // [P + B]
  const int32_t* touch_groups;  // [N, K]
  int32_t* posts;               // [N, K]
  uint8_t* newbits;             // [N, K]
};

// A gather index: from the end when negative, then clamped.
__host__ __device__ inline long long read_index(long long i, long long size) {
  if (i < 0) i += size;
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// A scatter index: from the end when negative; -1 when still out of range.
__host__ __device__ inline long long write_index(long long i, long long size) {
  if (i < 0) i += size;
  return i >= 0 && i < size ? i : -1;
}

__host__ __device__ inline uint32_t load_u32(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

__host__ __device__ inline int32_t load_i32(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// The word index (floor quotient) and bit (floor remainder) of a source.
struct Source {
  long long word;
  uint32_t bit;
};

__host__ __device__ inline Source source_of(const Stream& s, long long n) {
  const int32_t src = s.sources[n];
  return Source{(long long)(src >> 5), 1u << (src & 31)};
}

// The digest gate of touch t (index n * K + k).
__host__ __device__ inline bool gated_valid(const Stream& s, long long t) {
  if (!s.valid[t]) return false;
  const int32_t dr = s.digest_rows[t];
  if (dr < 0) return true;
  const long long rows = s.P + s.B;
  if (rows == 0) return false;
  const long long r = dr >= rows ? rows - 1 : dr;
  const uint32_t* row = r < s.P ? s.prev_words + r * 8 : s.digests + (r - s.P) * 8;
  const uint32_t* claim = s.claimed + t * 8;
  bool eq = true;
  for (int w = 0; w < 8; ++w) eq &= row[w] == claim[w];
  return eq && s.row_groups[r] == s.touch_groups[t];
}

// Phase 1: the gate, the old word (clamped read) and the newbit.
__host__ __device__ inline void read_phase(const Stream& s, Source src, long long t) {
  const bool ok = gated_valid(s, t);
  const long long w = read_index(s.touches[2 * t], s.W);
  const long long d = read_index(s.touches[2 * t + 1], s.D);
  const long long word = read_index(src.word, kMaskWords);
  const uint32_t old = load_u32(s.masks + (w * s.D + d) * kMaskWords + word);
  s.newbits[t] = ok && (old & src.bit) == 0;
}

// Phase 2: a new touch ORs its bit into its word and adds one to its count,
// each where its index is in range.  Only the touch's own thread reads the
// newbit it wrote in phase 1.
__host__ __device__ inline void write_phase(const Stream& s, Source src, long long t) {
  if (!s.newbits[t]) return;
  const long long w = write_index(s.touches[2 * t], s.W);
  const long long d = write_index(s.touches[2 * t + 1], s.D);
  if (w < 0 || d < 0) return;
  const long long word = write_index(src.word, kMaskWords);
  uint32_t* mask = s.masks + (w * s.D + d) * kMaskWords + word;
  int32_t* count = s.counts + w * s.D + d;
#ifdef __CUDA_ARCH__
  if (word >= 0) atomicOr(mask, src.bit);
  atomicAdd(count, 1);
#else
  if (word >= 0) *mask |= src.bit;
  *count += 1;
#endif
}

// Phase 3: the post-count (clamped read) after every add of the wave.
__host__ __device__ inline void post_phase(const Stream& s, long long t) {
  const long long w = read_index(s.touches[2 * t], s.W);
  const long long d = read_index(s.touches[2 * t + 1], s.D);
  s.posts[t] = load_i32(s.counts + w * s.D + d);
}

#ifndef __CUDACC__
// The launch on the host: each phase over every touch of a wave in turn,
// where the card puts a barrier.
inline void accumulate_host(const Stream& s) {
  for (long long n = 0; n < s.N; ++n) {
    const Source src = source_of(s, n);
    for (long long k = 0; k < s.K; ++k) read_phase(s, src, n * s.K + k);
    for (long long k = 0; k < s.K; ++k) write_phase(s, src, n * s.K + k);
    for (long long k = 0; k < s.K; ++k) post_phase(s, n * s.K + k);
  }
}
#endif  // !__CUDACC__

}  // namespace quorum

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(quorum::kMaxThreads)
quorum_accumulate_kernel(const quorum::Stream s) {
  const long long step = blockDim.x;
  quorum::Source src = quorum::source_of(s, 0);
  for (long long k = threadIdx.x; k < s.K; k += step) quorum::read_phase(s, src, k);
  __syncthreads();
  for (long long n = 0; n < s.N; ++n) {
    const long long base = n * s.K;
    for (long long k = threadIdx.x; k < s.K; k += step) quorum::write_phase(s, src, base + k);
    __syncthreads();
    // This wave's posts, and the next wave's reads: neither writes what the
    // other reads.
    const bool more = n + 1 < s.N;
    const quorum::Source next = more ? quorum::source_of(s, n + 1) : src;
    for (long long k = threadIdx.x; k < s.K; k += step) {
      quorum::post_phase(s, base + k);
      if (more) quorum::read_phase(s, next, base + s.K + k);
    }
    __syncthreads();
    src = next;
  }
}

}  // namespace

extern "C" int mirbft_quorum_accumulate(
    void* masks, void* counts, long long W, long long D, const void* sources,
    const void* touches, const void* valid, long long N, long long K,
    const void* prev_words, long long P, const void* digests, long long B,
    const void* digest_rows, const void* claimed, const void* row_groups,
    const void* touch_groups, void* posts, void* newbits, void* stream) {
  const quorum::Stream s{
      (uint32_t*)masks,          (int32_t*)counts,          W, D,
      (const int32_t*)sources,   (const int32_t*)touches,   (const uint8_t*)valid,
      N,                         K,                         (const uint32_t*)prev_words,
      P,                         (const uint32_t*)digests,  B,
      (const int32_t*)digest_rows, (const uint32_t*)claimed, (const int32_t*)row_groups,
      (const int32_t*)touch_groups, (int32_t*)posts,         (uint8_t*)newbits};
  long long threads = (K + 31) / 32 * 32;
  if (threads > quorum::kMaxThreads) threads = quorum::kMaxThreads;
  if (threads < 32) threads = 32;
  quorum_accumulate_kernel<<<1, (unsigned)threads, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
