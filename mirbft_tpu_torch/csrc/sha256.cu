// Batched SHA-256 for the device hash plane: the two kernels that carry every
// device hash wave of a Recording, written for Hopper (sm_90a).
//
// sha256_lanes_kernel replaces the JAX package's lanes-major Pallas kernel
//   (ops/sha256_pallas_lanes.py:37, `_kernel`).
// sha256_batch_kernel replaces its batch-major Pallas kernel
//   (ops/sha256_pallas.py:58, `_sha256_tile_kernel`) and, on the card, the
//   vmapped-scan program (ops/sha256.py `sha256_batch_kernel`): both share the
//   [B, L, 16] -> [B, 8] contract.
// Both run one core (`hash_wave`) and differ only in how a message's words,
// block count and digest are addressed.
//
// What bounds them at the plane's shapes: the round's dependent chain, not
// the card's INT32 throughput.  A wave holds 64 to 4,096 messages, a
// message's blocks form a serial chain, and each block is 64 dependent
// rounds, so a wave takes (most live blocks of any message) x 64 rounds x
// the cycles of one round, with the card nearly empty: 4,096 messages are
// one warp on each SM.  The card's INT32 bound of the same work is 0.2-6% of
// that time.  What sets the cycles of a round is one warp on one SM
// sub-partition: its shifts, logic and three-input adds share one integer
// pipe that takes ~2.1 cycles per warp instruction, and each round's result
// feeds the next, so rounds cannot overlap.  So the design takes everything
// but the round off that warp:
//
// - Warp split.  A CTA is one consumer warp, whose lanes hold 32 messages
//   (one each, state in registers), and kProducers producer warps.  The
//   producers load each live block's 16 words, expand the message schedule
//   W[16..63] and add the round constant, and write KW[t] = W[t] + K[t] into
//   a shared-memory ring.  The consumer runs only the 64 rounds of each block
//   and the 8 state adds.  Warps of a CTA sit on different SM
//   sub-partitions, so the schedule's ~650 instructions a block no longer
//   share the consumer's pipes: its block is ~1,030 instructions, against
//   ~1,410 when one thread did both.
// - The ring.  kStages stages of KW[64][32 lanes] (8 KB each, lane index
//   innermost so a warp's 32 reads or writes of one KW[t] hit 32 distinct
//   banks), handed over by a full/empty mbarrier pair per stage with phase
//   parity.  Producers take blocks round robin and run up to kStages blocks
//   ahead of the consumer, so the global loads of a block are issued while
//   the consumer is still hashing earlier ones.  Plain loads are enough for
//   that: a producer has kProducers consumer blocks (~4,400 cycles) to load
//   and expand one block, and its ~650 instructions and one global-load
//   latency take well under that.  cp.async or TMA would also free the
//   producer's registers, which nothing here is short of.
// - The round (csrc/sha256_round.cuh).  h + KW[t] (and d, for the new e)
//   are summed off the loop-carried path, since h and d are known three
//   rounds ahead: e' = Σ1(e) + Ch + (h + KW + d) and a' = Σ1(e) + Ch +
//   (h + KW) + Σ0(a) + Maj.  Ch and Maj are written as one three-input
//   function each (one LOP3) and rotates are funnel shifts (SHF): 6 SHF, 4
//   LOP3, 2 IADD3 and 3 IMAD (the compiler's split of the adds) and 1 LDS a
//   round.  Sending every add to the FMA pipe as an IMAD frees the integer
//   pipe but puts IMADs on both loop-carried chains, and measured no faster
//   on this card; PERF.md has the numbers.
//
// Ragged waves: the consumer runs the rounds for all 32 lanes up to the
// CTA's longest message, and a lane past its own block count keeps its state
// (its rounds run on whatever the ring holds and are dropped).  Producers
// never read a word past a message's last block.  A CTA whose 32 messages
// all have n_blocks == 0 (or lie past the wave) writes H0 and exits without
// touching the ring, so padding rows and the empty rows of a lanes tile cost
// one launch slot each.
//
// Words are the numeric big-endian values the host packer writes (it
// byteswaps on the host), and the digest words come out as numeric state
// words, exactly what `digests_from_words` expects.
//
// Plain C interface for ctypes: each launcher takes device pointers, sizes
// and a cudaStream_t, launches on that stream without synchronising or
// allocating, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_round.cuh"

namespace {

using sha256_round::rotr;

constexpr int kLanesTile = 8 * 128;  // messages per lanes-major tile
constexpr int kWarp = 32;            // messages per CTA: one per consumer lane
constexpr int kProducers = 2;        // producer warps per CTA
constexpr int kThreads = kWarp * (1 + kProducers);
constexpr int kStages = 4;           // ring depth, in blocks
constexpr int kRounds = 64;

__constant__ uint32_t kK[kRounds] = {
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

// The CTA's shared memory: 32 KB of ring and one mbarrier pair per stage.
struct Ring {
  uint32_t kw[kStages][kRounds][kWarp];
  uint64_t full[kStages];   // producers -> consumer: stage holds a block
  uint64_t empty[kStages];  // consumer -> producers: stage may be refilled
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(bar)),
               "r"(count) : "memory");
}

// Release: this thread's earlier shared-memory reads and writes are done
// before the arrival counts.
__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(shared_addr(bar))
               : "memory");
}

// Acquire: returns once the phase of the given parity has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void init_state(uint32_t (&s)[8]) {
  s[0] = 0x6A09E667u; s[1] = 0xBB67AE85u; s[2] = 0x3C6EF372u; s[3] = 0xA54FF53Au;
  s[4] = 0x510E527Fu; s[5] = 0x9B05688Cu; s[6] = 0x1F83D9ABu; s[7] = 0x5BE0CD19u;
}

// Producer warp `p`: blocks p, p + kProducers, ... of the CTA, each into
// ring stage b % kStages once the consumer has released that stage's
// previous block.
template <class IO>
__device__ __forceinline__ void produce(const IO& io, long long m, uint32_t live,
                                        uint32_t blocks, int p, int lane, Ring& ring) {
  for (uint32_t b = p; b < blocks; b += kProducers) {
    const uint32_t stage = b % kStages;
    const uint32_t use = b / kStages;
    if (use > 0) barrier_wait(&ring.empty[stage], (use - 1) & 1);
    if (b < live) {
      uint32_t w[16];
      io.load(m, b, w);
      uint32_t* dst = &ring.kw[stage][0][lane];
#pragma unroll
      for (int t = 0; t < kRounds; ++t) {
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
        dst[t * kWarp] = wt + kK[t];
      }
    }
    barrier_arrive(&ring.full[stage]);
  }
}

// The consumer warp: 64 rounds per block on KW from the ring, state in
// registers; lanes past their own block count keep their state.
template <class IO>
__device__ __forceinline__ void consume(const IO& io, long long m, bool real,
                                        uint32_t live, uint32_t blocks, int lane,
                                        Ring& ring) {
  uint32_t s[8];
  init_state(s);
  for (uint32_t blk = 0; blk < blocks; ++blk) {
    const uint32_t stage = blk % kStages;
    barrier_wait(&ring.full[stage], (blk / kStages) & 1);
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = s[i];
    sha256_round::block<kWarp>(v, &ring.kw[stage][0][lane]);
    barrier_arrive(&ring.empty[stage]);
    if (blk < live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += v[i];
    }
  }
  if (real) io.store(m, s);
}

// One CTA hashes messages blockIdx.x * 32 + [0, 32) of the wave.
template <class IO>
__device__ __forceinline__ void hash_wave(const IO& io, long long messages, Ring& ring) {
  const int warp = threadIdx.x / kWarp;  // 0: consumer; 1..kProducers: producers
  const int lane = threadIdx.x % kWarp;
  const long long m = (long long)blockIdx.x * kWarp + lane;
  const bool real = m < messages;
  uint32_t live = 0;
  if (real) {
    const uint32_t nb = io.n_blocks[m];
    live = nb < (uint32_t)io.L ? nb : (uint32_t)io.L;
  }
  // Every warp reads the same 32 counts, so all agree on the CTA's length.
  const uint32_t blocks = __reduce_max_sync(0xFFFFFFFFu, live);
  if (blocks == 0) {
    if (warp == 0 && real) {
      uint32_t s[8];
      init_state(s);
      io.store(m, s);
    }
    return;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      barrier_init(&ring.full[i], kWarp);
      barrier_init(&ring.empty[i], kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    consume(io, m, real, live, blocks, lane, ring);
  } else {
    produce(io, m, live, blocks, warp - 1, lane, ring);
  }
}

// blocks [B, L, 16], n_blocks [B] -> out [B, 8]: a row's block is 64
// contiguous bytes, read as four 16-byte loads.
struct BatchIO {
  const uint32_t* __restrict__ blocks;
  const uint32_t* __restrict__ n_blocks;
  uint32_t* __restrict__ out;
  int L;

  __device__ __forceinline__ void load(long long m, uint32_t b, uint32_t (&w)[16]) const {
    const uint4* src = reinterpret_cast<const uint4*>(blocks + (m * L + b) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = src[q];
      w[4 * q + 0] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
  }

  __device__ __forceinline__ void store(long long m, const uint32_t (&s)[8]) const {
    uint4* dst = reinterpret_cast<uint4*>(out + m * 8);
    dst[0] = make_uint4(s[0], s[1], s[2], s[3]);
    dst[1] = make_uint4(s[4], s[5], s[6], s[7]);
  }
};

// blocks [tiles, L, 16, 8, 128], n_blocks [tiles, 1, 8, 128] -> out
// [tiles, 8, 8, 128]: message m is lane m % 1024 of tile m / 1024, and word
// t of a block for 32 neighbouring lanes is 128 contiguous bytes.
struct LanesIO {
  const uint32_t* __restrict__ blocks;
  const uint32_t* __restrict__ n_blocks;
  uint32_t* __restrict__ out;
  int L;

  __device__ __forceinline__ void load(long long m, uint32_t b, uint32_t (&w)[16]) const {
    const long long tile = m / kLanesTile;
    const uint32_t* src =
        blocks + (tile * L + b) * 16 * kLanesTile + (m % kLanesTile);
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = src[t * kLanesTile];
  }

  __device__ __forceinline__ void store(long long m, const uint32_t (&s)[8]) const {
    uint32_t* dst = out + (m / kLanesTile) * 8 * kLanesTile + (m % kLanesTile);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i * kLanesTile] = s[i];
  }
};

__global__ void __launch_bounds__(kThreads)
sha256_lanes_kernel(LanesIO io, long long messages) {
  __shared__ Ring ring;
  hash_wave(io, messages, ring);
}

__global__ void __launch_bounds__(kThreads)
sha256_batch_kernel(BatchIO io, long long rows) {
  __shared__ Ring ring;
  hash_wave(io, rows, ring);
}

unsigned grid_for(long long messages) {
  return (unsigned)((messages + kWarp - 1) / kWarp);
}

}  // namespace

extern "C" int mirbft_sha256_lanes(const void* blocks, const void* n_blocks,
                                   void* out, long long tiles, long long L,
                                   void* stream) {
  const long long messages = tiles * kLanesTile;
  const LanesIO io{(const uint32_t*)blocks, (const uint32_t*)n_blocks, (uint32_t*)out,
                   (int)L};
  sha256_lanes_kernel<<<grid_for(messages), kThreads, 0, (cudaStream_t)stream>>>(
      io, messages);
  return (int)cudaGetLastError();
}

extern "C" int mirbft_sha256_batch(const void* blocks, const void* n_blocks,
                                   void* out, long long rows, long long L,
                                   void* stream) {
  const BatchIO io{(const uint32_t*)blocks, (const uint32_t*)n_blocks, (uint32_t*)out,
                   (int)L};
  sha256_batch_kernel<<<grid_for(rows), kThreads, 0, (cudaStream_t)stream>>>(io, rows);
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
