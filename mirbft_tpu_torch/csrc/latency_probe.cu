// Probes of the integer pipes that bound the SHA-256 kernels of
// csrc/sha256.cu and the Ed25519 kernel of csrc/ed25519.cu, each timed with
// clock64() on one warp:
//
// - chain: a long chain SHF -> LOP3 -> add -> SHF -> ..., each instruction
//   consuming the one before it (the add is an IADD3 or an IMAD, as the
//   compiler picks, like the round's adds).  cycles / links is the mean dependent-issue
//   latency, the factor `chip_smoke.py` puts into each kernel's chain floor;
//   cycles over the global nanosecond timer is the SM clock.  The values
//   differ per thread, so the chain runs on the vector pipes (values the
//   same across a warp would run on the uniform datapath instead).
// - issue: one warp issuing independent instructions of one kind, or of two
//   kinds in turn: cycles per warp instruction, which shows each kind's
//   issue cost and which kinds share a pipe.  The kinds include the wide
//   multiplies of the Ed25519 field multiply (csrc/ed25519_field.cuh):
//   IMAD.WIDE.U32 and IMAD.HI.U32.
// - field: one warp running a chain of dependent Ed25519 field operations
//   (csrc/ed25519_field.cuh), fe_mul, fe_sqr, fe_add or fe_sub, each call
//   taking the last one's result: cycles per call, the latency of one
//   operation in the verify kernel's chain of stages; and two independent
//   fe_mul chains in turn, whose cycles per pair against one chain's per
//   call show whether a multiply is bound by its own latency or by issue.
// - rounds: one warp running the kernels' own round chain
//   (csrc/sha256_round.cuh) on KW in shared memory, block after block,
//   without the ring's barriers or producers: cycles per round of the
//   consumer warp's instruction stream alone, for one message per lane or
//   two interleaved.
//
// - empty: a kernel of one warp that does nothing.  Its time back to back
//   on a stream is the launch floor, the line against which a launch of
//   one short wave (csrc/quorum.cu on the paths) is read.
//
// Measurement tools only: no path of the port launches them.  Plain C
// interface for ctypes, like csrc/sha256.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ed25519_field.cuh"
#include "sha256_round.cuh"

namespace {

constexpr int kUnroll = 64;  // chain links or warp instructions per loop trip
constexpr int kLanes = 8;    // independent accumulators of the issue probe

__constant__ uint32_t kOne = 1;  // opaque to the compiler: x * kOne + y stays an IMAD

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// out[0] cycles, out[1] nanoseconds, out[2] the chain's value (keeps it live).
__global__ void chain_latency_kernel(unsigned long long* out, uint32_t seed,
                                     long long trips) {
  uint32_t x = seed + threadIdx.x;
  const uint32_t y = x * 2654435761u + 1u;
  const uint32_t z = x ^ 0x5BD1E995u;
  __syncwarp();
  const uint64_t ns0 = global_ns();
  const long long c0 = clock64();
  for (long long i = 0; i < trips; ++i) {
#pragma unroll
    for (int j = 0; j < kUnroll / 3; ++j) {
      x = __funnelshift_r(x, x, 7);  // SHF
      x = x ^ (y & ~z) ^ z;          // LOP3
      x = x + y + z;                 // add
    }
  }
  const long long c1 = clock64();
  const uint64_t ns1 = global_ns();
  if (threadIdx.x == 0) {
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = (unsigned long long)(ns1 - ns0);
  }
  atomicXor(reinterpret_cast<unsigned int*>(out + 2), x);
}

// One LOP3 (bit select: x ? y : c), written in PTX so it stays one.
__device__ __forceinline__ uint32_t lop3(uint32_t x, uint32_t y, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(r) : "r"(x), "r"(y), "r"(c));
  return r;
}

// Ops: 0 SHF (funnel shift), 1 LOP3, 2 IADD3, 3 IMAD, then two kinds in
// turn: 4 SHF and LOP3, 5 SHF and IMAD, 6 SHF and IADD3; 7 IMAD.WIDE.U32,
// 8 IMAD.HI.U32.  Each step reads the neighbour accumulator of the step
// before, so no two steps fold into one instruction.  The wide multiplies
// (IMAD.WIDE.U32: a 32 x 32 -> 64-bit product plus a 64-bit addend) work on
// 64-bit accumulators.
template <int kOp>
using Acc = typename std::conditional<(kOp >= 7), uint64_t, uint32_t>::type;

template <int kOp>
__device__ __forceinline__ Acc<kOp> step(Acc<kOp> x, Acc<kOp> y, uint32_t c, int i) {
  if constexpr (kOp == 7) {
    return (uint64_t)(uint32_t)x * kOne + y;
  } else if constexpr (kOp == 8) {
    return __umulhi((uint32_t)x, c) + (uint32_t)y;
  } else {
    const bool even = (i & 1) == 0;
    if (kOp == 0 || (kOp >= 4 && even)) return __funnelshift_r(x, y, 7);
    if (kOp == 1 || kOp == 4) return lop3(x, y, c);
    if (kOp == 2 || kOp == 6) return x + y + c;
    return x * kOne + y;  // 3 and 5
  }
}

template <int kOp>
__global__ void issue_probe_kernel(unsigned long long* out, uint32_t seed, long long trips) {
  Acc<kOp> x[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) x[i] = seed * (2 * i + 1) + threadIdx.x;
  const uint32_t c = (seed + threadIdx.x) ^ 0x9E3779B9u;
  __syncwarp();
  const long long c0 = clock64();
  for (long long n = 0; n < trips; ++n) {
#pragma unroll
    for (int j = 0; j < kUnroll / kLanes; ++j) {
      Acc<kOp> y[kLanes];
#pragma unroll
      for (int i = 0; i < kLanes; ++i) y[i] = step<kOp>(x[i], x[(i + 1) % kLanes], c, i);
#pragma unroll
      for (int i = 0; i < kLanes; ++i) x[i] = y[i];
    }
  }
  __syncwarp();
  const long long c1 = clock64();
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) v ^= x[i];
  if (threadIdx.x == 0) out[0] = (unsigned long long)(c1 - c0);
  atomicXor(reinterpret_cast<unsigned int*>(out + 1), (uint32_t)(v ^ (v >> 32)));
}

// One warp, `blocks` blocks of 64 rounds on one shared KW[64][32], with the
// consumer's state adds, for kMessages messages per lane (their rounds
// interleaved).  out[0] cycles, out[1] a digest word (keeps it live).
template <int kMessages>
__global__ void rounds_probe_kernel(unsigned long long* out, uint32_t seed, long long blocks) {
  __shared__ uint32_t kw[64][32];
  const int lane = threadIdx.x;
  for (int t = 0; t < 64; ++t) kw[t][lane] = (seed + t) * 2654435761u + lane;
  uint32_t s[kMessages][8];
#pragma unroll
  for (int m = 0; m < kMessages; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) s[m][i] = seed ^ (lane + 8 * i + 256 * m);
  __syncwarp();
  const long long c0 = clock64();
  for (long long n = 0; n < blocks; ++n) {
    uint32_t v[kMessages][8];
#pragma unroll
    for (int m = 0; m < kMessages; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) v[m][i] = s[m][i];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      const uint32_t k = kw[t][lane];
#pragma unroll
      for (int m = 0; m < kMessages; ++m) {
        uint32_t* x = v[m];
        sha256_round::round(x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], k + m);
      }
    }
#pragma unroll
    for (int m = 0; m < kMessages; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[m][i] += v[m][i];
  }
  __syncwarp();
  const long long c1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int m = 0; m < kMessages; ++m) x ^= s[m][0];
  if (lane == 0) out[0] = (unsigned long long)(c1 - c0);
  atomicXor(reinterpret_cast<unsigned int*>(out + 1), x);
}

// A chain of `calls` dependent field operations of kind kOp (0 fe_mul, 1
// fe_sqr, 2 fe_add, 3 fe_sub; 4 two independent fe_mul chains in turn, a
// call being one multiply of each) on one warp.  out[0] cycles, out[1] a
// limb of the result (keeps it live).
template <int kOp>
__global__ void field_probe_kernel(unsigned long long* out, uint32_t seed, long long calls) {
  ed25519::Fe a, b, c;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a.v[k] = seed * (2 * k + 1) + threadIdx.x;
    b.v[k] = (seed ^ 0x9E3779B9u) * (k + 3) + threadIdx.x;
    c.v[k] = a.v[k] ^ 0x5BD1E995u;
  }
  __syncwarp();
  const long long c0 = clock64();
  for (long long i = 0; i < calls; ++i) {
    if (kOp == 0 || kOp == 4) a = ed25519::fe_mul(a, b);
    if (kOp == 4) c = ed25519::fe_mul(c, b);
    if (kOp == 1) a = ed25519::fe_sqr(a);
    if (kOp == 2) a = ed25519::fe_add(a, b);
    if (kOp == 3) a = ed25519::fe_sub(a, b);
  }
  __syncwarp();
  const long long c1 = clock64();
  if (threadIdx.x == 0) out[0] = (unsigned long long)(c1 - c0);
  atomicXor(reinterpret_cast<unsigned int*>(out + 1), a.v[0] ^ a.v[7] ^ c.v[1]);
}

}  // namespace

// Links of the chain that one chain launch runs per trip.
extern "C" long long mirbft_chain_links_per_trip() { return kUnroll / 3 * 3; }

// Warp instructions that one issue-probe launch runs per trip.
extern "C" long long mirbft_issue_per_trip() { return kUnroll; }

extern "C" int mirbft_chain_latency(void* out, long long seed, long long trips,
                                    void* stream) {
  chain_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)out, (uint32_t)seed, trips);
  return (int)cudaGetLastError();
}

extern "C" int mirbft_issue_probe(void* out, long long op, long long seed, long long trips,
                                  void* stream) {
  auto* o = (unsigned long long*)out;
  auto s = (cudaStream_t)stream;
  switch (op) {
    case 0: issue_probe_kernel<0><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 1: issue_probe_kernel<1><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 2: issue_probe_kernel<2><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 3: issue_probe_kernel<3><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 4: issue_probe_kernel<4><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 5: issue_probe_kernel<5><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 6: issue_probe_kernel<6><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 7: issue_probe_kernel<7><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    case 8: issue_probe_kernel<8><<<1, 32, 0, s>>>(o, (uint32_t)seed, trips); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mirbft_rounds_probe(void* out, long long messages_per_lane, long long seed,
                                   long long blocks, void* stream) {
  auto* o = (unsigned long long*)out;
  auto s = (cudaStream_t)stream;
  switch (messages_per_lane) {
    case 1: rounds_probe_kernel<1><<<1, 32, 0, s>>>(o, (uint32_t)seed, blocks); break;
    case 2: rounds_probe_kernel<2><<<1, 32, 0, s>>>(o, (uint32_t)seed, blocks); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mirbft_field_probe(void* out, long long op, long long seed, long long calls,
                                  void* stream) {
  auto* o = (unsigned long long*)out;
  auto s = (cudaStream_t)stream;
  switch (op) {
    case 0: field_probe_kernel<0><<<1, 32, 0, s>>>(o, (uint32_t)seed, calls); break;
    case 1: field_probe_kernel<1><<<1, 32, 0, s>>>(o, (uint32_t)seed, calls); break;
    case 2: field_probe_kernel<2><<<1, 32, 0, s>>>(o, (uint32_t)seed, calls); break;
    case 3: field_probe_kernel<3><<<1, 32, 0, s>>>(o, (uint32_t)seed, calls); break;
    case 4: field_probe_kernel<4><<<1, 32, 0, s>>>(o, (uint32_t)seed, calls); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

extern "C" int mirbft_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
