#!/usr/bin/env python3
"""Time designs of the mesh count (one shard's mismatched digests or
rejected real rows, one launch) against the port's own, in one process on
one card.

    python3 ab_mesh_count.py

The port's kernel is ``csrc/mesh.cu`` through ``parallel.shard_count``
(blocks of 256 threads, one a 256 rows, up to 528; several blocks meet
through a 64-bit ticket word).  The other designs are built from
``VARIANTS_CU`` below with the port's nvcc flags: the same per-row work and
block reduction, then
- ``ticket<T>``: blocks of T threads (256, 512, 1024) and a chosen block
  count, the same ticket word;
- ``cluster<T>``: one thread-block cluster of the chosen block count (512
  or 1,024 threads a block), each
  block's sum stored into block 0's shared memory (distributed shared
  memory), one cluster barrier, block 0 stores the count;
- ``empty``: an empty kernel, the launch floor.
Shapes: 1,024 verdict rows (the mesh paths' shard), 4,096 digest rows (the
long wave's shard) and 64 rows of each.  Every launch's count must equal
the plain version's.  Two times per design and shape, in ms: ``b2b``, 50
launches back to back behind a spin kernel (``crossover.time_cuda``'s
method), and ``after_spin``, the median of 30 launches each bracketed by
CUDA events right after a spin kernel (a count after a verify kernel, as
the paths run it).  One ``ab ...`` line each; ``chiprun_out/ab_mesh_count.json``
holds the rows.  Exits nonzero without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

VARIANTS_CU = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
namespace cg = cooperative_groups;

struct A { int mode; const uint32_t* w; const uint32_t* e; uint8_t* ok; const uint8_t* valid; const uint8_t* real; long long rows; uint32_t* count; unsigned long long* acc; };

__device__ __forceinline__ uint32_t row_flag(const A& a, long long i) {
  if (a.mode == 0) {
    const uint4* w = reinterpret_cast<const uint4*>(a.w + i * 8);
    const uint4* e = reinterpret_cast<const uint4*>(a.e + i * 8);
    uint4 u0 = w[0], u1 = w[1], v0 = e[0], v1 = e[1];
    return ((u0.x ^ v0.x) | (u0.y ^ v0.y) | (u0.z ^ v0.z) | (u0.w ^ v0.w) | (u1.x ^ v1.x) | (u1.y ^ v1.y) | (u1.z ^ v1.z) | (u1.w ^ v1.w)) != 0u;
  }
  const uint32_t ok = (a.ok[i] != 0) & (a.valid[i] != 0);
  a.ok[i] = (uint8_t)ok;
  return (uint32_t)(a.real[i] != 0) & (ok ^ 1u);
}
__device__ __forceinline__ uint32_t warp_sum(uint32_t n) {
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  return n;
}
template <int T>
__device__ __forceinline__ uint32_t block_sum(uint32_t n) {
  __shared__ uint32_t ws[T / 32];
  n = warp_sum(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) ws[warp] = n;
  __syncthreads();
  uint32_t b = 0;
  if (warp == 0) b = warp_sum(lane < T / 32 ? ws[lane] : 0u);
  return b;
}
template <int T>
__global__ void __launch_bounds__(T) k_ticket(const A a) {
  const long long stride = (long long)gridDim.x * T;
  uint32_t n = 0;
  for (long long i = (long long)blockIdx.x * T + threadIdx.x; i < a.rows; i += stride) n += row_flag(a, i);
  const uint32_t b = block_sum<T>(n);
  if (threadIdx.x == 0) {
    if (gridDim.x == 1) { *a.count = b; return; }
    const unsigned long long before = atomicAdd(a.acc, (1ull << 32) | b);
    if ((long long)(before >> 32) == gridDim.x - 1) { *a.count = (uint32_t)before + b; *a.acc = 0ull; }
  }
}
template <int T>
__global__ void __launch_bounds__(T) k_cluster(const A a) {
  __shared__ uint32_t partials[16];
  cg::cluster_group cluster = cg::this_cluster();
  const long long stride = (long long)gridDim.x * T;
  uint32_t n = 0;
  for (long long i = (long long)blockIdx.x * T + threadIdx.x; i < a.rows; i += stride) n += row_flag(a, i);
  const uint32_t b = block_sum<T>(n);
  const unsigned rank = cluster.block_rank();
  if (threadIdx.x == 0) {
    uint32_t* dst = cluster.map_shared_rank(partials, 0);
    dst[rank] = b;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    uint32_t t = 0;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) t += partials[r];
    *a.count = t;
  }
}
__global__ void k_empty() {}

extern "C" int launch(int variant, int mode, const void* w, const void* e, void* ok, const void* valid, const void* real, long long rows, void* count, void* acc, int blocks, void* stream) {
  A a{mode, (const uint32_t*)w, (const uint32_t*)e, (uint8_t*)ok, (const uint8_t*)valid, (const uint8_t*)real, rows, (uint32_t*)count, (unsigned long long*)acc};
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: k_empty<<<1, 32, 0, s>>>(); break;
    case 1: k_ticket<256><<<blocks, 256, 0, s>>>(a); break;
    case 2: k_ticket<512><<<blocks, 512, 0, s>>>(a); break;
    case 3: k_ticket<1024><<<blocks, 1024, 0, s>>>(a); break;
    case 5: case 6: {
      cudaLaunchConfig_t c = {};
      c.gridDim = dim3(blocks); c.stream = s;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = blocks; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
      c.attrs = at; c.numAttrs = 1;
      if (variant == 5) { c.blockDim = dim3(512); return (int)cudaLaunchKernelEx(&c, k_cluster<512>, a); }
      c.blockDim = dim3(1024); return (int)cudaLaunchKernelEx(&c, k_cluster<1024>, a);
    }
  }
  return (int)cudaGetLastError();
}
"""

VARIANTS = {1: ("ticket256", 256), 2: ("ticket512", 512), 3: ("ticket1024", 1024),
            5: ("cluster512", 512), 6: ("cluster1024", 1024)}
SHAPES = (("verdicts", 1024), ("digests", 4096), ("digests", 64), ("verdicts", 64))


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_mesh_count: no CUDA device", file=sys.stderr)
        return 1
    from mirbft_tpu_torch.ops import _build
    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.parallel import shard_count, shard_count_torch

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    source = os.path.join(_build.BUILD_DIR, "ab_mesh_count.cu")
    library = os.path.join(_build.BUILD_DIR, "ab_mesh_count.so")
    with open(source, "w") as f:
        f.write(VARIANTS_CU)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    "-o", library, source], check=True, capture_output=True)
    lib = ctypes.CDLL(library)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.launch.argtypes = (ctypes.c_int, ctypes.c_int, p, p, p, p, p, i64, p, p, ctypes.c_int, p)
    lib.launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"ab_mesh_count: {smi}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    acc = torch.zeros(1, dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def case(mode, rows):
        if mode == "digests":
            words = rng.integers(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)
            expected = words.copy()
            expected[rng.random(rows) < 0.3, 0] ^= 1
            return [torch.from_numpy(a.view(np.int32)).to(dev) for a in (words, expected)]
        return [torch.from_numpy(rng.random(rows) < q).to(dev) for q in (0.6, 0.8, 0.7)]

    def pointers(mode, t):
        ptrs = [x.data_ptr() for x in t]
        return ptrs + [None] * 3 if mode == "digests" else [None, None] + ptrs

    def variant(v, mode, t, rows, blocks):
        def go():
            code = lib.launch(v, 0 if mode == "digests" else 1, *pointers(mode, t), rows,
                              count.data_ptr(), acc.data_ptr(), blocks, stream)
            if code:
                raise RuntimeError(f"variant {v} with {blocks} blocks: cuda error {code}")
        return go

    def after_spin(fn, n=30):
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(200_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    rows_out = []

    def report(name, mode, rows, blocks, fn):
        b2b = time_cuda(fn, repeats=50) * 1e3
        after = after_spin(fn)
        rows_out.append({"design": name, "mode": mode, "rows": rows, "blocks": blocks,
                         "b2b_ms": b2b, "after_spin_ms": after})
        print(f"ab {mode} rows={rows} {name} blocks={blocks} b2b_ms={b2b:.6f} "
              f"after_spin_ms={after:.6f}", flush=True)

    report("empty", "-", 0, 1, variant(0, "digests", case("digests", 1), 0, 1))
    for mode, rows in SHAPES:
        t = case(mode, rows)
        want = int(shard_count_torch(mode, *(x.clone() for x in t)))
        got = int(shard_count(mode, *(x.clone() if k == 0 else x for k, x in enumerate(t))))
        if got != want:
            raise AssertionError(f"port {mode} rows={rows}: {got} != plain {want}")
        report("port", mode, rows, -(-rows // 256), lambda: shard_count(mode, *t))
        for v, (name, threads) in VARIANTS.items():
            cap = 8
            for blocks in sorted({1, 2, 4, 8, -(-rows // threads)}):
                if blocks > cap or (blocks > 1 and blocks * threads > 2 * max(rows, threads)):
                    continue
                fresh = [x.clone() if k == 0 else x for k, x in enumerate(t)]
                variant(v, mode, fresh, rows, blocks)()
                if int(count.item()) != want:
                    raise AssertionError(f"{name} {mode} rows={rows} blocks={blocks}: "
                                         f"{int(count.item())} != plain {want}")
                report(name, mode, rows, blocks, variant(v, mode, t, rows, blocks))
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "ab_mesh_count.json"), "w") as f:
        json.dump({"device": smi, "rows": rows_out}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
