#!/usr/bin/env python3
"""Where one launch of the quorum kernel spends its cycles, by stage.

    python3 quorum_stages.py

Writes a copy of mirbft_tpu_torch/csrc/quorum.cu with clock64() stamps into
mirbft_tpu_torch/_build/stages/ (git-ignored): thread 0 stamps the first
chunk at each of its stage barriers, and threads 0 and 31 stamp their first
touch inside stage 1 (its own loads back, the row lookup issued, its row
back, its gate and stores done).  It builds the copy beside the port's
library (``_build.other_library``), runs each stream below three times on
the card and prints the last launch's cycles per stage.  A stamp is one
global store by one thread, so the copy runs a little slower than the
kernel; read the stages against each other, and the kernel's own time in
``chip_smoke.py`` or ``ab_quorum.py``.  Exits nonzero without a card.
"""

from __future__ import annotations

import ctypes
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (W, D, N, K, gated): chip_smoke's streams, the paths' shape, one touch a
# wave, and two streams with no gated touch.
STREAMS = ((256, 4, 1, 8, True), (4096, 4, 8, 8, True), (4096, 4, 64, 8, True),
           (4096, 4, 64, 40, True), (4096, 4, 64, 1, True), (8192, 4, 64, 8, True),
           (4096, 4, 64, 8, False), (4096, 4, 64, 40, False))
BARRIERS = ("stage 1", "resolve", "group", "scan", "write-back")
INSIDE = ("own loads", "row lookup", "row back", "gate and stores")


def instrumented(source: str) -> str:
    """``source`` with the stamps; every anchor must be found."""
    def sub(text, old, new):
        if old not in text:
            raise AssertionError(f"quorum_stages: anchor not found: {old[:60]!r}")
        return text.replace(old, new, 1)

    stamp = "if (tid == 0 && n0 == 0) g_stamps[{}] = clock64();"
    s = sub(source, "namespace quorum {\n", "__device__ long long g_stamps[64];\nnamespace quorum {\n")
    s = sub(s, """  const uint32_t k = (uint32_t)s.K;
  const long long t = n0 * s.K + i;
  const bool valid = s.valid[t];""", """#ifdef __CUDA_ARCH__
  const bool probe = (threadIdx.x == 0 || threadIdx.x == 31) && n0 == 0 && i < 32;
  const int pb = threadIdx.x == 0 ? 16 : 24;
  const long long c0 = clock64();
#endif
  const uint32_t k = (uint32_t)s.K;
  const long long t = n0 * s.K + i;
  const bool valid = s.valid[t];""")
    s = sub(s, "  uint32_t words[kMaskWords], row[8], claim[8];", """#ifdef __CUDA_ARCH__
  asm volatile("" ::"r"(key), "r"(src), "r"((int)valid), "r"(dr));
  const long long c1 = clock64();
#endif
  uint32_t words[kMaskWords], row[8], claim[8];""")
    s = sub(s, """    found = insert_key(tb, key, i);
  }""", """    found = insert_key(tb, key, i);
  }
#ifdef __CUDA_ARCH__
  asm volatile("" ::"r"(found));
  const long long c2 = clock64();
  asm volatile("" ::"r"(words[0]), "r"(words[7]), "r"(count));
  const long long c3 = clock64();
#endif""")
    s = sub(s, "  return ok && in_range;\n}", """#ifdef __CUDA_ARCH__
  const long long c4 = clock64();
  if (probe) {
    g_stamps[pb] = c0, g_stamps[pb + 1] = c1, g_stamps[pb + 2] = c2;
    g_stamps[pb + 3] = c3, g_stamps[pb + 4] = c4;
  }
#endif
  return ok && in_range;
}""")
    head, body = s.split("quorum_accumulate_kernel(const quorum::Stream s, const quorum::Plan p) {", 1)
    body = sub(body, "    if (!tb.direct) {", stamp.format(0) + "\n    if (!tb.direct) {")
    body = sub(body, "    if (!__syncthreads_or(writes)) {",
               "    const bool any = __syncthreads_or(writes);\n    " + stamp.format(1)
               + "\n    if (!any) {")
    body = sub(body, "quorum::resolve_touch(tb, i);\n    __syncthreads();",
               "quorum::resolve_touch(tb, i);\n    __syncthreads();\n    " + stamp.format(2))
    body = sub(body, "quorum::group_touch(tb, k, i);\n      __syncthreads();",
               "quorum::group_touch(tb, k, i);\n      __syncthreads();\n      " + stamp.format(3))
    body = sub(body, "    } else if (tid < scan_threads) {\n",
               "    } else if (tid < scan_threads) {\n      " + stamp.format(3) + "\n")
    body = sub(body, "      block_scan(tb, k, touches, scan_threads);\n    }\n    __syncthreads();",
               "      block_scan(tb, k, touches, scan_threads);\n    }\n    __syncthreads();\n    "
               + stamp.format(4))
    body = sub(body, "    if (n1 < s.N) __syncthreads();\n  }\n}",
               "    __syncthreads();\n    " + stamp.format(5) + "\n  }\n}")
    s = head + "quorum_accumulate_kernel(const quorum::Stream s, const quorum::Plan p) {" + body
    return sub(s, 'extern "C" const char* mirbft_cuda_error_string(int code) {',
               'extern "C" int mirbft_quorum_stamps(void* out) {\n'
               "  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * 64);\n}\n\n"
               'extern "C" const char* mirbft_cuda_error_string(int code) {')


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("quorum_stages: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mirbft_tpu_torch.ops import _build
    from mirbft_tpu_torch.ops.quorum import launch_plan

    folder = os.path.join(_build.BUILD_DIR, "stages")
    os.makedirs(folder, exist_ok=True)
    source = os.path.join(folder, "quorum.cu")
    with open(os.path.join(_build.CSRC, "quorum.cu")) as fh:
        text = instrumented(fh.read())
    with open(source, "w") as fh:
        fh.write(text)
    lib = _build.other_library("quorum", source)
    lib.mirbft_quorum_stamps.argtypes = [ctypes.c_void_p]
    print(f"stages: {chip_smoke.nvidia_smi_line()} sm_clock_mhz="
          f"{chip_smoke.sm_clock_hz() / 1e6:.0f}", flush=True)
    rng = np.random.default_rng(chip_smoke.SEED + 6)
    for w, d, n, k, gated in STREAMS:
        arrays = chip_smoke.gated_stream(rng, w, d, n, k)
        if not gated:
            arrays[7][:] = -1  # digest_rows: no touch gated
        t = chip_smoke.as_tensors(arrays, "cuda")
        posts = torch.empty((n, k), dtype=torch.int32, device="cuda")
        newbits = torch.empty((n, k), dtype=torch.bool, device="cuda")
        stamps = np.zeros(64, dtype=np.int64)
        for _ in range(3):
            masks, counts = t[0].clone(), t[1].clone()
            code = lib.mirbft_quorum_accumulate(
                masks.data_ptr(), counts.data_ptr(), w, d, t[2].data_ptr(), t[3].data_ptr(),
                t[4].data_ptr(), n, k, t[5].data_ptr(), t[5].shape[0], t[6].data_ptr(),
                t[6].shape[0], *(x.data_ptr() for x in t[7:]), posts.data_ptr(),
                newbits.data_ptr(), torch.cuda.current_stream().cuda_stream)
            _build.check(lib, code, "quorum_accumulate (stamped)")
            torch.cuda.synchronize()
        _build.check(lib, lib.mirbft_quorum_stamps(stamps.ctypes.data), "stamps")
        plan = launch_plan(w, d, n, k)
        bar = stamps[:6]
        stages = " ".join(f"{name.replace(' ', '_')}={bar[j + 1] - bar[j]}"
                          for j, name in enumerate(BARRIERS))
        print(f"stages (W, D, N, K)={(w, d, n, k)} {'gated' if gated else 'ungated'} "
              f"entries_by={'direct_map' if plan['map_rows'] else 'hash_table'} "
              f"chunks={plan['chunks']} cycles: {stages} first_chunk={bar[5] - bar[0]} "
              f"scan_per_wave={(bar[4] - bar[3]) / min(n, plan['chunk_waves']):.1f}", flush=True)
        for base, who in ((16, "thread 0"), (24, "thread 31")):
            c = stamps[base:base + 5]
            print("  stage 1, " + who + ": " + " ".join(
                f"{name.replace(' ', '_')}={c[j + 1] - c[j]}" for j, name in enumerate(INSIDE)),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
