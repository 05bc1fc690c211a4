#!/usr/bin/env python3
"""Split the cycles of the "mxu" Ed25519 verify kernel's field multiply by
phase, on the card.

    python3 mxu_split.py SOURCE.cu [ROWS ...]

SOURCE.cu is ``csrc/ed25519_mxu.cu`` as it stands, or a revision of the
same layout (a block of eight warps for 8 rows, warp s owning row s;
``fe_mul_n`` stages a batch of up to four independent multiplies, syncs,
contracts, syncs and carries), with ``csrc/ed25519_mxu_tile.cuh`` beside it.
``tests/test_torch_ed25519_mxu.py`` checks that every anchor is found in
the current source.

The script inserts ``clock64`` stamps into a copy of it (it fails if an
anchor is missing), builds the copy with the port's nvcc
flags, and launches it on random rows (the kernel is branch free, so the
data changes no time).  Thread 0 of every block adds the cycles since its
previous stamp to one phase of a batch of multiplies (``PHASES``,
shown per multiply), to ``other`` (between two tracked
operations: selects, set-up, freeze) or to ``addsub`` (an add or sub with
its carry round, per add or sub), and separately counts the cycles of
each ladder step and of the whole block.  One ``split`` line a row count
gives those means over every block, the launch's ms by CUDA events, and
the same source's ms without stamps, launched in turns (plain, stamped,
stamped, plain), for what the stamps cost.
``chiprun_out/mxu_split_<source>.json`` holds the same numbers, and
``chiprun_out/mxu_split/<source>.sass`` the SASS of the unstamped build
(``cuobjdump``).  Exits nonzero without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# Phases 1-5 of a batch of multiplies.
PHASES = ("stage", "barrier1", "contract", "barrier2", "carry")

PROFILE = r"""
#ifdef __CUDACC__
__device__ unsigned long long mxu_global[16];
#endif
#ifdef __CUDA_ARCH__
__shared__ unsigned long long mxu_acc[13];
__shared__ long long mxu_last, mxu_step0;
#define MXU_T(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \
  mxu_acc[k] += t_ - mxu_last; mxu_last = clock64(); } } while (0)
#define MXU_COUNT(k, n) do { if (threadIdx.x == 0) mxu_acc[9 + (k)] += (n); } while (0)
#define MXU_STEP_BEGIN() do { if (threadIdx.x == 0) mxu_step0 = clock64(); } while (0)
#define MXU_STEP_END() do { if (threadIdx.x == 0) { mxu_acc[8] += clock64() - mxu_step0; \
  mxu_acc[11] += 1; } } while (0)
#else
#define MXU_T(k)
#define MXU_COUNT(k, n)
#define MXU_STEP_BEGIN()
#define MXU_STEP_END()
#endif
"""

INIT = r"""
#ifdef __CUDA_ARCH__
  long long mxu_start = clock64();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 13; ++i) mxu_acc[i] = 0;
    mxu_last = clock64();
  }
  __syncthreads();
#endif
"""

FLUSH = r"""
#ifdef __CUDA_ARCH__
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 13; ++i) atomicAdd(&mxu_global[i], mxu_acc[i]);
    atomicAdd(&mxu_global[13], (unsigned long long)(clock64() - mxu_start));
    atomicAdd(&mxu_global[14], 1ull);
  }
#endif
"""

READ = r"""
extern "C" int mirbft_mxu_profile(void* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, mxu_global, sizeof(mxu_global));
  if (err == cudaSuccess && reset) {
    unsigned long long zero[16] = {};
    err = cudaMemcpyToSymbol(mxu_global, zero, sizeof(zero));
  }
  return (int)err;
}
"""

# (anchor, replacement): each anchor must occur exactly once.
EDITS = [
    ('#include "ed25519_mxu_tile.cuh"\n', '#include "ed25519_mxu_tile.cuh"\n' + PROFILE),
    ("#endif  // __CUDACC__\n", READ + "#endif  // __CUDACC__\n"),
    ("MXU_CALL void fe_mul_n(C& ctx, int op0, int op1, int op2, int op3) {\n",
     "MXU_CALL void fe_mul_n(C& ctx, int op0, int op1, int op2, int op3) {\n  MXU_T(0);\n"),
    ("  ctx.sync();\n  contract_batch(ctx, N);\n  ctx.sync();\n",
     "  MXU_T(1);\n  ctx.sync();\n  MXU_T(2);\n  contract_batch(ctx, N);\n  MXU_T(3);\n"
     "  ctx.sync();\n  MXU_T(4);\n"),
    ("    for (int i = 0; i < N; ++i) sts(row_of(ctx, ops[i] & 0xff, s), lane, x[i]);\n  });\n}\n",
     "    for (int i = 0; i < N; ++i) sts(row_of(ctx, ops[i] & 0xff, s), lane, x[i]);\n  });\n"
     "  MXU_T(5);\n  MXU_COUNT(0, N);\n  MXU_COUNT(3, 1);\n}\n"),
    ("MXU_CALL void fe_addsub_n(C& ctx, int op0, int op1, int op2, int op3) {\n",
     "MXU_CALL void fe_addsub_n(C& ctx, int op0, int op1, int op2, int op3) {\n  MXU_T(0);\n"),
    ("    for (int i = 0; i < N; ++i) sts(row_of(ctx, ops[i] & 0xff, s), lane, sums[i]);\n"
     "  });\n}\n",
     "    for (int i = 0; i < N; ++i) sts(row_of(ctx, ops[i] & 0xff, s), lane, sums[i]);\n"
     "  });\n"
     "  MXU_T(7);\n  MXU_COUNT(1, N);\n}\n"),
    (re.compile(r"  for \(int bit = 255; bit >= 0; --bit\) (ladder_step\([^\n]*\);)\n"),
     r"  for (int bit = 255; bit >= 0; --bit) {\n    MXU_STEP_BEGIN();\n    \1\n"
     r"    MXU_STEP_END();\n  }\n"),
    ("  DevCtx ctx;\n", "  DevCtx ctx;\n" + INIT),
    ("    if (threadIdx.x % 32 == 0 && first + s < rows) out[first + s] = (uint8_t)ok;\n  });\n",
     "    if (threadIdx.x % 32 == 0 && first + s < rows) out[first + s] = (uint8_t)ok;\n  });\n"
     + FLUSH),
]


def instrument(text: str) -> str:
    """``text`` with the stamps in; raises if an anchor is not found once."""
    for anchor, replacement in EDITS:
        if isinstance(anchor, re.Pattern):
            text, count = anchor.subn(replacement, text)
        else:
            count = text.count(anchor)
            text = text.replace(anchor, replacement)
        if count != 1:
            raise ValueError(f"mxu_split: anchor found {count} times, not once: {anchor!r}")
    return text


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mxu_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mirbft_tpu_torch.ops import _build
    from mirbft_tpu_torch.ops.crossover import time_cuda

    rows_list = [int(r) for r in argv[2:]] or [16, 1024]
    with open(argv[1]) as fh:
        text = fh.read()
    phases = PHASES
    folder = os.path.join(HERE, "chiprun_out", "mxu_split")
    os.makedirs(folder, exist_ok=True)
    stem = os.path.splitext(os.path.basename(argv[1]))[0]
    source = os.path.join(folder, f"{stem}_stamped.cu")
    with open(source, "w") as fh:
        fh.write(instrument(text))
    library = os.path.join(folder, f"lib{stem}_stamped.so")
    headers = os.path.dirname(os.path.abspath(argv[1]))  # ed25519_mxu_tile.cuh
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", headers, "-o", library,
                            source],
                           capture_output=True, text=True)
    print(built.stdout + built.stderr, flush=True)
    if built.returncode:
        return 1
    stamped = ctypes.CDLL(library)
    plain = _build.other_library("ed25519_mxu", argv[1])
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", _build.so_path("ed25519_mxu", argv[1])],
                              capture_output=True, text=True).stdout
        with open(os.path.join(folder, f"{stem}.sass"), "w") as fh:
            fh.write(sass)
    for lib in (stamped, plain):
        lib.mirbft_ed25519_verify_mxu.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.mirbft_ed25519_verify_mxu.restype = ctypes.c_int
    stamped.mirbft_mxu_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    stamped.mirbft_mxu_profile.restype = ctypes.c_int
    smi = chip_smoke.nvidia_smi_line()
    hz = chip_smoke.sm_clock_hz()
    print(f"mxu_split: {argv[1]} sm_clock_mhz={hz / 1e6:.0f} | {smi}",
          flush=True)

    rng = np.random.default_rng(chip_smoke.SEED)
    results = []
    for rows in rows_list:
        inputs = [torch.from_numpy(rng.integers(0, 256, size=(rows, 32)).astype(np.int32)).cuda()
                  for _ in range(3)]
        inputs += [torch.from_numpy(rng.integers(0, 2, size=(rows, 256)).astype(np.int32)).cuda()
                   for _ in range(2)]
        out = torch.empty(rows, dtype=torch.uint8, device="cuda")

        def launch(lib):
            code = lib.mirbft_ed25519_verify_mxu(
                *(t.data_ptr() for t in inputs), rows, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        times = {"plain": [], "stamped": []}
        for side in ("plain", "stamped", "stamped", "plain"):
            times[side].append(time_cuda(lambda: launch(plain if side == "plain" else stamped),
                                         repeats=2) * 1e3)
        torch.cuda.synchronize()
        counters = (ctypes.c_ulonglong * 16)()
        if stamped.mirbft_mxu_profile(ctypes.addressof(counters), 1):
            raise RuntimeError("profile read failed")
        launch(stamped)  # one launch alone: its counters
        torch.cuda.synchronize()
        if stamped.mirbft_mxu_profile(ctypes.addressof(counters), 1):
            raise RuntimeError("profile read failed")
        c = list(counters)
        blocks = c[14]
        muls, addsubs, steps, batches = (c[9] / blocks, c[10] / blocks, c[11] / blocks,
                                         c[12] / blocks)
        per_mul = {p: c[i] / blocks / muls for i, p in enumerate(phases, start=1)}
        row = {
            "rows": rows, "blocks": blocks, "muls_per_block": muls, "batches_per_block": batches,
            "addsubs_per_block": addsubs, "steps_per_block": steps,
            "mul_cycles": per_mul, "mul_cycles_total": sum(per_mul.values()),
            "addsub_cycles": c[7] / blocks / addsubs,
            "other_cycles_per_block": c[0] / blocks,
            "step_cycles": c[8] / blocks / steps,
            "block_cycles": c[13] / blocks,
            "plain_ms": times["plain"], "stamped_ms": times["stamped"],
            "sm_clock_hz": hz,
        }
        results.append(row)
        print(f"split rows={rows} blocks={blocks} multiplies={muls:.0f} batches={batches:.0f} "
              f"addsubs={addsubs:.0f} "
              f"steps={steps:.0f} | cycles per multiply "
              + " ".join(f"{p}={v:.1f}" for p, v in per_mul.items())
              + f" total={row['mul_cycles_total']:.1f} | addsub={row['addsub_cycles']:.1f} "
              f"step={row['step_cycles']:.1f} other_per_block={row['other_cycles_per_block']:.0f} "
              f"block={row['block_cycles']:.0f} | "
              f"plain_ms={[round(t, 6) for t in times['plain']]} "
              f"stamped_ms={[round(t, 6) for t in times['stamped']]} | {smi}", flush=True)
    with open(os.path.join(HERE, "chiprun_out", f"mxu_split_{stem}.json"), "w") as fh:
        json.dump({"device": smi, "source": argv[1], "rows": results},
                  fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
