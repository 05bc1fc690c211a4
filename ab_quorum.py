#!/usr/bin/env python3
"""Time the quorum accumulate kernel of csrc/quorum.cu against that of another
source, in one process on one card, in turns.

    python3 ab_quorum.py OTHER.cu

OTHER.cu (e.g. an earlier revision of csrc/quorum.cu) must export
``mirbft_quorum_accumulate`` with the same signature; it builds with the
port's nvcc flags beside the port's own library (``_build.other_library``).

The streams are ``chip_smoke.py``'s ``QUORUM_SHAPES`` and the paths' launch
shape (W = 256, D = 4, one wave of K = 8), each a random gated stream from
``chip_smoke.gated_stream``, and the paths' launch itself: that shape with
every touch invalid and one chained row before 64 digests, as the fused
paths send it.  At each, both launchers first run once on
fresh copies of the same state, and masks, counts, posts and newbits must
be equal bit for bit; then each is timed on its own copy, updated in place
as on a path, in the order other, this, this, other (CUDA events,
``crossover.time_cuda``).  One ``ab ...`` line per stream gives both pairs
of times, the speedup of the means, this side's plan (table capacity,
chunks, shared memory), the bound (as ``chip_smoke.py`` computes it) and an
empty kernel's launch floor; ``chiprun_out/ab_quorum.json`` holds the same
rows.  Exits nonzero without a card.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PATH_SHAPE = (256, 4, 1, 8)


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_quorum: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mirbft_tpu_torch.ops import _build, latency_probe
    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.ops.quorum import launch_plan

    smi = chip_smoke.nvidia_smi_line()
    libs = {"other": _build.other_library("quorum", argv[1]), "this": _build.library("quorum")}
    print(f"build {argv[1]}: {_build.ptxas_report('quorum', argv[1]).strip()}", flush=True)
    print(f"build this: {_build.ptxas_report('quorum').strip()}", flush=True)
    print(f"ab: other={argv[1]} this=mirbft_tpu_torch/csrc/quorum.cu | {smi}", flush=True)

    rng = np.random.default_rng(chip_smoke.SEED + 5)
    rows_out = []
    streams = [(PATH_SHAPE, "path_invalid"), (PATH_SHAPE, "gated"),
               *((shape, "gated") for shape in chip_smoke.QUORUM_SHAPES)]
    for (w, d, n, k), kind in streams:
        if kind == "path_invalid":
            arrays = chip_smoke.gated_stream(rng, w, d, n, k, p=1, b=64)
            arrays[4][:] = False
        else:
            arrays = chip_smoke.gated_stream(rng, w, d, n, k)
        tensors = chip_smoke.as_tensors(arrays, chip_smoke.DEVICE)
        sizes = {"P": tensors[5].shape[0], "B": tensors[6].shape[0]}

        def launch(side, masks, counts, posts, newbits):
            code = libs[side].mirbft_quorum_accumulate(
                masks.data_ptr(), counts.data_ptr(), w, d, tensors[2].data_ptr(),
                tensors[3].data_ptr(), tensors[4].data_ptr(), n, k, tensors[5].data_ptr(),
                sizes["P"], tensors[6].data_ptr(), sizes["B"],
                *(t.data_ptr() for t in tensors[7:]), posts.data_ptr(), newbits.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            _build.check(libs[side], code, "quorum_accumulate")

        def fresh():
            return (tensors[0].clone(), tensors[1].clone(),
                    torch.empty((n, k), dtype=torch.int32, device=tensors[0].device),
                    torch.empty((n, k), dtype=torch.bool, device=tensors[0].device))

        outs = {}
        for side in libs:
            outs[side] = fresh()
            launch(side, *outs[side])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"])):
            raise AssertionError(f"(W, D, N, K)={(w, d, n, k)}: outputs differ")
        state = {side: fresh() for side in libs}
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            times[side].append(time_cuda(lambda: launch(side, *state[side])) * 1e3)
        mean = {side: sum(t) / len(t) for side, t in times.items()}
        bound_ms, by = chip_smoke.quorum_bound(tensors)
        floor_ms = latency_probe.launch_floor_ms()
        plan = launch_plan(w, d, n, k)
        row = {
            "W": w, "D": d, "N": n, "K": k, "stream": kind,
            "newbits": int(outs["this"][3].sum()),
            "other_ms": times["other"], "this_ms": times["this"],
            "speedup": mean["other"] / mean["this"], "bound_ms": bound_ms, "bound_by": by,
            "launch_floor_ms": floor_ms, "plan": plan,
        }
        rows_out.append(row)
        print(f"ab quorum_accumulate (W, D, N, K)={(w, d, n, k)} {kind} newbits={row['newbits']} "
              f"other_ms={[round(t, 6) for t in times['other']]} "
              f"this_ms={[round(t, 6) for t in times['this']]} speedup={row['speedup']:.3f} "
              f"chunks={plan['chunks']} (0: global branch) capacity={plan['capacity']} "
              f"smem_bytes={plan['smem_bytes']} threads={plan['threads']} "
              f"bound_ms={bound_ms:.6f} ({by}) launch_floor_ms={floor_ms:.6f} equal",
              flush=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab_quorum.json"), "w") as fh:
        json.dump({"device": smi, "other": argv[1], "rows": rows_out}, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
