#!/usr/bin/env python3
"""Time the SHA-256 kernels of csrc/sha256.cu against those of another
source, in one process on one card, in turns.

    python3 ab_sha256.py OTHER.cu   # e.g. an earlier revision of csrc/sha256.cu

OTHER.cu must export the same launchers with the same signatures
(``mirbft_sha256_batch``, ``mirbft_sha256_lanes``); it builds with the
port's nvcc flags beside the port's own library (``_build.other_library``).
The waves are those the paths of ``chip_smoke.py`` launch (c3 on kernel="auto" and the two pinned
4-node paths, captured from one device run of each) and its 18 ladder
shapes.  At each wave both launchers run on the same device inputs, in the
order other, this, this, other (CUDA events, ``crossover.time_cuda``), and
their outputs must be equal bit for bit.  One ``ab ...`` line per wave and
kernel gives both pairs of times, the speedup of the means, each side's
cycles per round, the bound and the chain floor (as ``chip_smoke.py``
computes them); ``chiprun_out/ab_sha256.json`` holds the same rows.  Exits
nonzero without a card.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def path_waves():
    """[(path, layout, blocks, n_blocks)]: one wave of each shape that one
    device run of each chip_smoke path launches."""
    import chip_smoke
    from mirbft_tpu_torch.testengine import CryptoConfig, Spec

    paths = [
        ("c3_auto", chip_smoke.C3, dict(chip_smoke.C3_PLANE, kernel="auto")),
        ("4n_lanes", chip_smoke.SMALL, dict(chip_smoke.SMALL_PLANE, kernel="lanes")),
        ("4n_scan", chip_smoke.SMALL, dict(chip_smoke.SMALL_PLANE, kernel="scan")),
    ]
    waves = []
    for name, shape, crypto in paths:
        with chip_smoke.WaveLog() as log_:
            chip_smoke.run_spec(
                Spec(**shape, crypto=CryptoConfig(**crypto, torch_device=chip_smoke.DEVICE)))
        for (layout, _), (_, (blocks, n_blocks)) in log_.waves.items():
            waves.append((name, layout, blocks, n_blocks))
    return waves


def launch_into(lib, layout, blocks, n_blocks, out):
    """One launch of ``lib``'s launcher for ``layout`` on the current stream."""
    import torch

    from mirbft_tpu_torch.ops import _build

    fn = "mirbft_sha256_lanes" if layout == "lanes" else "mirbft_sha256_batch"
    code = getattr(lib, fn)(
        blocks.data_ptr(), n_blocks.data_ptr(), out.data_ptr(), blocks.shape[0],
        blocks.shape[1], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, fn)


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_sha256: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mirbft_tpu_torch.ops import _build
    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.ops.latency_probe import dependent_issue_latency
    from mirbft_tpu_torch.ops.sha256 import wave_to_torch

    smi = chip_smoke.nvidia_smi_line()
    libs = {"other": _build.other_library("sha256", argv[1]), "this": _build.library("sha256")}
    print(f"build {argv[1]}: {_build.ptxas_report('sha256', argv[1]).strip()}", flush=True)
    clock = (chip_smoke.sm_clock_hz(), dependent_issue_latency()[0])
    print(f"ab: other={argv[1]} this=mirbft_tpu_torch/csrc/sha256.cu "
          f"sm_clock_mhz={clock[0] / 1e6:.0f} dependent_issue_latency_cycles={clock[1]:.4f} "
          f"| {smi}", flush=True)

    rng = np.random.default_rng(chip_smoke.SEED)
    waves = path_waves()
    for layout in ("batch", "lanes"):
        for wave in chip_smoke.WAVES:
            for L in chip_smoke.LADDER:
                _, blocks, n_blocks = chip_smoke.ragged_wave(rng, wave, L, layout)
                waves.append((f"ladder{wave}", layout, blocks, n_blocks))

    rows = []
    for where, layout, blocks, n_blocks in waves:
        bt, nt = wave_to_torch(blocks, n_blocks, chip_smoke.DEVICE)
        count, L = bt.shape[0], bt.shape[1]
        out_shape = (count, 8, 8, 128) if layout == "lanes" else (count, 8)
        outs = {side: torch.empty(out_shape, dtype=torch.int32, device=bt.device)
                for side in libs}
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            times[side].append(time_cuda(
                lambda: launch_into(libs[side], layout, bt, nt, outs[side])) * 1e3)
        torch.cuda.synchronize()
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"{where} {layout} {list(bt.shape)}: outputs differ")
        mean = {side: sum(t) / len(t) for side, t in times.items()}
        bound_ms, by = chip_smoke.bound_of(n_blocks, L, outs["this"].numel())
        cycles = {side: chip_smoke.chain_of(mean[side], n_blocks, L, clock)[0] for side in libs}
        floor_ms = chip_smoke.chain_of(mean["this"], n_blocks, L, clock)[1]
        row = {
            "where": where, "kernel": f"sha256_{layout}", "shape": list(bt.shape),
            "longest": int(np.minimum(n_blocks, L).max()),
            "other_ms": times["other"], "this_ms": times["this"],
            "speedup": mean["other"] / mean["this"],
            "other_cycles_per_round": cycles["other"], "this_cycles_per_round": cycles["this"],
            "bound_ms": bound_ms, "bound_by": by, "chain_floor_ms": floor_ms,
        }
        rows.append(row)
        print(f"ab {where} {row['kernel']} shape={row['shape']} longest={row['longest']} "
              f"other_ms={[round(t, 6) for t in times['other']]} "
              f"this_ms={[round(t, 6) for t in times['this']]} speedup={row['speedup']:.3f} "
              f"cycles_per_round other={cycles['other']:.2f} this={cycles['this']:.2f} "
              f"bound_ms={bound_ms:.6f} ({by}) chain_floor_ms={floor_ms:.6f}", flush=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab_sha256.json"), "w") as fh:
        json.dump({"device": smi, "sm_clock_hz": clock[0],
                   "dependent_issue_latency_cycles": clock[1], "rows": rows}, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
