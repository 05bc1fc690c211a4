#!/usr/bin/env python3
"""Time the Ed25519 verify kernel of csrc/ed25519.cu against that of another
source, in one process on one card, in turns.

    python3 ab_ed25519.py OTHER.cu [OTHER_SERIAL_MULS]

OTHER.cu (e.g. an earlier revision of csrc/ed25519.cu) must export
``mirbft_ed25519_verify`` with the same signature; it builds with the port's
nvcc flags beside the port's own library (``_build.other_library``).
OTHER_SERIAL_MULS is the number of field multiplies one thread of OTHER.cu
runs in series for a signature, for its cycles per multiply (default 4,375,
every multiply of a signature: a kernel with one thread per signature).

The waves are the verify waves the signed paths of ``chip_smoke.py`` launch
(c2_signed's 1,024 rows and 4n_signed_corrupt's 16, captured from one device
run of each) and its ``VERIFY_BATCHES``, drawn from its signed pool (RFC 8032
vectors, signatures, tampered rows, small-order keys, padding).  At each wave
both launchers run on the same device inputs, in the order other, this, this,
other (CUDA events, ``crossover.time_cuda``), and their outputs must be equal
bit for bit.  One ``ab ...`` line per wave gives both pairs of times, the
speedup of the means, each side's cycles per multiply (ms x SM clock / serial
multiplies), the bound and this side's share of it (as ``chip_smoke.py``
computes them); ``chiprun_out/ab_ed25519.json`` holds the same rows.  Exits
nonzero without a card.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ONE_THREAD_SERIAL_MULS = 4375


def path_waves():
    """[(path, packed arrays)]: each verify wave shape that one device run of
    each signed chip_smoke path launches."""
    import chip_smoke
    from mirbft_tpu_torch.testengine import CryptoConfig, Spec

    paths = [
        ("c2_signed", chip_smoke.C2, dict(chip_smoke.C2_PLANE, kernel="auto"), None),
        ("4n_signed_corrupt", chip_smoke.SMALL_SIGNED,
         dict(chip_smoke.SMALL_SIGNED_PLANE, kernel="auto"), chip_smoke.corrupt_signer),
    ]
    waves = []
    for name, shape, crypto, tweak in paths:
        with chip_smoke.VerifyLog() as log_:
            chip_smoke.run_spec(Spec(**shape, tweak_recorder=tweak, crypto=CryptoConfig(
                **crypto, torch_device=chip_smoke.DEVICE)))
        for _, (_, packed) in sorted(log_.inputs.items()):
            waves.append((name, packed))
    return waves


def pool_waves():
    """[(where, packed arrays)]: one wave at each of chip_smoke's
    VERIFY_BATCHES, the RFC vectors and padding rows first."""
    import numpy as np

    import chip_smoke
    from mirbft_tpu_torch.ops import ed25519 as e

    rng = np.random.default_rng(chip_smoke.SEED + 1)
    pubs, msgs, sigs, _ = chip_smoke.signed_pool(rng)
    pad = 16
    arrays = e.Ed25519BatchVerifier(min_device_batch=1, device=chip_smoke.DEVICE).pack_inputs(
        pubs, msgs, sigs, batch=len(pubs) + pad)
    waves = []
    for batch in chip_smoke.VERIFY_BATCHES:
        pick = rng.integers(0, len(pubs) + pad, size=batch)
        lead = np.concatenate([np.arange(3), len(pubs) + np.arange(pad)])[:batch]
        pick[: len(lead)] = lead
        waves.append((f"batch{batch}", tuple(np.ascontiguousarray(a[pick]) for a in arrays)))
    return waves


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("ab_ed25519: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mirbft_tpu_torch.ops import _build
    from mirbft_tpu_torch.ops.crossover import time_cuda

    serial = {"other": int(argv[2]) if len(argv) == 3 else ONE_THREAD_SERIAL_MULS,
              "this": chip_smoke.VERIFY_SERIAL_MULS}
    smi = chip_smoke.nvidia_smi_line()
    libs = {"other": _build.other_library("ed25519", argv[1]),
            "this": _build.library("ed25519")}
    print(f"build {argv[1]}: {_build.ptxas_report('ed25519', argv[1]).strip()}", flush=True)
    print(f"build this: {_build.ptxas_report('ed25519').strip()}", flush=True)
    hz = chip_smoke.sm_clock_hz()
    print(f"ab: other={argv[1]} ({serial['other']} serial multiplies) "
          f"this=mirbft_tpu_torch/csrc/ed25519.cu ({serial['this']}) "
          f"sm_clock_mhz={hz / 1e6:.0f} | {smi}", flush=True)

    rows_out = []
    for where, packed in path_waves() + pool_waves():
        inputs = [torch.from_numpy(a).to(chip_smoke.DEVICE) for a in packed[:5]]
        rows = inputs[0].shape[0]
        outs = {side: torch.empty(rows, dtype=torch.uint8, device=inputs[0].device)
                for side in libs}

        def launch(side):
            code = libs[side].mirbft_ed25519_verify(
                *(t.data_ptr() for t in inputs), rows, outs[side].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            _build.check(libs[side], code, "ed25519_verify")

        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            times[side].append(time_cuda(lambda: launch(side), repeats=5) * 1e3)
        torch.cuda.synchronize()
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"{where} rows={rows}: outputs differ")
        mean = {side: sum(t) / len(t) for side, t in times.items()}
        cycles = {side: mean[side] * 1e-3 * hz / serial[side] for side in libs}
        bound_ms, by = chip_smoke.verify_bound(rows, hz)
        row = {
            "where": where, "rows": rows, "valid_rows": int(packed[5].sum()),
            "verified": int(outs["this"].sum()),
            "other_ms": times["other"], "this_ms": times["this"],
            "speedup": mean["other"] / mean["this"],
            "other_cycles_per_mul": cycles["other"], "this_cycles_per_mul": cycles["this"],
            "bound_ms": bound_ms, "bound_by": by, "this_of_bound": bound_ms / mean["this"],
        }
        rows_out.append(row)
        print(f"ab {where} ed25519_verify rows={rows} verified={row['verified']} "
              f"other_ms={[round(t, 6) for t in times['other']]} "
              f"this_ms={[round(t, 6) for t in times['this']]} speedup={row['speedup']:.3f} "
              f"cycles_per_mul other={cycles['other']:.1f} this={cycles['this']:.1f} "
              f"bound_ms={bound_ms:.6f} ({by}) this_of_bound={row['this_of_bound']:.4f}",
              flush=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab_ed25519.json"), "w") as fh:
        json.dump({"device": smi, "sm_clock_hz": hz, "other": argv[1],
                   "serial_muls": serial, "rows": rows_out}, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
