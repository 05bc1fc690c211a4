#!/usr/bin/env python3
"""Chip smoke for mirbft_tpu_torch: drive the port on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with one H100
    python3 chip_smoke.py --embedded 0.02,0.1 3   # phase 7's threaded nodes alone,
                                                  # 3 runs at each tick, unchecked
    python3 chip_smoke.py --mesh                  # phase 8 alone, over every card
                                                  # of the machine (one or several)
    python3 chip_smoke.py --fused                 # the builds and phase 4 alone
    python3 chip_smoke.py --host-costs            # a staged wave's host costs,
                                                  # unchecked; copy the script into
                                                  # another tree to run it there

Phases (any failure raises, and the script exits nonzero without a result):

1. device   the card's name and power limit (nvidia-smi) and torch's view of
            it; no card, or no port package beside this script -> exit 1.
2. build    every CUDA source of the port, one nvcc each, started together;
            build seconds, the ptxas report (registers, spills, the local
            stack; the quorum kernel must have no spill and no stack; the
            "mxu" verify kernel's registers and stack are printed) and
            each kernel's SASS instruction mix (cuobjdump).  Then
            the SM clock (nvidia-smi, sampled while a spin kernel runs) and
            the integer pipes (csrc/latency_probe.cu): the dependent-issue
            latency, the issue cost of each instruction kind, the SHA-256
            kernels' round chain alone, the latency of each Ed25519
            field operation, the cost of the "mxu" kernel's m16n8k32
            mma.sync on a sub-partition, and of its own K tile.
3. kernels  each kernel at every shape the hash plane gives it (block buckets
            4/16/64, waves of 64/1024/4096, ragged n_blocks including 0 and
            garbage words past every row's last block), at edge shapes (row
            counts that are no multiple of 32, block buckets 1, 128 and 256,
            one live row in 1,024) against its plain PyTorch version on the
            card (exact) and hashlib (a sample of rows); CUDA-event times
            beside the bound, the chain floor and the cycles per round.
            Then the Ed25519 verify kernel at batches 1, 7, 9, 16, 31, 33,
            256, 1,024 and 4,096 drawn from RFC 8032 TEST 1-3, signatures
            by sign_one, tampered R, S, message and key, small-order keys, a
            non-canonical R and all-zero padding rows: bit for bit against
            verify_torch on the card and against verify_one on up to 64
            sampled rows a batch; S >= L unscreened (kernel and twin agree,
            and accept it, which is why the host screens it) and through
            the verifier (rejected).  Then the "mxu" verify kernel
            (csrc/ed25519_mxu.cu: every field multiply's nibble contraction
            on the tensor cores) at the same batches from the same pool,
            bit for bit against verify_torch with _mul_mxu on the card and
            verify_one on up to 64 sampled rows, the vpu kernel's time on
            the same rows beside its own, and the unscreened S >= L rows;
            then the verify probe (both kernels on 256 zero rows, the race
            of the first "auto" resolution) and what "auto" resolves to,
            which every unpinned path's verify waves must then launch.
            Then the quorum kernel (gate and
            accumulate) at the fused bench wave's stream (W = 4,096, D = 4,
            N = 8, K = 8), at N = 64 with K = 8 and 40, at N = 512 with
            K = 40 (20,480 touches: six chunks of the kernel's table) and
            at waves of 4,160 touches (wider than the table: the kernel's
            global branch) and at W = 8,192 (its hash table), each line
            with the table's capacity, chunks
            and shared memory and an empty kernel's launch_floor_ms, on random streams
            with duplicate touches, slots and sources out of range both
            ways, gated rows that match and do not, a chained prev_words
            and group tags with -1: masks, counts, posts and newbits bit
            for bit against its plain version on the card.  And the pack
            kernel (csrc/pack.cu) on staged waves (raw bytes, offsets and
            lengths): the fused bench wave, c3's [64, 64, 16] wave and the
            padding boundaries (lengths 0, 1, 55, 56, 63, 64, 119, 120 and
            640 in one wave), each in both layouts, and the boundary rows
            out of order in a buffer off the 16-byte grid, bit for bit
            against its plain version on the card and the host's
            pack_messages.
4. fused    the fused wave at the bench's width (bench.py's
            bench_fused_pipeline: 4,096 messages of 640 bytes, 4,096 slots,
            4 digest slots, eight one-touch quorum waves): digests against
            hashlib on every row, quorum state against the plain version
            fed the same streams, fused_wave_4096_ms pipelined 20 deep
            (the second of two passes: the first allocates the pinned
            staging buffers, and its time is logged beside; every one of
            the waves' digests against hashlib: each wave's staged buffer
            must stay its own while its copy is in flight) and its
            fused_split line (each part of a dispatch: its
            host time and, by CUDA events, its time on the card); the
            same wave with 1,024 signed rows riding it (a corrupt signer's
            among them), verdicts against verify_torch on the card and
            verify_one on 64 sampled rows; and a two-wave chain (the second
            gated on the first's digests), a partial collect and a full
            one, against host_fused_reference, every lease released.  Last
            one wave with 256 signed rows on a pipeline with
            verify_kernel="mxu": digests, verdicts, posts, newbits and
            quorum state against host_fused_reference, one mxu launch and
            no vpu launch.
5. paths    the main path: the c3 Recording (64 replicas, 64 clients x 100
            requests, batch 100) with the device hash plane on kernel="auto",
            held to the port's host-path run of the same Spec (steps and
            per-node checkpoints), all 6,400 requests committed on every node,
            no divergent checkpoint.  Its runs go host, device, host, so
            the device run sits between two host runs, and one more device run is
            traced with torch.profiler for the card's busy time.  Then two
            4-node Recordings pinned to kernel="lanes" and kernel="scan", each
            held to its host-path run.  The signed paths: c2_signed, bench.py's
            c2py_16n_signed shape (16 replicas, 16 clients x 50 Ed25519-signed
            requests, batch 100, auth_wave 1,024), host, device, device, host,
            all 800 requests committed on every node; and 4n_signed_corrupt
            (4 replicas, 4 x 20 signed requests, client 3 a corrupt signer),
            whose 60 honest requests commit on every node and client 3's on
            none, with at least one corrupt row rejected by the kernel itself;
            and c2_signed_mxu, c2's Recording with its verify waves pinned
            to the "mxu" kernel (MIRBFT_TPU_TORCH_VERIFY_KERNEL=mxu), one
            device run held to c2_signed's host path, its mxu launches
            equal to its verify waves and no vpu verify launch.
            Then the same three through the fused pipeline (fused=True):
            c3_fused, c2_signed_fused (with hash_floor 1, so that c2's 32
            unique digests reach the card at all) and
            4n_signed_corrupt_fused, each device run held to the host-path
            run of its unfused twin, with fused waves launched and the
            signatures that rode fused waves and the auth plane's own waves
            counted.  Every kernel's launch count is set to 0 just before each device
            run and read just after; each run must launch exactly the kernels
            its waves resolve to.
6. fast     the native engine (testengine.FastRecording, _native/
            fastengine.cpp built by g++ beside the nvcc builds) on bench.py's
            fast rows: c3_64n_fast (c3's shape, pipeline=True, the device
            hash mirror: every device digest checked against the engine's)
            host path, device, device, host path and a traced device run;
            c3_64n_fast_auth (device_authoritative: the card produces the
            digests, the engine pauses for them), one device run, which
            must hash no more on the host than the mirror run;
            c2_16n_signed_fast (c2's shape, all 800 verdicts from one verify
            wave of 1,024 rows before the run) host path, device, host path
            and a traced device run (in a process of its own, `chip_smoke.py
            --traced-fast NAME`, as c3_64n_fast's is: in the smoke's process
            torch.profiler dropped fast runs' first device records; a trace
            that lost a launch is taken again, up to three times);
            c2_16n_signed_fast_streaming (verdicts from several lookahead
            waves during the run), one device run; c2_16n_signed_fast_mxu
            (the 1,024-row verdict wave pinned to the "mxu" kernel), one
            device run; and
            4n_signed_corrupt_fast (waves of 16, client 3 corrupt), one
            device run whose corrupt row the kernel rejects.  Each run is
            held to the host-path fingerprint of its Recording path (c3_auto,
            c2_signed, 4n_signed_corrupt) and commits every honest request
            on every node; each device run launches exactly the kernels its
            waves resolve to.  A FastEngineUnsupported or a diverged digest
            fails the smoke: nothing falls back to the Python engine.
7. deploy   the deployment stack.  First the cohost plane
            (groups.cohost.CohostCryptoPlane on the card) at bench.py's
            anatomy shape (bench_cohost_fused: 2 groups x 96 rows of 608
            bytes, one fixed wave of 192, six rounds): digests against
            hashlib and two solo per-group fused pipelines on the same
            rows, one tenant collecting on a thread of its own (every
            thread must see the one default stream), with
            fused_wave_occupancy, groups per wave and both wave times; one
            mux wave carrying both tenants' 1,024 signatures from two auth
            planes (group 0's client 3 a corrupt signer), each group's
            verdicts against verify_torch on the card and every rejection in
            group 0; and a 2-group gated quorum wave against its plain
            version and host_fused_reference.  Then c2_signed's and c3's
            Recordings as two co-hosted groups of one SharedWaveMux, stepped
            in turns, each held to its phase-5 host-path fingerprint with an
            exact launch set.  Then four threaded Nodes in this process
            (durable WAL and request store, TorchHasher and an
            Ed25519BatchVerifier on the card) committing c2's 800 signed
            requests, one proposer thread, batch 100: every node's state
            must hold every request, applied exactly once or carried by a
            checkpoint it state-transferred to (as the reference's stress
            test counts a transferred node), none applied twice, with
            hashlib's batch digests, and the forgery rejected by the kernel
            (at 16 proposer threads and batch 1 both packages' runtimes can
            raise "must never commit during state transfer": node_load.py,
            PERF.md section 7).  Last tools/mirnet.py's cohost
            deployment (2 groups x 4 nodes, 200 requests a group: four host
            processes, each with its own plane built on the card):
            wave_mux_active = 1 on every host, the plane serving its hashes,
            every batch digest of every commits.log recomputed with hashlib;
            then its host twin with per-group CPU hashers; both walls.  At
            mirnet's load the plane launches no wave (every row takes its
            host fast path), so this part puts no kernel work on the card
            and its launches are 0; the device counters are printed.
8. mesh     the device mesh (mirbft_tpu_torch/parallel) over every card of
            the machine: make_mesh (one card more raises), sharded_sha256 at
            c3's wave [64, 64, 16] and at 4,096 rows of 640 bytes against the
            unsharded kernel and hashlib (sampled rows), the verify step with
            0, 1 and 2 corrupted digests, sharded_ed25519_verify at 1,024
            signed rows (the corrupt signer's 64 among them) and 64 padding
            rows (real=False) bit for bit against verify_torch on the card
            with the count of corrupt real rows, and the same with
            kernel="mxu" (one mxu launch a card) against verify_torch with
            _mul_mxu, the count kernel
            (csrc/mesh.cu) against its plain version at 1, 7, 33 and 4,097
            rows with all, none and random rows real or differing, one
            launch and nothing else a count (eight counts under
            torch.profiler: eight mesh_count_kernel records, no memset, at
            one block and at several), each count's time back to back,
            and
            graft_entry.dryrun_multichip.  Then two mesh paths, each held
            to its phase-5 host-path fingerprint with an exact launch set
            and the mesh counters above 0: c2_signed_mesh (c2's Recording
            with mesh_devices set and hash_floor 1, so that hash waves
            cross the mesh too) and c2_16n_signed_fast_mesh (FastRecording,
            whose verify waves cross it).
9. report   the kernels' times at the shapes those runs launched, one JSON
            line {"kernels": [...]}, the nvidia-smi line, and last the JSON
            device line.

Ed25519 bound: one verification is 4,375 field multiplies (12 to set up
the table, 256 x (8 + 8) in the ladder, 265 in the inversion, 2 for the
affine x and y) of 64 + 8 products of 32 x 32 -> 64 bits, two IMAD halves
each, at the IMAD rate (64 lanes per SM per clock: the issue probe of
csrc/latency_probe.cu reads ~2.1 cycles per warp IMAD) and
the sampled SM clock; the byte time moves each row's 2,432 input bytes and
its verdict at the HBM rate.  Every row of a launch runs the full ladder.
The bound counts the work, not how the kernel spreads it.  Beside it,
cycles_per_mul is the launch's time at the sampled SM clock over the 1,295
field multiplies one lane of csrc/ed25519.cu runs in series (four lanes
share a signature's multiplies: one of each formula stage).

"mxu" Ed25519 bound: csrc/ed25519_mxu.cu runs the reference's program, 4,870
field multiplies a row (the uncached addition of 9 multiplies, the
inversion's 506); each multiply's 4,096 nibble products and their two 4-bit
halves (3 integer operations a product) at the INT32 rate, the int8
multiply-adds of its contraction as first tiled (160 K tiles x 4 m16n8k32
MMAs for 16 rows: 163,840 a row) at the dense int8 rate (1,979 TOPS), or
the row's bytes at the HBM rate: the largest (the integer work).  That
counts the function's work, above what the kernel's design issues (one
integer operation a product, over the FMA and ALU pipes); beside it,
design_floor_ms is the design's own floor (mxu_design_floor: a group of 8
rows on one SM, its 256 m16n8k32 a multiply at the mma probe's cycles on
each of the SM's four sub-partitions, or its integer work, the larger).

Quorum bound: the bytes one launch must move (each touch's slot, digest,
valid, gate row, group, post and newbit; a gated touch's 8 claimed words,
its row's 8 digest words and the row's group; each touched mask word and
count read once and, where new, written once; the sources) at the HBM rate,
or its integer operations (~40 a touch) at the INT32 rate, the larger.
Beside it, dependent_launches_ms: the same N waves on the same inputs
launched one wave at a time, one launch after another on the stream (CUDA
events), which is what one launch for the whole stream saves; the split
run must leave the same state, posts and newbits as the one launch.

SHA-256 bounds: the operations of one live 64-byte block are counted as sm_90
instructions at their fan-in (a rotate is one SHF, any two- or three-input
logic one LOP3, up to three addends one IADD3), as in csrc/sha256.cu: 1,024
shifts and logic ops, which only the INT32 pipe runs (64 lanes per SM per
clock), and 360 adds, which the compiler may also issue as IMAD on the FMA
pipe.  The operation time is the larger of the shifts and logic at the INT32
rate and all 1,384 at the SM's issue ceiling (128 lanes per clock); the byte
time moves the live blocks, n_blocks and the digests at the HBM rate; the
bound is the larger of the two.

Beside the bound, two numbers of the kernels' real limit, the serial round
chain of the wave's longest message (its live blocks x 64 rounds):
cycles_per_round is the kernel's time at the sampled SM clock over those
rounds, and chain_floor_ms is those rounds x 4 dependent instructions (the
loop-carried chain a -> a' of csrc/sha256.cu) x the measured dependent-issue
latency, at the same clock.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM: 132 SMs at 1.98 GHz boost; per SM and clock 64 INT32 lanes (the
# CUDA programming guide's throughput table for compute capability 9.0: add,
# shift, logic and funnel shift alike) and 4 schedulers of 32 lanes; 3.35
# TB/s of HBM3 (data sheet).  All assume the full 700 W limit.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# One 64-byte block: 64 rounds of 6 SHF + 4 LOP3 + 4 IADD3 and 48 schedule
# words of 4 SHF + 2 SHR + 2 LOP3 + 2 IADD3, then 8 state adds.
ALU_OPS_PER_BLOCK = 64 * (6 + 4) + 48 * (6 + 2)
ADD_OPS_PER_BLOCK = 64 * 4 + 48 * 2 + 8
# SASS opcodes of integer ALU work, for the instruction-mix report.
INTEGER_ALU = ("SHF", "SHL", "SHR", "LOP3", "IADD3", "IADD", "IMAD", "LEA", "PRMT")

LADDER = (4, 16, 64)
WAVES = (64, 1024, 4096)
# (rows, L, live rows or None for 7/8 of them): row counts that are no
# multiple of a CTA's 32 messages, the smallest and large block buckets
# (L = 256 wraps the kernels' 4-stage ring 64 times), and one live row in
# 1,024.
EDGES = ((1, 4, None), (31, 4, None), (33, 4, None), (63, 4, None),
         (33, 1, None), (33, 128, None), (64, 256, None), (1024, 16, 1))
# Dependent instructions on a SHA-256 round's loop-carried chain a -> a'.
CHAIN_DEPTH = 4
SEED = 20261016
DEVICE = "cuda"
# The main path: bench.py's c3 shape (BASELINE config 3) with its plane
# settings; and the 4-node shape of the pinned-kernel paths.
C3 = dict(node_count=64, client_count=64, reqs_per_client=100, batch_size=100)
C3_PLANE = dict(device=True, hash_wave=64, hash_floor=8, defer_unready=False)
# Run orders (drive_paths): H host path, D device run, P device run traced.
C3_ORDER = "HDHP"
C2_ORDER = "HDDHP"
C3_FUSED_ORDER = "D"
C2_FUSED_ORDER = "DD"
SMALL = dict(node_count=4, client_count=4, reqs_per_client=20, batch_size=5)
SMALL_PLANE = dict(device=True, hash_wave=4, hash_floor=1, defer_unready=False)
# The signed paths: bench.py's c2py_16n_signed shape (BASELINE config 2) with
# the auth settings of _device_crypto(); and the 4-node shape signed, with
# waves of 16 so that verdicts come out of the kernel, and client 3 a corrupt
# signer (its request 10's garbage S is below L, so that row passes the host
# screen and reaches the kernel).
C2 = dict(node_count=16, client_count=16, reqs_per_client=50, batch_size=100,
          signed_requests=True)
C2_PLANE = dict(device=True, hash_wave=64, hash_floor=8, auth_wave=1024,
                auth_floor=16, defer_unready=False)
SMALL_SIGNED = dict(SMALL, signed_requests=True)
SMALL_SIGNED_PLANE = dict(SMALL_PLANE, auth_wave=16, auth_floor=1)
CORRUPT_CLIENT = 3
# Row counts that fill no whole warp of 8 signatures (7, 9), the 4-node
# path's wave (16), c2's (1,024) and more.
VERIFY_BATCHES = (1, 7, 9, 16, 31, 33, 256, 1024, 4096)
VERIFY_SAMPLE = 64  # verify_one rows a batch (~9 ms each in pure Python)
SIGNED_KEYS = 96  # signatures by sign_one under distinct keys
# One verification: 4,375 field multiplies of 72 products, two IMAD halves
# each; per row 3 x 32 limbs and 2 x 256 bits of int32 in, one byte out.
IMAD_PER_VERIFY = 4375 * 72 * 2
IMAD_LANES_PER_SM = 64
VERIFY_BYTES_PER_ROW = 3 * 32 * 4 + 2 * 256 * 4 + 1
# Field multiplies one lane of csrc/ed25519.cu runs in series for a
# signature: 5 to set up the table, 4 a ladder step (one of each formula
# stage), the inversion's 265 and one for x or y.
VERIFY_SERIAL_MULS = 5 + 256 * 4 + 265 + 1
# The "mxu" kernel (csrc/ed25519_mxu.cu) runs the reference's program: one
# verification is 4,870 field multiplies (1 + 9 to set up the table, 256 x
# (8 + 9) in the ladder, 254 + 252 in the inversion, 2 for x and y); each,
# a row, 4,096 nibble products and their two 4-bit halves (3 integer
# operations each) and the int8 multiply-adds of its MMAs (160 K tiles x 4
# MMAs x 4,096 for 16 rows).  Hopper's dense int8 tensor rate at 700 W.
MXU_MULS_PER_VERIFY = 1 + 9 + 256 * 17 + 254 + 252 + 2
MXU_INT_OPS_PER_MUL = 4096 * 3
MXU_MACS_PER_MUL = 160 * 4 * 4096 // 16
INT8_OPS_PER_S = 1.979e15
# The design's own floor (mxu_design_floor): its MMAs a multiply of a group of
# 8 rows, and the integer lanes a clock of an SM over the FMA and ALU pipes
# its IMADs and byte permutes run on.
MXU_MMAS_PER_GROUP_MUL = 4 * 32 * 2
MXU_DESIGN_INT_LANES_PER_SM = 2 * 64
# Paths whose verify waves are pinned to a backend (through the port's
# environment override, MIRBFT_TPU_TORCH_VERIFY_KERNEL); every other path's
# verifiers resolve "auto" by the process's one probe (take_verify_probe).
VERIFY_PINS = {"c2_signed_mxu": "mxu", "c2_16n_signed_fast_mxu": "mxu"}
# The quorum kernel's streams (W, D, N, K): the fused bench wave's (4,096
# slots, 4 digest slots, eight one-touch waves padded to K = 8) and longer
# ones, K = 40 past a warp; 20,480 touches, which overflow the kernel's
# table of 4,096 and run in six chunks; waves of 4,160 touches, wider than
# the table, on the kernel's global branch; and 8,192 slots (two tenants'
# slabs of the bench's 4,096), whose 32,768 rows the kernel finds through
# its hash table, not its direct map.  Its integer operations a touch (the
# gate's 8 compares, the indices, the word, the atomics), for the bound.
QUORUM_SHAPES = ((4096, 4, 8, 8), (4096, 4, 64, 8), (4096, 4, 64, 40), (4096, 4, 512, 40),
                 (4096, 4, 2, 4160), (8192, 4, 64, 8))
QUORUM_OPS_PER_TOUCH = 40
# The fast-engine paths (drive_fast_paths): bench.py's c3_64n (bench.py:2305),
# c3dev, c2_16n_signed (:2275) and c2s_16n_streaming (:2294) rows on the
# native engine, FastRecording's defaults otherwise (hash waves of 64, the
# 64-row batch bucket), and the 4-node corrupt-signer shape.  Each is held
# to the host-path run of a Recording path.  Orders as above; H is
# FastRecording(device=False), the engine's host path.
C3_FAST_ORDER = "HDDHP"
C2_FAST_ORDER = "HDHP"
# The fused bench wave (bench.py bench_fused_pipeline) and the signed rows
# of c2's verify wave that ride it in the signed case.
FUSED_BATCH, FUSED_MSG_LEN, FUSED_DEPTH = 4096, 640, 20
FUSED_SLOTS, FUSED_DIGEST_SLOTS = 4096, 4
FUSED_SIGNED = 1024
# Signed rows of phase 4's "mxu" fused wave: host_fused_reference checks
# each with verify_one (pure Python, ~9 ms a row).
FUSED_MXU_SIGNED = 256


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def sm_clock_hz() -> float:
    """The SM clock nvidia-smi reports while a spin kernel keeps the card
    busy (an idle card reports its idle clock)."""
    import torch

    torch.cuda._sleep(6_000_000_000)  # ~3 s of device cycles
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    finally:
        torch.cuda.synchronize()
    return float(out[0]) * 1e6


def ptxas_kernel(report, kernel):
    """{registers, stack_bytes, spill_stores, spill_loads} of one kernel in
    a ``ptxas -v`` report; {} if the report does not name it."""
    import re

    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            text = " ".join(lines[i + 1:i + 5])
            stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", text)
            regs = re.search(r"Used (\d+) registers", text)
            if stack and regs:
                return {"registers": int(regs.group(1)), "stack_bytes": int(stack.group(1)),
                        "spill_stores": int(stack.group(2)),
                        "spill_loads": int(stack.group(3))}
    return {}


def u32(t):
    """An int32 tensor of uint32 bits -> numpy uint32 on the host."""
    return t.cpu().numpy().view("uint32")


def bound_of(n_blocks_np, L, out_elems):
    """(bound_ms, bound_by) of one launch on this data: live blocks only."""
    import numpy as np

    live = np.minimum(n_blocks_np.astype(np.int64), L).sum()
    ops_s = live * max(ALU_OPS_PER_BLOCK / INT32_OPS_PER_S,
                       (ALU_OPS_PER_BLOCK + ADD_OPS_PER_BLOCK) / ISSUE_OPS_PER_S)
    moved = live * 64 + n_blocks_np.size * 4 + out_elems * 4
    bytes_s = moved / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes")


def chain_of(ms, n_blocks_np, L, clock):
    """(cycles_per_round, chain_floor_ms) of one launch: the kernel's time
    over the rounds of the wave's longest message, and the least time those
    rounds' dependent chain takes.  ``clock`` is (SM Hz, cycles per
    dependent instruction, ...)."""
    import numpy as np

    hz, latency = clock[:2]
    rounds = int(np.minimum(n_blocks_np.astype(np.int64), L).max()) * 64
    if rounds == 0:
        return float("nan"), 0.0
    return ms * 1e-3 * hz / rounds, rounds * CHAIN_DEPTH * latency / hz * 1e3


def sass_mix(so, names):
    """kernel name (of ``names``) -> ({base opcode: count}, static cycles per
    round) of the built library's SASS, by cuobjdump beside nvcc; {} where
    cuobjdump is missing.  The block loops are not unrolled, so one block's instructions
    appear once per kernel.  The static cycles are the stall counts ptxas
    encodes in each instruction's control bits (bits 105-108), summed from
    the consumer's first load of KW (LDS) to its last and divided by the 63
    rounds between them: the schedule's own cycles per round, before any
    wait the hardware adds at run time."""
    import re

    from mirbft_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    code, current = {}, None  # kernel -> [(opcode, stall)]
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = next((k for k in names if k + "_kernel" in name), None)
            if current is not None:
                code[current] = []
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        following = lines[i + 1] if op and i + 1 < len(lines) else ""
        control = re.search(r"/\* 0x([0-9a-f]{16}) \*/", following)
        if current is not None and control:
            code[current].append((op.group(1), (int(control.group(1), 16) >> 41) & 0xF))
    out = {}
    for kernel, ops in code.items():
        mix = {}
        for opcode, _ in ops:
            mix[opcode] = mix.get(opcode, 0) + 1
        loads = [i for i, (opcode, _) in enumerate(ops) if opcode == "LDS"]
        static = (sum(stall for _, stall in ops[loads[0]:loads[-1]]) / (len(loads) - 1)
                  if len(loads) > 1 else float("nan"))
        out[kernel] = (mix, static)
    return out


def time_plain(fn, repeats=1):
    """Wall seconds per call of a plain version (it synchronises inside)."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / repeats


def plain_once(fn):
    """(result, wall seconds) of one call of a plain version, the card idle
    before and after: the check's own call, timed."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def kernel_table():
    """name -> (wrapper, plain version, layout, source note)."""
    from mirbft_tpu_torch.ops.sha256 import sha256_batch_torch
    from mirbft_tpu_torch.ops.sha256_pallas import sha256_batch
    from mirbft_tpu_torch.ops.sha256_pallas_lanes import sha256_lanes, sha256_lanes_torch

    return {
        "sha256_lanes": (
            sha256_lanes, sha256_lanes_torch, "lanes",
            "mirbft_tpu/ops/sha256_pallas_lanes.py:37",
        ),
        "sha256_batch": (
            sha256_batch, sha256_batch_torch, "batch",
            "mirbft_tpu/ops/sha256_pallas.py:58",
        ),
    }


def ragged_wave(rng, wave, L, layout, count=None):
    """A packed wave of ``wave`` rows at block bucket ``L``: ``count`` (by
    default 7/8 of the rows) real messages of ragged lengths (1..L blocks),
    padding rows with n_blocks 0, and random words in every block past a
    row's last one.  A lanes-major wave pads to whole tiles."""
    import numpy as np

    from mirbft_tpu_torch.ops.sha256 import pack_messages
    from mirbft_tpu_torch.ops.sha256_pallas_lanes import pack_lanes_major

    count = max(1, wave - wave // 8) if count is None else count
    lengths = rng.integers(0, 64 * L - 8, size=count)
    messages = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]
    # The packer rounds the batch up to a power of two: cut it to ``wave``.
    blocks, n_blocks = pack_messages(messages, block_bucket=L, batch_bucket=wave)
    blocks, n_blocks = blocks[:wave].copy(), n_blocks[:wave].copy()
    b = np.arange(L)
    if layout == "batch":
        dead = b[None, :] >= n_blocks[:, None]
        blocks[dead] = rng.integers(0, 2**32, size=(int(dead.sum()), 16), dtype=np.uint32)
    else:
        blocks, n_blocks = pack_lanes_major(blocks, n_blocks)
        dead = b[None, :, None, None, None] >= n_blocks[:, None, :, :, :]
        dead = np.broadcast_to(dead, blocks.shape[:1] + (L, 16) + blocks.shape[3:])
        blocks[dead] = rng.integers(0, 2**32, size=int(dead.sum()), dtype=np.uint32)
    return messages, blocks, n_blocks


def pack_bound(n_rows, total_bytes, batch, bucket):
    """bound_ms of one pack launch: each staged input byte read once (the
    messages, an 8-byte offset and a 4-byte length a row) and each output
    word written once (the blocks and n_blocks), at the HBM rate."""
    moved = total_bytes + 12 * n_rows + batch * bucket * 64 + batch * 4
    return moved / HBM_BYTES_PER_S * 1e3


def pack_case(staged, batch, bucket, layout, host_words):
    """(ms, plain_ms, bound_ms, max_abs_err) of the pack kernel on a staged
    wave on the card (``staged``: raw, offsets, lengths tensors): bit for
    bit against its plain version there and against the host packer's
    words (``host_words``)."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.ops.pack import pack_wave, pack_wave_torch

    got = pack_wave(*staged, batch, bucket, layout)
    want = pack_wave_torch(*staged, batch, bucket, layout)
    torch_sync()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    host = [np.asarray(h).reshape(g.shape) for h, g in zip(host_words, got)]
    if err or any(u32(g).tobytes() != h.astype(np.uint32).tobytes() for g, h in zip(got, host)):
        raise AssertionError(f"pack_wave {layout} [{batch}, {bucket}]: kernel != plain or the "
                             f"host packer (max err against plain {err})")
    ms = time_cuda(lambda: pack_wave(*staged, batch, bucket, layout)) * 1e3
    plain_ms = time_plain(lambda: pack_wave_torch(*staged, batch, bucket, layout)) * 1e3
    bound_ms = pack_bound(staged[2].shape[0], int(staged[0].shape[0]), batch, bucket)
    return ms, plain_ms, bound_ms, err


# The pack kernel's waves (phase 3): the fused bench wave, c3's [64, 64, 16]
# wave and the padding boundaries in one wave, each in both layouts.
PACK_BOUNDARY = (0, 1, 55, 56, 63, 64, 119, 120, 640)


def check_pack():
    """Phase 3: the pack kernel against its plain version and the host
    packer (``pack_messages``), bit for bit, on staged waves in both
    layouts; its times beside its byte bound."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops.pack import StagingPool, stage_messages
    from mirbft_tpu_torch.ops.sha256 import pack_messages

    rng = np.random.default_rng(SEED + 11)
    fused = [rng.integers(0, 256, size=FUSED_MSG_LEN, dtype=np.uint8).tobytes()
             for _ in range(FUSED_BATCH)]
    c3 = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
          for n in rng.integers(0, 64 * 64 - 8, size=64)]
    boundary = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in PACK_BOUNDARY]
    cases = (("fused", fused, {}), ("c3", c3, {"block_bucket": 64, "batch_bucket": 64}),
             ("boundary", boundary, {}))
    pool = StagingPool(pinned=DEVICE == "cuda")
    worst = scattered_pack_case(boundary)
    for name, messages, kw in cases:
        for layout in ("batch", "lanes"):
            wave = stage_messages(messages, layout=layout, pool=pool, **kw)
            t = wave.views(wave.copy_in(torch.device(DEVICE)))
            want = pack_messages(messages, layout=layout, **kw)
            ms, plain_ms, bound_ms, err = pack_case(
                [t["raw"], t["offsets"], t["lengths"]], wave.batch, wave.bucket, layout,
                (want.blocks, want.n_blocks))
            worst = max(worst, err)
            log(f"kernel pack_wave {name} layout={layout} rows={len(messages)} "
                f"shape={list(wave.blocks_shape)} bytes={sum(map(len, messages))} "
                f"ms={ms:.6f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.9f} (bytes) "
                f"== plain and pack_messages")
            torch_sync()
            pool.release(wave.lease)
    return worst


def scattered_pack_case(messages):
    """The pack kernel on rows out of order, 3 bytes apart, in a buffer
    that starts one byte off the 16-byte grid (every granule read byte by
    byte), against its plain version and ``pack_messages``; returns the
    max error against the plain version."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops.sha256 import pack_messages

    chunks, offsets, at = [b"\0"], [0] * len(messages), 0
    for i in reversed(range(len(messages))):
        offsets[i] = at
        chunks.append(messages[i] + b"\0\0\0")
        at += len(messages[i]) + 3
    buf = torch.from_numpy(np.frombuffer(b"".join(chunks), dtype=np.uint8).copy()).to(DEVICE)
    staged = [buf[1:], torch.tensor(offsets, dtype=torch.int64, device=DEVICE),
              torch.tensor([len(m) for m in messages], dtype=torch.int32, device=DEVICE)]
    if staged[0].data_ptr() % 16 == 0:
        raise AssertionError("the scattered pack case's raw bytes are 16-byte aligned")
    worst = 0
    for layout in ("batch", "lanes"):
        want = pack_messages(messages, layout=layout)
        batch = want.n_blocks.size
        _, _, _, err = pack_case(staged, batch, want.blocks.shape[1], layout,
                                 (want.blocks, want.n_blocks))
        worst = max(worst, err)
    log(f"kernel pack_wave scattered rows={len(messages)} (out of order, raw off the 16-byte "
        f"grid) == plain and pack_messages in both layouts")
    return worst


def rows_of(words, layout):
    if layout == "lanes":
        return words.transpose(0, 2, 3, 1).reshape(-1, 8)
    return words


def check_kernels(clock):
    """Phase 3: every kernel at every ladder and edge shape against its
    plain version on the card and against hashlib."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.ops.sha256 import _H0, digests_from_words, wave_to_torch

    rng = np.random.default_rng(SEED)
    shapes = [(wave, L, None) for wave in WAVES for L in LADDER] + list(EDGES)
    worst = {}
    for name, (kernel, plain, layout, _) in kernel_table().items():
        worst[name] = 0
        for wave, L, count in shapes:
            messages, blocks, n_blocks = ragged_wave(rng, wave, L, layout, count)
            bt, nt = wave_to_torch(blocks, n_blocks, DEVICE)
            got = kernel(bt, nt)
            torch.cuda.synchronize()
            start = time.perf_counter()
            want = plain(bt, nt)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - start) * 1e3
            diff = (u32(got).astype(np.int64) - u32(want).astype(np.int64))
            err = int(np.abs(diff).max())
            worst[name] = max(worst[name], err)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} wave={wave} L={L}: kernel != plain (max err {err})")
            rows = rows_of(u32(got), layout)
            sample = rng.choice(len(messages), size=min(256, len(messages)), replace=False)
            digests = digests_from_words(rows[sample])
            for i, d in zip(sample, digests):
                if d != hashlib.sha256(messages[i]).digest():
                    raise AssertionError(f"{name} wave={wave} L={L}: row {i} != hashlib")
            if not (rows[len(messages):] == _H0).all():
                raise AssertionError(f"{name} wave={wave} L={L}: padding rows != H0")
            ms = time_cuda(lambda: kernel(bt, nt)) * 1e3
            bound_ms, by = bound_of(n_blocks, L, got.numel())
            cycles, floor_ms = chain_of(ms, n_blocks, L, clock)
            log(f"kernel {name} wave={wave} L={L} rows={rows.shape[0]} "
                f"live_rows={len(messages)} ms={ms:.6f} plain_ms={plain_ms:.3f} "
                f"bound_ms={bound_ms:.6f} ({by}) chain_floor_ms={floor_ms:.6f} "
                f"cycles_per_round={cycles:.2f} max_abs_err={err} "
                f"hashlib_rows={len(sample)} ok")
    return worst


# RFC 8032 section 7.1 TEST 1-3 (public key, message, signature).
RFC_VECTORS = (
    ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
)


def signed_pool(rng):
    """(pubs, msgs, sigs, kinds) of the verify kernel's checks: the RFC
    vectors first, then SIGNED_KEYS signatures by sign_one under distinct
    keys, tampered copies of some (R, S below L, message, key), small-order
    keys (the identity and the points of order 2 and 4, with R = [r]B and
    S = r: the identity's rows verify, the others as h's parity says), the
    identity's Q encoded canonically and non-canonically (y = p + 1), and
    S >= L rows, which the host screen rejects."""
    from mirbft_tpu_torch.ops import ed25519 as e

    pubs, msgs, sigs, kinds = [], [], [], []

    def add(kind, pub, msg, sig):
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
        kinds.append(kind)

    for pub, msg, sig in RFC_VECTORS:
        add("rfc", bytes.fromhex(pub), bytes.fromhex(msg), bytes.fromhex(sig))
    for _ in range(SIGNED_KEYS):
        seed = rng.integers(0, 256, size=32, dtype="uint8").tobytes()
        msg = rng.integers(0, 256, size=int(rng.integers(0, 200)), dtype="uint8").tobytes()
        add("signed", e.public_from_seed(seed), msg, e.sign_one(seed, msg))

    def flip(data, i):
        return data[:i] + bytes([data[i] ^ 1 << (i % 8)]) + data[i + 1:]

    for j in range(3, 3 + SIGNED_KEYS, 4):
        pub, msg, sig = pubs[j], msgs[j], sigs[j]
        add("tampered_r", pub, msg, flip(sig, 7))
        add("tampered_s", pub, msg, flip(sig, 33))
        add("tampered_msg", pub, msg + b"!", sig)
        add("tampered_key", flip(pub, 11), msg, sig)
    for y in (1, e.P - 1, 0):  # the identity, order 2, order 4
        for r in (5, 77, 1234, 99991):
            point = e._compress_py(e._pt_mul_py(r, e._BASE_PT))
            add("small_order_key", y.to_bytes(32, "little"), b"so-%d" % r,
                point + r.to_bytes(32, "little"))
    add("canonical_r", (1).to_bytes(32, "little"), b"q", (1).to_bytes(32, "little") + bytes(32))
    add("non_canonical_r", (1).to_bytes(32, "little"), b"q",
        (e.P + 1).to_bytes(32, "little") + bytes(32))
    for j in range(3, 11):
        s = int.from_bytes(sigs[j][32:], "little")
        add("s_at_least_l", pubs[j], msgs[j], sigs[j][:32] + (s + e.L).to_bytes(32, "little"))
    return pubs, msgs, sigs, kinds


def verify_bound(rows, hz):
    """(bound_ms, bound_by) of one verify launch of ``rows`` rows."""
    ops_s = rows * IMAD_PER_VERIFY / (132 * IMAD_LANES_PER_SM * hz)
    bytes_s = rows * VERIFY_BYTES_PER_ROW / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def verify_issue_bound(rows, clock):
    """A verify launch's floor at the measured issue rate of IMAD.WIDE, the
    instruction that forms each 32 x 32 -> 64-bit product: 4,375 x 72 wide
    products a row, 32 a warp instruction, each instruction ``clock[2]``
    issue cycles, over the card's 528 schedulers at the sampled SM clock."""
    warp_instructions = rows * 4375 * 72 / 32
    return warp_instructions * clock[2] / (132 * 4 * clock[0]) * 1e3


def cycles_per_mul(ms, clock):
    """A verify launch's time at the sampled SM clock over the field
    multiplies one lane runs in series."""
    return ms * 1e-3 * clock[0] / VERIFY_SERIAL_MULS


def check_ed25519(clock):
    """Phase 3, Ed25519: the verify kernel at every listed batch against
    verify_torch on the card (exact) and verify_one (sampled rows)."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.crossover import time_cuda

    rng = np.random.default_rng(SEED + 1)
    start = time.perf_counter()
    pubs, msgs, sigs, kinds = signed_pool(rng)
    sign_s = time.perf_counter() - start
    expected = [e.verify_one(*row) for row in zip(pubs, msgs, sigs)]
    verify_s = time.perf_counter() - start - sign_s
    pad = 16  # all-zero padding rows after the pool
    verifier = e.Ed25519BatchVerifier(min_device_batch=1, device=DEVICE)
    arrays = verifier.pack_inputs(pubs, msgs, sigs, batch=len(pubs) + pad)
    valid = arrays[5]
    expected = np.array(expected + [False] * pad)
    kind_of = kinds + ["padding"] * pad
    counts = {k: kind_of.count(k) for k in sorted(set(kind_of))}
    log(f"ed25519 pool: {len(pubs)} rows + {pad} padding ({counts}), "
        f"{sum(expected)} valid by verify_one; public_from_seed and sign_one {sign_s:.3f} s, "
        f"verify_one {len(pubs)} rows {verify_s:.3f} s")
    for kind in ("rfc", "small_order_key", "canonical_r", "non_canonical_r", "s_at_least_l"):
        rows = [i for i, k in enumerate(kind_of) if k == kind]
        log(f"ed25519 pool {kind}: verify_one {expected[rows].astype(int).tolist()}")
    kernel = e.ed25519_verify_kernel
    worst = 0
    for batch in VERIFY_BATCHES:
        # The RFC vectors lead, then the padding rows, then random rows.
        pick = rng.integers(0, len(kind_of), size=batch)
        lead = np.concatenate([np.arange(3), len(pubs) + np.arange(pad)])[:batch]
        pick[: len(lead)] = lead
        inputs = [torch.from_numpy(np.ascontiguousarray(a[pick])).to(DEVICE) for a in arrays[:5]]
        got = kernel(*inputs)
        torch_sync()
        start = time.perf_counter()
        want = e.verify_torch(*inputs)
        torch_sync()
        plain_ms = (time.perf_counter() - start) * 1e3
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"ed25519 batch={batch}: kernel != verify_torch")
        verdicts = got.cpu().numpy() & valid[pick]
        if not verdicts[: min(batch, 3)].all():
            raise AssertionError(f"ed25519 batch={batch}: an RFC 8032 vector failed")
        sample = rng.choice(batch, size=min(VERIFY_SAMPLE, batch), replace=False)
        for i in sample:
            if verdicts[i] != expected[pick[i]]:
                raise AssertionError(f"ed25519 batch={batch}: row {i} != verify_one")
        ms = time_cuda(lambda: kernel(*inputs), repeats=5) * 1e3
        bound_ms, by = verify_bound(batch, clock[0])
        log(f"kernel ed25519_verify batch={batch} verified={int(verdicts.sum())} "
            f"padding={int((pick >= len(pubs)).sum())} ms={ms:.6f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound_ms:.6f} ({by}) of_bound={bound_ms / ms:.4f} "
            f"cycles_per_mul={cycles_per_mul(ms, clock):.1f} "
            f"max_abs_err={err} verify_one_rows={len(sample)} ok")
    # S >= L unscreened: the packed rows of valid signatures with S + L in
    # place of S.  [S + L]B = [S]B, so kernel and twin accept what the host
    # screen must reject.
    rows = [i for i, k in enumerate(kinds) if k == "s_at_least_l"]
    originals = list(range(3, 3 + len(rows)))  # the signatures they malleate
    inputs = [np.ascontiguousarray(a[originals]) for a in arrays[:5]]
    for n, i in enumerate(rows):
        s = int.from_bytes(sigs[i][32:], "little")
        inputs[3][n] = np.unpackbits(np.frombuffer(s.to_bytes(32, "little"), dtype="uint8"),
                                     bitorder="little")
    s_rows = inputs
    inputs = [torch.from_numpy(a).to(DEVICE) for a in inputs]
    got = kernel(*inputs)
    want = e.verify_torch(*inputs)
    if not torch.equal(got, want) or not bool(got.all()):
        raise AssertionError("ed25519: unscreened S >= L rows: kernel != twin, or not accepted")
    screened = verifier.verify_batch([pubs[i] for i in rows], [msgs[i] for i in rows],
                                     [sigs[i] for i in rows])
    if screened.any():
        raise AssertionError("ed25519: an S >= L row got through the verifier")
    log(f"ed25519 S >= L: {len(rows)} rows unscreened, kernel == twin, all accepted "
        f"(S + L gives the same [S]B); through the verifier all rejected == verify_one")
    pool = dict(pubs=pubs, msgs=msgs, sigs=sigs, kinds=kinds, kind_of=kind_of, pad=pad,
                arrays=arrays, expected=expected, s_rows=s_rows)
    return worst, pool


def mxu_bound(rows):
    """(bound_ms, bound_by) of one "mxu" verify launch of ``rows`` rows:
    the larger of its integer work (the nibble products and their halves)
    at the INT32 rate, its MMAs' int8 multiply-adds at the dense int8 rate,
    and its bytes at the HBM rate."""
    int_s = rows * MXU_MULS_PER_VERIFY * MXU_INT_OPS_PER_MUL / INT32_OPS_PER_S
    mma_s = rows * MXU_MULS_PER_VERIFY * MXU_MACS_PER_MUL * 2 / INT8_OPS_PER_S
    bytes_s = rows * VERIFY_BYTES_PER_ROW / HBM_BYTES_PER_S
    return max(int_s, mma_s, bytes_s) * 1e3, (
        "bytes" if bytes_s > max(int_s, mma_s) else "operations")


def mxu_design_floor(rows, mma_cycles, clock_hz):
    """(floor_ms, by) of one "mxu" verify launch of ``rows`` rows as
    csrc/ed25519_mxu.cu is designed: a group of 8 rows runs on one SM, and
    the groups spread evenly over the 132 SMs, so an SM runs
    ceil(groups / 132) of them.  A group's multiply is the larger of its
    MMAs' issue (4 M tiles x 32 K tiles x 2 m16n8k32 over the SM's four
    sub-partitions, each MMA holding its sub-partition ``mma_cycles``) and
    its integer work (one operation a nibble product: a lane's 4 IMADs on
    the FMA pipe and 4 byte permutes on the ALU pipe make its 8 products a
    tile, both pipes at 64 lanes an SM a clock).  ``mxu_bound`` counts the
    function's work; this counts the design's, which needs less."""
    groups = -(-rows // 8)
    per_sm = -(-groups // 132)
    tensor_s = (per_sm * MXU_MULS_PER_VERIFY * MXU_MMAS_PER_GROUP_MUL * mma_cycles
                / (4 * clock_hz))
    int_s = per_sm * 8 * MXU_MULS_PER_VERIFY * 4096 / (MXU_DESIGN_INT_LANES_PER_SM * clock_hz)
    return max(tensor_s, int_s) * 1e3, ("tensor-core issue" if tensor_s >= int_s else "integer")


def check_ed25519_mxu(clock, pool, mma_cycles):
    """Phase 3, Ed25519 "mxu": the tensor-core verify kernel at every listed
    batch (phase 3's pool: RFC 8032 rows first, then padding rows, then
    random rows) against verify_torch with _mul_mxu on the card, bit for
    bit, and verify_one on sampled rows; the vpu kernel's time on the same
    inputs beside its own; and the unscreened S >= L rows.  Beside the
    bound, the floor of the kernel's own design (``mxu_design_floor``, at
    the ``mma`` probe's ``mma_cycles``)."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.crossover import time_cuda

    rng = np.random.default_rng(SEED + 11)
    arrays, expected, kind_of = pool["arrays"], pool["expected"], pool["kind_of"]
    valid, n_pool, pad = arrays[5], len(pool["pubs"]), pool["pad"]
    worst = 0

    def kernel(*tensors):
        return e.ed25519_verify_kernel(*tensors, backend="mxu")

    for batch in VERIFY_BATCHES:
        pick = rng.integers(0, len(kind_of), size=batch)
        lead = np.concatenate([np.arange(3), n_pool + np.arange(pad)])[:batch]
        pick[: len(lead)] = lead
        inputs = [torch.from_numpy(np.ascontiguousarray(a[pick])).to(DEVICE) for a in arrays[:5]]
        got = kernel(*inputs)
        want, plain_s = plain_once(lambda: e.verify_torch(*inputs, mul=e._mul_mxu))
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"ed25519 mxu batch={batch}: kernel != verify_torch(_mul_mxu)")
        verdicts = got.cpu().numpy() & valid[pick]
        if not verdicts[: min(batch, 3)].all():
            raise AssertionError(f"ed25519 mxu batch={batch}: an RFC 8032 vector failed")
        sample = rng.choice(batch, size=min(VERIFY_SAMPLE, batch), replace=False)
        for i in sample:
            if verdicts[i] != expected[pick[i]]:
                raise AssertionError(f"ed25519 mxu batch={batch}: row {i} != verify_one")
        ms = time_cuda(lambda: kernel(*inputs), repeats=3) * 1e3
        vpu_ms = time_cuda(lambda: e.ed25519_verify_kernel(*inputs), repeats=5) * 1e3
        bound_ms, by = mxu_bound(batch)
        floor_ms, floor_by = mxu_design_floor(batch, mma_cycles, clock[0])
        log(f"kernel ed25519_verify_mxu batch={batch} verified={int(verdicts.sum())} "
            f"padding={int((pick >= n_pool).sum())} ms={ms:.6f} plain_ms={plain_s * 1e3:.3f} "
            f"bound_ms={bound_ms:.6f} ({by}) of_bound={bound_ms / ms:.4f} "
            f"vpu_ms={vpu_ms:.6f} mxu/vpu={ms / vpu_ms:.2f} "
            f"ms_per_multiply={ms / MXU_MULS_PER_VERIFY:.6f} "
            f"cycles_per_multiply={ms * 1e-3 * clock[0] / MXU_MULS_PER_VERIFY:.1f} "
            f"design_floor_ms={floor_ms:.6f} ({floor_by}) of_design_floor={floor_ms / ms:.4f} "
            f"max_abs_err={err} "
            f"verify_one_rows={len(sample)} ok")
    # S >= L unscreened, as for the vpu kernel: accepted by kernel and twin.
    inputs = [torch.from_numpy(a).to(DEVICE) for a in pool["s_rows"]]
    got = kernel(*inputs)
    want = e.verify_torch(*inputs, mul=e._mul_mxu)
    if not torch.equal(got, want) or not bool(got.all()):
        raise AssertionError("ed25519 mxu: unscreened S >= L rows: kernel != twin, or not accepted")
    log(f"ed25519 mxu S >= L: {len(inputs[0])} rows unscreened, kernel == twin, all accepted")
    return worst


def gated_stream(rng, w, d, n, k, p=8, b=64):
    """A random quorum stream with its gate tables, as host arrays [masks,
    counts, sources, touches, valid, prev_words, digests, digest_rows,
    claimed, row_groups, touch_groups]: a duplicate touch in every wave,
    slots and digest slots out of range both ways (past -size too),
    sources >= 256 and < 0, gated rows of both tables, past them and -1,
    claims that match and do not, a chained prev_words of ``p`` rows and
    group tags with -1.  The card and CPU tests of the quorum kernel draw
    their streams here too."""
    import numpy as np

    def index(size, shape):
        i = rng.integers(0, size, size=shape)
        edge = rng.random(shape) < 0.15
        i[edge] = rng.choice([-size - 2, -size - 1, -2, -1, size, size + 1],
                             size=int(edge.sum()))
        return i

    prev = rng.integers(0, 2**32, size=(p, 8), dtype=np.uint32)
    digests = rng.integers(0, 2**32, size=(b, 8), dtype=np.uint32)
    row_groups = rng.integers(-1, 2, size=p + b).astype(np.int32)
    sources = rng.integers(-40, 300, size=n).astype(np.int32)
    touches = np.stack([index(w, (n, k)), index(d, (n, k))], axis=-1).astype(np.int32)
    if k > 1:
        touches[:, 1] = touches[:, 0]
    valid = rng.random((n, k)) < 0.8
    digest_rows = rng.integers(-2, p + b + 3, size=(n, k)).astype(np.int32)
    rows = np.clip(digest_rows, 0, p + b - 1)
    claimed = np.concatenate([prev, digests])[rows]
    spoil_n, spoil_k = np.nonzero(rng.random((n, k)) < 0.3)
    claimed[spoil_n, spoil_k, rng.integers(0, 8, size=spoil_n.size)] ^= 1
    touch_groups = np.where(rng.random((n, k)) < 0.8, row_groups[rows],
                            rng.integers(-1, 2, size=(n, k))).astype(np.int32)
    masks = rng.integers(0, 2**32, size=(w, d, 8), dtype=np.uint32)
    counts = rng.integers(0, 200, size=(w, d)).astype(np.int32)
    return [masks, counts, sources, touches, valid, prev, digests, digest_rows, claimed,
            row_groups, touch_groups]


def as_tensors(arrays, device):
    """Host arrays -> tensors on ``device`` (uint32 as int32 bits)."""
    import numpy as np
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32
                             else np.ascontiguousarray(a)).to(device) for a in arrays]


def quorum_bound(tensors):
    """(bound_ms, bound_by) of one quorum launch on these inputs: the bytes
    its data needs at the HBM rate, or ~QUORUM_OPS_PER_TOUCH integer
    operations a touch at the INT32 rate."""
    import numpy as np

    masks, _, sources, touches, valid, _, _, rows, *_ = [t.cpu().numpy() for t in tensors]
    n, k = valid.shape
    w, d = masks.shape[:2]

    def clamp(i, size):
        return np.clip(np.where(i < 0, i + size, i), 0, size - 1)

    wr, dr = clamp(touches[..., 0], w), clamp(touches[..., 1], d)
    word = np.broadcast_to(clamp(sources.astype(np.int64) >> 5, 8)[:, None], (n, k))
    pairs = len(np.unique(wr * d + dr))
    words = len(np.unique((wr * d + dr) * 8 + word))
    gated = int((valid & (rows >= 0)).sum())
    moved = n * 4 + n * k * (8 + 1 + 4 + 4 + 4 + 1) + gated * (32 + 32 + 4) + (words + pairs) * 8
    bytes_s = moved / HBM_BYTES_PER_S
    ops_s = n * k * QUORUM_OPS_PER_TOUCH / INT32_OPS_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def run_quorum(tensors):
    """One kernel launch on fresh copies of the state; returns (masks,
    counts, posts, newbits)."""
    from mirbft_tpu_torch.ops import quorum

    masks, counts = tensors[0].clone(), tensors[1].clone()
    posts, newbits = quorum.quorum_accumulate(masks, counts, *tensors[2:5], tuple(tensors[5:]))
    return masks, counts, posts, newbits


def split_waves(tensors):
    """The stream's N waves as N one-wave launch inputs (sources, touches,
    valid, gate) over the same tables."""
    _, _, sources, touches, valid, prev, digests, rows, claimed, row_groups, groups = tensors
    return [(sources[i:i + 1], touches[i:i + 1], valid[i:i + 1],
             (prev, digests, rows[i:i + 1], claimed[i:i + 1], row_groups, groups[i:i + 1]))
            for i in range(valid.shape[0])]


def launch_split(masks, counts, waves):
    """One launch a wave, in order, on the stream; returns (posts, newbits)
    of each."""
    from mirbft_tpu_torch.ops import quorum

    return [quorum.quorum_accumulate(masks, counts, *wave) for wave in waves]


def time_quorum(tensors):
    """(ms, plain_ms, bound_ms, bound_by, dependent_launches_ms) of the
    quorum kernel on these inputs (the state is updated in place as on a
    path, so every timed launch does a wave's work).  The stream is first
    run split into one launch a wave, which must equal the one launch."""
    import torch

    from mirbft_tpu_torch.ops import quorum
    from mirbft_tpu_torch.ops.crossover import time_cuda

    waves = split_waves(tensors)
    masks, counts = tensors[0].clone(), tensors[1].clone()
    outs = launch_split(masks, counts, waves)
    split = (masks, counts, torch.cat([p for p, _ in outs]), torch.cat([b for _, b in outs]))
    if not all(torch.equal(a, b) for a, b in zip(split, run_quorum(tensors))):
        raise AssertionError(f"quorum N={len(waves)}: one launch a wave != one launch")
    ms = time_cuda(lambda: quorum.quorum_accumulate(masks, counts, *tensors[2:5],
                                                    tuple(tensors[5:]))) * 1e3
    # Few enough repeats that the host enqueues every launch while time_cuda's
    # spin kernel holds the stream (the wrapper's checks take tens of
    # microseconds of host time a launch).
    dependent_ms = time_cuda(lambda: launch_split(masks, counts, waves),
                             repeats=max(1, min(20, 128 // len(waves)))) * 1e3
    plain_ms = time_plain(lambda: quorum.quorum_accumulate_torch(*tensors[:5],
                                                                 tuple(tensors[5:]))) * 1e3
    bound_ms, by = quorum_bound(tensors)
    return ms, plain_ms, bound_ms, by, dependent_ms


def check_quorum():
    """Phase 3, quorum: the gate and accumulate kernel at each stream shape
    against its plain version on the card (exact); returns the worst
    error."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops.quorum import quorum_accumulate_torch

    rng = np.random.default_rng(SEED + 2)
    worst = 0
    for w, d, n, k in QUORUM_SHAPES:
        tensors = as_tensors(gated_stream(rng, w, d, n, k), DEVICE)
        got = run_quorum(tensors)
        torch_sync()
        want = quorum_accumulate_torch(*tensors[:5], tuple(tensors[5:]))
        torch_sync()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
        worst = max(worst, err)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"quorum W={w} D={d} N={n} K={k}: kernel != plain")
        new = int(want[3].sum())
        if not 0 < new < want[3].numel():
            raise AssertionError(f"quorum N={n} K={k}: the stream set no or every newbit")
        ms, plain_ms, bound_ms, by, dep_ms = time_quorum(tensors)
        log(f"kernel quorum_accumulate W={w} D={d} N={n} K={k} newbits={new} "
            f"gated={int((tensors[4] & (tensors[7] >= 0)).sum())} ms={ms:.6f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} ({by}) "
            f"dependent_launches_ms={dep_ms:.6f} (one launch a wave == one launch) "
            f"{quorum_plan_text(w, d, n, k)} max_abs_err={err} ok")
    return worst


def quorum_plan_text(w, d, n, k):
    """How the kernel ran a stream (its table, chunks and shared memory)
    and the launch floor beside it."""
    from mirbft_tpu_torch.ops import latency_probe
    from mirbft_tpu_torch.ops.quorum import launch_plan

    plan = launch_plan(w, d, n, k)
    entries = "direct_map" if plan["map_rows"] else f"hash_table slots={plan['slots']}"
    table = (f"table_capacity={plan['capacity']} chunks={plan['chunks']} "
             f"chunk_waves={plan['chunk_waves']} entries_by={entries}"
             if plan["chunk_waves"] else f"table_capacity={plan['capacity']} global_branch")
    return (f"{table} dynamic_smem_bytes={plan['smem_bytes']} threads={plan['threads']} "
            f"launch_floor_ms={latency_probe.launch_floor_ms():.6f}")


def signed_rows(count, corrupt_signer=3, signers=16):
    """``count`` rows signed by ``signers`` keys (keypair_from_seed), the
    corrupt signer's with R tampered, as c2's clients sign; returns (pubs,
    msgs, sigs, corrupt row indices)."""
    from mirbft_tpu_torch.ops import ed25519 as e

    keys = [e.keypair_from_seed(bytes([i + 1]) * 32) for i in range(signers)]
    pubs, msgs, sigs, corrupt = [], [], [], []
    for i in range(count):
        pub, sign = keys[i % signers]
        msg = b"fused-signed-%d" % i
        sig = sign(msg)
        if i % signers == corrupt_signer:
            sig = sig[:5] + bytes([sig[5] ^ 0x10]) + sig[6:]
            corrupt.append(i)
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
    return pubs, msgs, sigs, corrupt


def fused_bound(pipe, quorum, signed, hz):
    """(bound_ms, signed_bound_ms) of one fused bench wave: the sum of its
    stages' bounds, the hash kernel's on its live blocks, the quorum
    kernel's on its packed stream and, with signed rows, the verify
    kernel's."""
    import numpy as np
    import torch

    blocks = (FUSED_MSG_LEN + 9 + 63) // 64  # SHA-256 padding: 0x80 and the length
    hash_ms, _ = bound_of(np.full(FUSED_BATCH, blocks), blocks, FUSED_BATCH * 8)
    sources, touches, valid, rows, claimed, groups = pipe._pack_quorum(quorum, FUSED_BATCH, 1)
    stream = [pipe.masks, pipe.counts, *(torch.from_numpy(a) for a in (sources, touches, valid)),
              torch.zeros((1, 8)), torch.zeros((FUSED_BATCH, 8)), torch.from_numpy(rows)]
    quorum_ms, _ = quorum_bound(stream)
    verify_ms, _ = verify_bound(signed, hz)
    return hash_ms + quorum_ms, hash_ms + quorum_ms + verify_ms


# The parts of a fused dispatch that fused_split times, by where they live:
# (label, module or class path, attribute).  A part the code does not have
# is left out of the line.
SPLIT_PARTS = (
    ("host_pack", "mirbft_tpu_torch.ops.sha256:TorchHasher", "pack"),
    ("verify_pack", "mirbft_tpu_torch.ops.ed25519:Ed25519BatchVerifier", "pack_inputs"),
    ("pack_quorum", "mirbft_tpu_torch.ops.fused:FusedCryptoPipeline", "_pack_quorum"),
    ("stage_copy", "mirbft_tpu_torch.ops.pack:StagedWave", "copy_in"),
    ("pack_wave", "mirbft_tpu_torch.ops.pack:StagedWave", "pack"),
    ("sha256_lanes", "mirbft_tpu_torch.ops.sha256_pallas_lanes", "sha256_lanes"),
    ("sha256_batch", "mirbft_tpu_torch.ops.sha256_pallas", "sha256_batch"),
    ("hash_stage", "mirbft_tpu_torch.ops.fused", "_hash_stage"),
    ("ed25519_verify", "mirbft_tpu_torch.ops.ed25519", "ed25519_verify_kernel"),
    ("quorum_accumulate", "mirbft_tpu_torch.ops.quorum", "quorum_accumulate"),
)


def fused_split(pipe, msg_sets, quorum, signed=None):
    """The ``fused_split`` line: FUSED_DEPTH waves pipelined as in
    check_fused, each part of a dispatch (SPLIT_PARTS) wrapped with a host
    clock and, on the card, a pair of CUDA events on the current stream.
    Per part, the median over the waves of its host seconds and of its
    device time (the events bracket what the part enqueued: a copy or a
    kernel); ``hash_stage`` holds the hash kernel and, for the lanes layout,
    the permute to one digest row a message.  ``wave_ms`` is the host wall
    per wave of the instrumented loop, ``device_span_ms`` the card's time
    from the first wave's first event to the last wave's last."""
    import importlib

    import numpy as np
    import torch

    on_card = pipe.device.type == "cuda"
    records = {}  # label -> [(host_s, (start event, end event))] in call order
    ordered = []  # every part's events in call order
    patched = []
    for label, where, attr in SPLIT_PARTS:
        mod_name, _, cls_name = where.partition(":")
        try:
            owner = importlib.import_module(mod_name)
        except ImportError:
            continue
        owner = getattr(owner, cls_name, None) if cls_name else owner
        real = getattr(owner, attr, None) if owner is not None else None
        if real is None:
            continue

        def wrapped(*args, _real=real, _label=label, **kwargs):
            events = None
            if on_card:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            begin = time.perf_counter()
            out = _real(*args, **kwargs)
            host_s = time.perf_counter() - begin
            if on_card:
                events[1].record()
            records.setdefault(_label, []).append((host_s, events))
            ordered.append(events)
            return out

        for key, value in vars(real).items():
            setattr(wrapped, key, value)
        patched.append((owner, attr, real))
        setattr(owner, attr, wrapped)
    try:
        if on_card:
            torch.cuda.synchronize()
        begin = time.perf_counter()
        handles = [pipe.dispatch_wave(msg_sets[i % 2], quorum=quorum, signed=signed)
                   for i in range(FUSED_DEPTH)]
        pipe.collect(handles[-1])
        wave_ms = (time.perf_counter() - begin) / FUSED_DEPTH * 1e3
        for h in handles:
            pipe._release_lease(h)
    finally:
        for owner, attr, real in reversed(patched):
            setattr(owner, attr, real)
    if on_card:
        torch.cuda.synchronize()
    parts = {}
    for label, calls in records.items():
        per_wave = len(calls) // FUSED_DEPTH or 1
        host = [sum(c[0] for c in calls[i:i + per_wave]) * 1e3
                for i in range(0, len(calls), per_wave)]
        entry = {"calls_per_wave": len(calls) / FUSED_DEPTH,
                 "host_ms": float(np.median(host))}
        if on_card:
            dev = [sum(c[1][0].elapsed_time(c[1][1]) for c in calls[i:i + per_wave])
                   for i in range(0, len(calls), per_wave)]
            entry["device_ms"] = float(np.median(dev))
        parts[label] = entry
    span = ordered[0][0].elapsed_time(ordered[-1][1]) if on_card and ordered else None
    host_parts = sum(p["host_ms"] for label, p in parts.items()
                     if label not in ("sha256_lanes", "sha256_batch"))
    line = {"signed_rows": len(signed[0]) if signed else 0, "messages": len(msg_sets[0]),
            "depth": FUSED_DEPTH, "wave_ms": wave_ms, "device_span_ms": span,
            "parts_host_ms_sum": host_parts, "parts": parts}
    log(f"fused_split {json.dumps(line)}")
    return line


def staged_copy(pipe, messages, quorum, signed=None):
    """(staged bytes, ms) of one fused wave's single host-to-device copy:
    the wave staged and dispatched as the pipeline does, then its pinned
    buffer's copy timed alone, back to back by CUDA events (the measured
    pinned copy rate, for the wave's bound)."""
    from mirbft_tpu_torch.ops.crossover import time_cuda

    packed = pipe.hasher.pack(messages)
    pipe.collect(pipe.dispatch_wave([], quorum=quorum, signed=signed, packed=packed))
    flat = packed.lease.flat[: packed.nbytes]
    ms = time_cuda(lambda: flat.to(pipe.device, non_blocking=True)) * 1e3
    return packed.nbytes, ms


TINY_WAVES = 200


def tiny_wave_dispatch():
    """The ``tiny_wave`` line: host ms a wave, dispatch to digest on the
    host, at the embedded nodes' commonest wave ([1, 2, 16]: one message
    of 100 bytes), median of TINY_WAVES: TorchHasher's staged path (one
    copy, the pack kernel, the hash kernel) and, beside it for comparison
    only, the host packer's words copied in and hashed (the dispatch the
    hasher made before the pack kernel).  Both end in the digests' copy
    back, which waits for the card."""
    import numpy as np

    from mirbft_tpu_torch.ops.sha256 import TorchHasher, pack_messages, wave_to_torch
    from mirbft_tpu_torch.ops.sha256_pallas import sha256_batch

    hasher = TorchHasher(min_device_batch=1, kernel="scan", device=DEVICE)
    message = bytes(range(100))
    want = hashlib.sha256(message).digest()

    def staged():
        return hasher.collect(hasher.dispatch([message], block_bucket=2))[0]

    def host_packed():
        blocks, n_blocks = pack_messages([message], 2)
        words = sha256_batch(*wave_to_torch(blocks, n_blocks, DEVICE))
        return bytes(words.cpu().numpy().astype(">u4").tobytes())

    out = {}
    for name, fn in (("staged", staged), ("host_packed", host_packed)):
        if fn() != want:
            raise AssertionError(f"tiny wave ({name}) != hashlib")
        times = []
        for _ in range(TINY_WAVES):
            begin = time.perf_counter()
            fn()
            times.append((time.perf_counter() - begin) * 1e3)
        out[name] = float(np.median(times))
    log(f"tiny_wave [1, 2, 16] host ms a wave, dispatch to digest, median of {TINY_WAVES}: "
        f"staged_ms={out['staged']:.6f} host_packed_ms={out['host_packed']:.6f} "
        f"(the host packer's path, for comparison only)")
    return out


def check_fused(clock):
    """Phase 4: the fused wave at the bench's width, unsigned and signed,
    against hashlib, verify_torch, verify_one and the quorum's plain
    version; its time per dispatch pipelined, beside the sum of its stages'
    bounds; and a chained pair of waves against host_fused_reference."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline, host_fused_reference
    from mirbft_tpu_torch.ops.quorum import accumulate_torch

    rng = np.random.default_rng(SEED + 3)
    msg_sets = [[rng.integers(0, 256, size=FUSED_MSG_LEN, dtype=np.uint8).tobytes()
                 for _ in range(FUSED_BATCH)] for _ in range(2)]
    expect = [[hashlib.sha256(m).digest() for m in ms] for ms in msg_sets]
    pipe = FusedCryptoPipeline(n_slots=FUSED_SLOTS, n_digest_slots=FUSED_DIGEST_SLOTS,
                               device=DEVICE)
    quorum = [(s, [(s % FUSED_BATCH, 0, None, None)]) for s in range(8)]
    stream = [torch.from_numpy(a) for a in pipe._pack_quorum(quorum, FUSED_BATCH, 1)[:3]]
    twin = [torch.zeros(tuple(pipe.masks.shape), dtype=torch.int32),
            torch.zeros(tuple(pipe.counts.shape), dtype=torch.int32)]

    def twin_wave():
        masks, counts, posts, newbits = accumulate_torch(*twin, *stream)
        twin[:] = [masks, counts]
        return posts.numpy(), newbits.numpy()

    def same_state(what):
        masks, counts = pipe.quorum_state()
        if not ((masks == twin[0].numpy().view(np.uint32)).all()
                and (counts == twin[1].numpy()).all()):
            raise AssertionError(f"fused {what}: quorum state != the plain version")

    def timed(kwargs_of, verdicts=None):
        torch_sync()
        start = time.perf_counter()
        handles = [pipe.dispatch_wave(msg_sets[i % 2], quorum=quorum, **kwargs_of(i))
                   for i in range(FUSED_DEPTH)]
        last = pipe.collect(handles[-1])
        piped = (time.perf_counter() - start) / FUSED_DEPTH
        # Every wave's digests, not only the last's: each wave's staged
        # buffer was its own while its copy was in flight.
        results = [pipe.collect(h) for h in handles[:-1]] + [last]
        for i, res in enumerate(results):
            if res.digests != expect[i % 2]:
                raise AssertionError(f"pipelined fused wave {i}: digests != hashlib")
            if verdicts is not None and not (res.verdicts == verdicts).all():
                raise AssertionError(f"pipelined fused wave {i}: verdicts != the first wave's")
        for _ in handles:
            twin_wave()
        return piped

    handle = pipe.dispatch_wave(msg_sets[0], quorum=quorum)
    res = pipe.collect(handle)
    posts, newbits = twin_wave()
    if res.digests != expect[0]:
        raise AssertionError("fused wave: digests != hashlib")
    if not ((res.posts == posts).all() and (res.newbits == newbits).all()):
        raise AssertionError("fused wave: posts or newbits != the plain version")
    same_state("wave")
    layout = handle.layout
    plain_res, plain_ms = fused_plain(msg_sets[0], quorum)
    if plain_res.digests != expect[0] or not ((plain_res.posts == posts).all()
                                              and (plain_res.newbits == newbits).all()):
        raise AssertionError("fused wave's plain version: digests, posts or newbits differ")
    # The first pass of FUSED_DEPTH waves in flight allocates their pinned
    # staging buffers (torch's caching host allocator keeps them after);
    # the second pass is the steady state that fused_wave_4096_ms reports.
    first_pass = timed(lambda i: {})
    piped = timed(lambda i: {})
    same_state("pipelined waves")
    split = fused_split(pipe, msg_sets, quorum)
    for _ in range(FUSED_DEPTH):
        twin_wave()
    same_state("split waves")

    pubs, vmsgs, sigs, corrupt = signed_rows(FUSED_SIGNED)
    signed = (pubs, vmsgs, sigs)
    handle = pipe.dispatch_wave(msg_sets[1], signed=signed, quorum=quorum)
    res = pipe.collect(handle)
    twin_wave()
    if res.digests != expect[1]:
        raise AssertionError("signed fused wave: digests != hashlib")
    arrays = pipe.verifier.pack_inputs(pubs, vmsgs, sigs)
    plain = e.verify_torch(*(torch.from_numpy(a).to(DEVICE) for a in arrays[:5]))
    want = plain.cpu().numpy()[:FUSED_SIGNED] & arrays[5][:FUSED_SIGNED]
    if not (res.verdicts == want).all():
        raise AssertionError("signed fused wave: verdicts != verify_torch")
    sample = rng.choice(FUSED_SIGNED, size=VERIFY_SAMPLE, replace=False)
    sample[:2] = corrupt[:2]
    for i in sample:
        if res.verdicts[i] != e.verify_one(pubs[i], vmsgs[i], sigs[i]):
            raise AssertionError(f"signed fused wave: row {i} != verify_one")
    ok = handle.ok.cpu().numpy()[:FUSED_SIGNED]
    rejected = int((arrays[5][corrupt] & ~ok[corrupt]).sum())
    if rejected < 1:
        raise AssertionError("signed fused wave: the kernel rejected no corrupt row")
    same_state("signed wave")
    first_pass_signed = timed(lambda i: {"signed": signed}, verdicts=res.verdicts)
    piped_signed = timed(lambda i: {"signed": signed}, verdicts=res.verdicts)
    same_state("pipelined signed waves")
    split_signed = fused_split(pipe, msg_sets, quorum, signed)
    for _ in range(FUSED_DEPTH):
        twin_wave()
    same_state("split signed waves")

    # A chain: wave 2 (a batch-layout wave of 100) gates on wave 1's digests
    # and its own; a partial collect, then full ones.
    chain_pipe = FusedCryptoPipeline(n_slots=64, n_digest_slots=2, device=DEVICE)
    pool = chain_pipe.hasher._pool
    msgs2 = msg_sets[1][:100]
    q1 = [(s, [(s, 0, s, expect[0][s]), (s + 1, 1, s, expect[0][s + 1])]) for s in range(6)]
    h1 = chain_pipe.dispatch_wave(msg_sets[0], quorum=q1)
    far = FUSED_BATCH - 96  # rows near the end of wave 1
    q2 = [(40 + s, [(s, 0, far + s, expect[0][far + s]),
                    (s, 1, h1.rows + s, expect[1][s] if s % 2 else expect[0][s])])
          for s in range(5)]
    h2 = chain_pipe.dispatch_wave(msgs2, quorum=q2, chain=h1)
    part = chain_pipe.collect_ready(h2, [99, 0, 7])
    full2 = chain_pipe.collect(h2)
    full1 = chain_pipe.collect(h1)
    zeros = (np.zeros((64, 2, 8), np.uint32), np.zeros((64, 2), np.int32))
    rd1, _, rm1, rc1, rp1, rn1 = host_fused_reference(msg_sets[0], None, q1, *zeros)
    rd2, _, rm2, rc2, rp2, rn2 = host_fused_reference(
        msgs2, None, q2, rm1, rc1, prev_digests=rd1, prev_rows=h1.rows)
    masks, counts = chain_pipe.quorum_state()
    checks = (
        full1.digests == rd1 and full2.digests == rd2,
        part.digests == [rd2[99], rd2[0], rd2[7]],
        (full1.posts[:6] == rp1[:6]).all() and (full1.newbits[:6] == rn1[:6]).all(),
        (part.posts[:5] == rp2[:5]).all() and (part.newbits[:5] == rn2[:5]).all(),
        (masks == rm2).all() and (counts == rc2).all(),
        h1.lease is None and h2.lease is None and sum(map(len, pool._free.values())) == 2,
    )
    if not all(checks):
        raise AssertionError(f"fused chain != host_fused_reference: {checks}")
    tiny = tiny_wave_dispatch()
    bound_ms, signed_bound_ms = fused_bound(pipe, quorum, FUSED_SIGNED, clock[0])
    copy_bytes, copy_ms = staged_copy(pipe, msg_sets[0], quorum)
    signed_copy_bytes, signed_copy_ms = staged_copy(pipe, msg_sets[1], quorum, signed)
    for _ in range(2):
        twin_wave()
    same_state("staged copy waves")
    log(f"fused_wave messages={FUSED_BATCH} msg_len={FUSED_MSG_LEN} layout={layout} "
        f"rows={handle.rows} quorum_waves={len(quorum)} depth={FUSED_DEPTH} "
        f"fused_wave_4096_ms={piped * 1e3:.6f} bound_ms={bound_ms:.6f} "
        f"plain_ms={plain_ms:.3f} (one wave, every kernel's plain version on the card) "
        f"signed_rows={FUSED_SIGNED} fused_wave_4096_signed_ms={piped_signed * 1e3:.6f} "
        f"signed_bound_ms={signed_bound_ms:.6f} (sums of the stages' bounds) "
        f"first_pass_ms={first_pass * 1e3:.6f} signed {first_pass_signed * 1e3:.6f} "
        f"(the same {FUSED_DEPTH} waves with their pinned buffers fresh) "
        f"staged_copy: bytes={copy_bytes} ms={copy_ms:.6f} "
        f"pinned_gb_s={copy_bytes / copy_ms / 1e6:.3f} signed bytes={signed_copy_bytes} "
        f"ms={signed_copy_ms:.6f}; bound with the copy: "
        f"{bound_ms + copy_ms:.6f}, signed {signed_bound_ms + signed_copy_ms:.6f} "
        f"corrupt_rows_rejected_by_the_kernel={rejected} of {len(corrupt)} "
        f"verify_one_rows={len(sample)} pipelined waves' digests == hashlib on all "
        f"{4 * FUSED_DEPTH}; chain: wave 2 layout={h2.layout} gated on "
        f"wave 1 rows, collect_ready + collect == host_fused_reference, leases released | "
        f"{nvidia_smi_line()}")
    return {"fused_wave_4096_ms": piped * 1e3, "fused_wave_4096_signed_ms": piped_signed * 1e3,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "signed_bound_ms": signed_bound_ms,
            "split": split, "split_signed": split_signed, "tiny_wave": tiny,
            "staged_copy": (copy_bytes, copy_ms, signed_copy_bytes, signed_copy_ms)}


def fused_plain(messages, quorum):
    """(result, ms) of one fused wave through a pipeline of its own with
    every kernel swapped for its plain version on the card (the pack, hash
    and quorum twins, ``StagedWave.pack`` on the buffer's views): the fused
    wave's plain version, dispatch to collect, timed once."""
    from mirbft_tpu_torch.ops import pack, sha256_pallas, sha256_pallas_lanes
    from mirbft_tpu_torch.ops import quorum as quorum_ops
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline
    from mirbft_tpu_torch.ops.sha256 import sha256_batch_torch

    def plain_pack(staged, flat):
        t = staged.views(flat, ("raw", "offsets", "lengths"))
        return pack.pack_wave_torch(t["raw"], t["offsets"], t["lengths"], staged.batch,
                                    staged.bucket, staged.layout)

    def plain_quorum(masks, counts, sources, touches, valid, gate):
        new_masks, new_counts, posts, newbits = quorum_ops.quorum_accumulate_torch(
            masks, counts, sources, touches, valid, gate)
        masks.copy_(new_masks)
        counts.copy_(new_counts)
        return posts, newbits

    swaps = [(sha256_pallas_lanes, "sha256_lanes", sha256_pallas_lanes.sha256_lanes_torch),
             (sha256_pallas, "sha256_batch", sha256_batch_torch),
             (quorum_ops, "quorum_accumulate", plain_quorum),
             (pack.StagedWave, "pack", plain_pack)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in swaps]
    pipe = FusedCryptoPipeline(n_slots=FUSED_SLOTS, n_digest_slots=FUSED_DIGEST_SLOTS,
                               device=DEVICE)
    try:
        for owner, attr, fn in swaps:
            setattr(owner, attr, fn)
        res, seconds = plain_once(
            lambda: pipe.collect(pipe.dispatch_wave(messages, quorum=quorum)))
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return res, seconds * 1e3


def check_fused_mxu():
    """Phase 4, "mxu": one fused wave at the bench's width (4,096 messages of
    640 bytes, eight one-touch quorum waves) with FUSED_MXU_SIGNED signed
    rows riding it (a corrupt signer's among them), on a pipeline with
    verify_kernel="mxu": digests, verdicts, posts, newbits and quorum state
    against host_fused_reference, its verdicts from the mxu kernel alone."""
    import numpy as np

    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline, host_fused_reference

    rng = np.random.default_rng(SEED + 13)
    messages = [rng.integers(0, 256, size=FUSED_MSG_LEN, dtype=np.uint8).tobytes()
                for _ in range(FUSED_BATCH)]
    pipe = FusedCryptoPipeline(n_slots=FUSED_SLOTS, n_digest_slots=FUSED_DIGEST_SLOTS,
                               verify_kernel="mxu", device=DEVICE)
    quorum = [(s, [(s % FUSED_BATCH, 0, None, None)]) for s in range(8)]
    pubs, msgs, sigs, corrupt = signed_rows(FUSED_MXU_SIGNED)
    before = (e.ed25519_verify_kernel.launches, e.ed25519_verify_mxu_kernel.launches)
    start = time.perf_counter()
    handle = pipe.dispatch_wave(messages, signed=(pubs, msgs, sigs), quorum=quorum)
    res = pipe.collect(handle)
    wave_ms = (time.perf_counter() - start) * 1e3
    launched = (e.ed25519_verify_kernel.launches - before[0],
                e.ed25519_verify_mxu_kernel.launches - before[1])
    zeros = (np.zeros((FUSED_SLOTS, FUSED_DIGEST_SLOTS, 8), np.uint32),
             np.zeros((FUSED_SLOTS, FUSED_DIGEST_SLOTS), np.int32))
    digests, verdicts, masks, counts, posts, newbits = host_fused_reference(
        messages, (pubs, msgs, sigs), quorum, *zeros)
    got_masks, got_counts = pipe.quorum_state()
    checks = {
        "resolved mxu": pipe.resolved_verify_kernel() == "mxu",
        "one mxu launch, no vpu": launched == (0, 1),
        "digests": res.digests == digests,
        "verdicts": bool((res.verdicts == verdicts).all()),
        "corrupt rejected": not res.verdicts[corrupt].any() and bool(verdicts.sum()),
        "posts, newbits": bool((res.posts == posts).all() and (res.newbits == newbits).all()),
        "quorum state": bool((got_masks == masks).all() and (got_counts == counts).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"mxu fused wave != host_fused_reference: {checks}")
    log(f"fused_wave mxu: {FUSED_BATCH} messages, {FUSED_MXU_SIGNED} signed rows "
        f"({len(corrupt)} of the corrupt signer's), {len(quorum)} quorum waves, "
        f"verify_kernel=mxu: {checks} (== host_fused_reference); launches vpu, mxu "
        f"{launched}; one wave dispatch to collect {wave_ms:.3f} ms (not pipelined)")


class LoggedWave:
    """A hash wave as the logs keep it: a staged wave's raw bytes, offsets
    and lengths (copied at dispatch; ``staged`` True), or a host-packed
    (mesh) wave's words.  ``words()`` gives its packed (blocks, n_blocks)
    on the host, as the card's pack kernel must write them;
    ``staged_tensors()`` the pack kernel's inputs on the card."""

    def __init__(self, packed):
        self.layout = packed.layout
        self.staged = hasattr(packed, "sections")
        if self.staged:
            self.shape = packed.blocks_shape
            self.batch, self.bucket = packed.batch, packed.bucket
            self.inputs = tuple(packed.section(k).copy() for k in ("raw", "offsets", "lengths"))
            self._words = None
        else:
            self.shape = packed.blocks.shape
            self._words = (packed.blocks.copy(), packed.n_blocks.copy())

    @property
    def key(self):
        return (self.layout, tuple(self.shape))

    def messages(self):
        raw, offsets, lengths = self.inputs
        return [raw[o:o + n].tobytes() for o, n in zip(offsets.tolist(), lengths.tolist())]

    def words(self):
        if self._words is None:
            from mirbft_tpu_torch.ops.sha256 import pack_messages

            packed = pack_messages(self.messages(), self.bucket, self.batch, layout=self.layout)
            self._words = (packed.blocks, packed.n_blocks)
        return self._words

    def staged_tensors(self):
        import torch

        return [torch.from_numpy(a).to(DEVICE) for a in self.inputs]


def log_wave(waves, packed):
    """Count one dispatched hash wave in ``waves`` (key -> (dispatches, the
    latest LoggedWave of that key))."""
    logged = LoggedWave(packed)
    count, _ = waves.get(logged.key, (0, None))
    waves[logged.key] = (count + 1, logged)


def wave_kernels(waves):
    """The kernels a run's logged hash waves launch: each layout's SHA-256
    kernel, and the pack kernel for staged waves."""
    names = {f"sha256_{layout}" for (layout, _) in waves}
    if any(logged.staged for _, logged in waves.values()):
        names.add("pack_wave")
    return names


def staged_waves(waves):
    """How many of a run's logged hash waves were staged (one pack launch
    each)."""
    return sum(count for count, logged in waves.values() if logged.staged)


class FusedLog:
    """Observes the fused pipeline's waves by wrapping
    ``FusedCryptoPipeline``: each dispatch's packed shape (the latest
    inputs of each shape) and signed rows, each signed wave's verdicts (its
    validity mask and the kernel's, at its first collect), and the quorum
    launches' inputs by shape (cloned before the launch, through the name
    the pipeline calls, with their valid touches).  Launches are counted
    only by the kernel wrappers."""

    def __init__(self):
        from mirbft_tpu_torch.ops import fused, quorum

        self.mod = quorum
        cls = fused.FusedCryptoPipeline
        self.cls = cls
        self.real = (cls.dispatch_wave, cls.collect, cls.collect_ready,
                     quorum.quorum_accumulate)
        self.waves = {}  # (layout, blocks shape) -> (dispatches, LoggedWave)
        self.signed = []  # signed rows per dispatch
        self.verdicts = []  # (valid, kernel verdict) per signed wave
        self.quorum = {}  # (W, D, N, K, P, B) -> (launches, inputs)
        self.touches = []  # valid touches per quorum launch (on the device until read)

    def valid_touches(self):
        return sum(int(t) for t in self.touches)

    def __enter__(self):
        dispatch, collect, collect_ready, accumulate = self.real
        log_ = self
        pending = {}  # id(handle) -> handle, signed waves not yet harvested

        def wrapped_dispatch(pipe, messages, signed=None, quorum=None, block_bucket=None,
                             batch_bucket=None, packed=None, chain=None, groups=None):
            if packed is None:
                packed = pipe.hasher.pack(messages, block_bucket, batch_bucket)
            log_wave(log_.waves, packed)
            log_.signed.append(len(signed[0]) if signed else 0)
            handle = dispatch(pipe, messages, signed, quorum, block_bucket, batch_bucket,
                              packed, chain, groups)
            if handle.ok is not None:
                pending[id(handle)] = handle
            return handle

        def harvest(handle):
            if pending.pop(id(handle), None) is not None:
                count = handle.verify_count
                log_.verdicts.append((handle.valid[:count].copy(),
                                      handle.ok.cpu().numpy()[:count]))

        def wrapped_collect(pipe, handle):
            harvest(handle)
            return collect(pipe, handle)

        def wrapped_collect_ready(pipe, handle, rows):
            harvest(handle)
            return collect_ready(pipe, handle, rows)

        def wrapped_accumulate(masks, counts, sources, touches, valid, gate):
            key = (*masks.shape[:2], *valid.shape, gate[0].shape[0], gate[1].shape[0])
            count, _ = log_.quorum.get(key, (0, None))
            inputs = tuple(t.clone() for t in (masks, counts, sources, touches, valid, *gate))
            log_.quorum[key] = (count + 1, inputs)
            log_.touches.append(valid.sum())
            return accumulate(masks, counts, sources, touches, valid, gate)

        self.cls.dispatch_wave = wrapped_dispatch
        self.cls.collect = wrapped_collect
        self.cls.collect_ready = wrapped_collect_ready
        self.mod.quorum_accumulate = wrapped_accumulate
        return self

    def __exit__(self, *exc):
        (self.cls.dispatch_wave, self.cls.collect, self.cls.collect_ready,
         self.mod.quorum_accumulate) = self.real


class WaveLog:
    """Observes the hash plane's waves (shape, count, the latest inputs of
    each shape) by wrapping ``TorchHasher.dispatch_packed``; launches are
    counted only by the kernel wrappers."""

    def __init__(self):
        from mirbft_tpu_torch.ops.sha256 import TorchHasher

        self.cls = TorchHasher
        self.real = TorchHasher.dispatch_packed
        self.waves = {}

    def __enter__(self):
        log_ = self

        def dispatch_packed(hasher, packed):
            log_wave(log_.waves, packed)
            return log_.real(hasher, packed)

        self.cls.dispatch_packed = dispatch_packed
        return self

    def __exit__(self, *exc):
        self.cls.dispatch_packed = self.real


class VerifyLog:
    """Observes the auth plane's verify waves by wrapping the verifier:
    each dispatch's rows and real rows, the packed inputs of each wave shape
    (the latest, with the dispatch's real-row mask after the six arrays),
    and each collect's validity mask and kernel verdicts. Launches are
    counted only by the kernel wrapper."""

    def __init__(self):
        from mirbft_tpu_torch.ops.ed25519 import Ed25519BatchVerifier

        self.cls = Ed25519BatchVerifier
        self.real = (self.cls.dispatch, self.cls.pack_inputs, self.cls.collect)
        self.waves = []  # (rows, real rows) per dispatch
        self.inputs = {}  # rows -> (dispatches, packed arrays)
        self.verdicts = []  # (valid, kernel verdict) per collect, real rows only
        self.real_rows = {}  # id(in-flight handle) -> its real rows
        self.dispatching_real = None  # real rows of the dispatch packing now

    def __enter__(self):
        import numpy as np

        dispatch, pack_inputs, collect = self.real
        log_ = self

        def wrapped_dispatch(verifier, pubs, msgs, sigs, n_real=None):
            real = len(pubs) if n_real is None else n_real
            log_.waves.append((len(pubs), real))
            log_.dispatching_real = real
            try:
                handle = dispatch(verifier, pubs, msgs, sigs, n_real)
            finally:
                log_.dispatching_real = None
            log_.real_rows[id(handle)] = real
            return handle

        def wrapped_pack(verifier, pubs, msgs, sigs, batch=None):
            packed = pack_inputs(verifier, pubs, msgs, sigs, batch)
            rows = packed[0].shape[0]
            count, _ = log_.inputs.get(rows, (0, None))
            real = rows if log_.dispatching_real is None else log_.dispatching_real
            log_.inputs[rows] = (count + 1, tuple(a.copy() for a in packed)
                                 + (np.arange(rows) < real,))
            return packed

        def wrapped_collect(verifier, handle):
            out = collect(verifier, handle)
            real = log_.real_rows.pop(id(handle), handle.count)
            log_.verdicts.append((handle.valid[:real].copy(), handle.ok.cpu().numpy()[:real]))
            return out

        self.cls.dispatch = wrapped_dispatch
        self.cls.pack_inputs = wrapped_pack
        self.cls.collect = wrapped_collect
        return self

    def __exit__(self, *exc):
        self.cls.dispatch, self.cls.pack_inputs, self.cls.collect = self.real


class SignClock:
    """Host seconds the simulated clients spend sealing requests (signing,
    in pure Python where the cryptography package is absent)."""

    def __init__(self):
        from mirbft_tpu_torch.testengine.recorder import SimClient

        self.cls = SimClient
        self.real = SimClient.request_by_req_no
        self.seconds = 0.0

    def __enter__(self):
        real, clock = self.real, self

        def request_by_req_no(client, req_no):
            start = time.perf_counter()
            try:
                return real(client, req_no)
            finally:
                clock.seconds += time.perf_counter() - start

        self.cls.request_by_req_no = request_by_req_no
        return self

    def __exit__(self, *exc):
        self.cls.request_by_req_no = self.real


def counted_kernels():
    """name -> wrapper of every kernel whose launches the paths count."""
    from mirbft_tpu_torch.ops import ed25519, pack, quorum
    from mirbft_tpu_torch.parallel import shard_count

    kernels = {name: entry[0] for name, entry in kernel_table().items()}
    kernels["ed25519_verify"] = ed25519.ed25519_verify_kernel
    kernels["ed25519_verify_mxu"] = ed25519.ed25519_verify_mxu_kernel
    kernels["quorum_accumulate"] = quorum.quorum_accumulate
    kernels["mesh_count"] = shard_count
    kernels["pack_wave"] = pack.pack_wave
    return kernels


def reset_launches():
    """Zero every count, after the process's verify probe (cached), whose
    launches would otherwise land in the window: a card's verifier takes
    it when it is built."""
    take_verify_probe()
    for kernel in counted_kernels().values():
        kernel.launches = 0


def read_launches():
    return {name: kernel.launches for name, kernel in counted_kernels().items()}


def verify_counter():
    """The counted kernel a verify wave of "auto" launches here: the
    port's own resolution (the environment's pin, else the probe's
    winner)."""
    from mirbft_tpu_torch.ops.crossover import resolve_verify_backend

    backend = resolve_verify_backend("auto", backend="cuda")
    return "ed25519_verify_mxu" if backend == "mxu" else "ed25519_verify"


class PinnedVerify:
    """Pins the verify backend of path ``name`` (VERIFY_PINS) by the port's
    environment override for the duration; a path without a pin runs
    "auto"."""

    def __init__(self, name):
        self.pin = VERIFY_PINS.get(name)

    def __enter__(self):
        from mirbft_tpu_torch.ops.crossover import ENV_VERIFY_KERNEL

        self.before = os.environ.get(ENV_VERIFY_KERNEL)
        if self.pin is not None:
            os.environ[ENV_VERIFY_KERNEL] = self.pin
        return self

    def __exit__(self, *exc):
        from mirbft_tpu_torch.ops.crossover import ENV_VERIFY_KERNEL

        if self.before is None:
            os.environ.pop(ENV_VERIFY_KERNEL, None)
        else:
            os.environ[ENV_VERIFY_KERNEL] = self.before


def take_verify_probe():
    """The one-time verify probe of this process (both kernels on 256 zero
    rows, cached): (vpu_s, mxu_s) and the wall seconds this call took,
    which the first call of a process spends once (the cost a card's
    first verifier pays at construction)."""
    from mirbft_tpu_torch.ops.crossover import measure_verify_probe

    start = time.perf_counter()
    probe = measure_verify_probe("cuda")
    return probe, time.perf_counter() - start


def run_spec(spec, profile=None):
    """Drain one Recording of ``spec``; with ``profile`` (a path), under
    torch.profiler tracing the card, its Chrome trace written there."""
    from mirbft_tpu_torch import metrics

    metrics.default_registry.reset()
    recording = spec.recorder().recording()
    start = time.perf_counter()
    if profile is None:
        steps = recording.drain_clients(timeout=100_000_000)
    else:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            steps = recording.drain_clients(timeout=100_000_000)
            torch_sync()
    torch_sync()
    wall = time.perf_counter() - start
    if profile is not None:
        prof.export_chrome_trace(profile)
    finals = tuple((n.state.checkpoint_seq_no, n.state.checkpoint_hash) for n in recording.nodes)
    check_checkpoints(finals)
    return recording, steps, finals, wall, metrics.snapshot()


def check_checkpoints(finals):
    """No two nodes hold different checkpoints at one sequence number."""
    by_seq = {}
    for seq, digest in finals:
        by_seq.setdefault(seq, set()).add(digest)
    if any(len(d) != 1 for d in by_seq.values()):
        raise AssertionError("divergent checkpoint")


def device_busy(trace_path):
    """(busy seconds, {name: count}, kernel records) of the device events of
    a Chrome trace: kernels, copies and fills."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    busy, names, kernels = 0.0, {}, 0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += float(ev.get("dur", 0.0)) * 1e-6
            names[ev.get("name", "?")] = names.get(ev.get("name", "?"), 0) + 1
            kernels += ev.get("cat") == "kernel"
    return busy, names, kernels


def torch_sync():
    import torch

    torch.cuda.synchronize()


def corrupt_signer(recorder):
    recorder.client_configs[CORRUPT_CLIENT].corrupt = True


def drive_paths():
    """Phase 5: the main path (c3, kernel auto), the signed c2 path, the two
    pinned-kernel 4-node paths, the 4-node signed path with a corrupt
    signer, and c3, c2 and the corrupt-signer path through the fused
    pipeline; returns per-path launches, hash waves, verify waves and
    quorum launches.

    Each path's runs go in the order of its ``order`` string: H a host-path
    run, D a device run, P a device run traced by torch.profiler.  Every run
    is held to the first host-path run of its path, or, for a fused path
    (which runs D only: the host path ignores ``fused``), of its unfused
    twin."""
    from mirbft_tpu_torch.testengine import CryptoConfig, Spec

    paths = [
        # name, Spec shape, plane, pinned hash kernel, order, Spec tweak,
        # unfused twin
        ("c3_auto", C3, dict(C3_PLANE, kernel="auto"), None, C3_ORDER, None, None),
        ("c2_signed", C2, dict(C2_PLANE, kernel="auto"), None, C2_ORDER, None, None),
        # c2 with its verify waves pinned to the "mxu" kernel (VERIFY_PINS).
        ("c2_signed_mxu", C2, dict(C2_PLANE, kernel="auto"), None, "D", None, "c2_signed"),
        ("4n_lanes", SMALL, dict(SMALL_PLANE, kernel="lanes"), "sha256_lanes", "HD", None,
         None),
        ("4n_scan", SMALL, dict(SMALL_PLANE, kernel="scan"), "sha256_batch", "HD", None, None),
        ("4n_signed_corrupt", SMALL_SIGNED, dict(SMALL_SIGNED_PLANE, kernel="auto"), None,
         "HD", corrupt_signer, None),
        ("c3_fused", C3, dict(C3_PLANE, kernel="auto", fused=True), None, C3_FUSED_ORDER,
         None, "c3_auto"),
        # With c2's hash_floor of 8 its 32 unique digests never reach the
        # card, and a fused plane would launch nothing: floor 1 sends them.
        ("c2_signed_fused", C2, dict(C2_PLANE, kernel="auto", fused=True, hash_floor=1),
         None, C2_FUSED_ORDER, None, "c2_signed"),
        ("4n_signed_corrupt_fused", SMALL_SIGNED,
         dict(SMALL_SIGNED_PLANE, kernel="auto", fused=True), None, "D", corrupt_signer,
         "4n_signed_corrupt"),
    ]
    out_dir = os.path.join(HERE, "chiprun_out")
    results, host_fps, path_walls = {}, {}, {}
    for name, shape, crypto, pinned, order, tweak, twin in paths:
        signed = shape.get("signed_requests", False)
        fused = bool(crypto.get("fused"))
        corrupt = CORRUPT_CLIENT if tweak is corrupt_signer else None
        target = {c: 0 if c == corrupt else shape["reqs_per_client"]
                  for c in range(shape["client_count"])}
        unique = sum(target.values())
        host_fp = host_fps.get(twin)
        walls, path_launches, waves, verify_inputs, quorum_inputs = (
            {"H": [], "D": []}, None, None, None, None)
        for run, kind in enumerate(order):
            if kind == "H":
                with SignClock() as signing:
                    _, steps, finals, wall, snap = run_spec(Spec(**shape, tweak_recorder=tweak))
                if host_fp is None:
                    host_fp = host_fps[name] = (steps, finals)
                elif (steps, finals) != host_fp:
                    raise AssertionError(f"{name}: host-path runs disagree")
                walls["H"].append(wall)
                log(f"path {name} run {run} host path: steps={steps} wall_s={wall:.3f}" + (
                    f" signing_s={signing.seconds:.3f} host_crypto_seconds="
                    f"{snap.get('host_crypto_seconds', 0.0):.6f}" if signed else ""))
                continue
            profile = None
            if kind == "P":
                os.makedirs(out_dir, exist_ok=True)
                profile = os.path.join(out_dir, f"trace_{name}.json")
            reset_launches()
            with WaveLog() as run_waves, VerifyLog() as run_verify, FusedLog() as run_fused, \
                    SignClock() as signing, PinnedVerify(name) as pinned_verify:
                verify_kernel = verify_counter()
                recording, steps, finals, wall, snap = run_spec(
                    Spec(**shape, tweak_recorder=tweak,
                         crypto=CryptoConfig(**crypto, torch_device=DEVICE)),
                    profile=profile,
                )
            launches = read_launches()
            if (steps, finals) != host_fp:
                raise AssertionError(f"{name}: device run diverged from the host-path run")
            for node in recording.nodes:
                got = {c: node.state.committed_reqs.get(c, 0) for c in target}
                if got != target:
                    raise AssertionError(f"{name}: node {node.id} committed {got}, not {target}")
            dispatches = int(snap.get("device_hash_dispatches", 0))
            verifies = int(snap.get("device_verify_dispatches", 0))
            fused_dispatches = int(snap.get("fused_wave_dispatches", 0))
            if signed and (verifies <= 0 or launches[verify_kernel] <= 0):
                raise AssertionError(f"{name}: no verify wave launched the kernel")
            if pinned_verify.pin is not None and launches[verify_kernel] != verifies:
                raise AssertionError(f"{name}: {verifies} verify waves, "
                                     f"{launches[verify_kernel]} {verify_kernel} launches")
            if not signed and dispatches <= 0:
                raise AssertionError(f"{name}: no device hash wave launched")
            if fused and (fused_dispatches <= 0
                          or launches["quorum_accumulate"] != fused_dispatches):
                raise AssertionError(
                    f"{name}: {fused_dispatches} fused waves, "
                    f"{launches['quorum_accumulate']} quorum launches")
            # The kernels this run resolved its waves to must each have
            # launched, and no other kernel may have.
            all_waves = dict(run_waves.waves)
            for key, (count, inputs) in run_fused.waves.items():
                all_waves[key] = (all_waves.get(key, (0, None))[0] + count, inputs)
            resolved = wave_kernels(all_waves)
            hashes = {k for k in resolved if k.startswith("sha256_")}
            if run_verify.waves or any(run_fused.signed):
                resolved.add(verify_kernel)
            if run_fused.signed:
                resolved.add("quorum_accumulate")
            if pinned is not None and hashes != {pinned}:
                raise AssertionError(f"{name}: waves resolved to {hashes}, not {pinned}")
            for kernel, count in launches.items():
                if (count > 0) != (kernel in resolved):
                    raise AssertionError(f"{name}: {kernel} launched {count} times")
            if launches["pack_wave"] != staged_waves(all_waves):
                raise AssertionError(f"{name}: {launches['pack_wave']} pack launches for "
                                     f"{staged_waves(all_waves)} staged hash waves")
            if path_launches is None:
                path_launches, waves, verify_inputs, quorum_inputs = (
                    launches, all_waves, run_verify.inputs, run_fused.quorum)
            elif launches != path_launches:
                raise AssertionError(f"{name}: launches {launches} != {path_launches}")
            if kind == "P":
                busy, names, kernels = device_busy(profile)
                head = f"path {name} run {run} device run under torch.profiler: wall_s={wall:.3f}"
                launched = sum(launches.values())
                if kernels < launched:
                    # The trace lost device records (its runtime calls are
                    # there): a busy time from it would read too low.
                    log(f"{head}; the trace holds {kernels} of the run's {launched} kernel "
                        f"launches: idle share not measured; device_events={names}")
                else:
                    log(f"{head} device_busy_s={busy:.9f} idle_share={1 - busy / wall:.9f} "
                        f"device_events={names}")
                continue
            walls["D"].append(wall)
            device_msgs = int(snap.get("device_hashed_messages", 0))
            host = {k: int(snap.get(f"host_hashed_{k}_messages", 0))
                    for k in ("fast", "oversize", "straggler")}
            total_host = sum(host.values())
            unique_host = host["oversize"] + host["straggler"]
            log(f"path {name} run {run} device run: steps={steps} (== host path) "
                f"wall_s={wall:.3f} unique_req_per_s={unique / wall:.1f} "
                f"committed={target} on every node")
            log(f"path {name} run {run} hash traffic: device_hash_dispatches={dispatches} "
                f"device_hashed_messages={device_msgs} host_hashed={host} "
                f"host_share={total_host / max(1, total_host + device_msgs):.6f} "
                f"unique_content_host_share={unique_host / max(1, unique_host + device_msgs):.6f}")
            log(f"path {name} run {run} host side of the waves: " + " ".join(
                f"{k}={snap.get(k, 0.0):.6f}" for k in (
                    "hash_pack_seconds_sum", "hash_device_dispatch_seconds_sum",
                    "device_wait_seconds_sum", "device_wait_seconds_count",
                    "host_crypto_seconds")))
            if fused:
                on_fused, touched = sum(run_fused.signed), run_fused.valid_touches()
                log(f"path {name} run {run} fused traffic: fused_wave_dispatches="
                    f"{fused_dispatches} fused_wave_messages="
                    f"{int(snap.get('fused_wave_messages', 0))} "
                    f"fused_partial_collects={int(snap.get('fused_partial_collects', 0))} "
                    f"quorum launches (W, D, N, K, P, B)="
                    f"{ {k: v[0] for k, v in run_fused.quorum.items()} } "
                    f"valid quorum touches={touched} signatures on fused waves={on_fused} "
                    f"on the auth plane's own waves={sum(real for _, real in run_verify.waves)}")
                # In the Recordings of both packages the first authenticate
                # flushes the auth plane's pending set before any hash wave
                # launches, and the plane sends no quorum touches: on the
                # paths the fused waves' verify stage and digest gate do no
                # work, and the phase-4 fused checks hold them to their
                # plain versions (ROADMAP Next 13).  Traffic that reaches
                # them on a path needs checks of its own here.
                if on_fused or touched:
                    raise AssertionError(
                        f"{name}: {on_fused} signatures and {touched} valid quorum touches "
                        f"rode fused waves; check their verdicts and quorum state here")
            if signed:
                screened = rejected = 0
                for valid, ok in run_verify.verdicts:
                    screened += int((~valid).sum())
                    rejected += int((valid & ~ok).sum())
                log(f"path {name} run {run} verify traffic: device_verify_dispatches={verifies} "
                    f"device_verified_signatures={int(snap.get('device_verified_signatures', 0))} "
                    f"waves (rows, real rows)={run_verify.waves} "
                    f"real rows the host screen rejected={screened} "
                    f"real rows the kernel rejected on the auth plane's waves={rejected} "
                    f"signing_s={signing.seconds:.3f} " +
                    " ".join(f"{k}={snap.get(k, 0.0):.6f}" for k in (
                        "verify_pack_seconds_sum", "verify_device_dispatch_seconds_sum",
                        "device_dispatch_seconds")))
                if corrupt is not None and rejected < 1:
                    raise AssertionError(f"{name}: no corrupt row reached the kernel")
            log(f"path {name} run {run} launches: {launches} waves: "
                f"{ {f'{k[0]}{list(k[1])}': v[0] for k, v in all_waves.items()} }")
        path_walls[name] = walls
        if twin is not None:
            base = path_walls[twin]
            host_s, twin_s, dev_s = (sum(w) / len(w) for w in (base["H"], base["D"], walls["D"]))
            log(f"path {name} walls in order {order.replace('P', '')}: device {walls['D']}; "
                f"{twin} host {base['H']} device {base['D']}; mean device/host "
                f"{dev_s / host_s:.4f}; mean {name}/{twin} device {dev_s / twin_s:.4f}")
        elif len(walls["H"]) > 1 or len(walls["D"]) > 1:
            host_s, dev_s = (sum(w) / len(w) for w in (walls["H"], walls["D"]))
            log(f"path {name} walls in order {order.replace('P', '')}: host {walls['H']} "
                f"device {walls['D']}; mean device/host {dev_s / host_s:.4f}")
        results[name] = (path_launches, waves, verify_inputs, quorum_inputs)
    return results, host_fps


def run_fast(spec, profile=None, **kwargs):
    """Build and drain one FastRecording of ``spec`` on the card (timed
    together: the verdict pass runs at construction); with ``profile``,
    under torch.profiler, its Chrome trace written there."""
    from mirbft_tpu_torch import metrics
    from mirbft_tpu_torch.testengine import FastRecording

    metrics.default_registry.reset()
    if profile is None:
        start = time.perf_counter()
        recording = FastRecording(spec, torch_device=DEVICE, **kwargs)
        steps = recording.drain_clients(timeout=100_000_000)
    else:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            recording = FastRecording(spec, torch_device=DEVICE, **kwargs)
            steps = recording.drain_clients(timeout=100_000_000)
            torch_sync()
    torch_sync()
    wall = time.perf_counter() - start
    if profile is not None:
        prof.export_chrome_trace(profile)
    finals = tuple((n.checkpoint_seq_no, n.checkpoint_hash) for n in recording.nodes)
    check_checkpoints(finals)
    return recording, steps, finals, wall, metrics.snapshot()


# The traced runs a fast path may take to get a trace that lost no launch.
TRACE_ATTEMPTS = 3


def fast_paths():
    """name -> (Spec shape, FastRecording keywords, run order, Spec tweak,
    the Recording path whose host-path run it is held to)."""
    auth_wave = C2_PLANE["auth_wave"]
    return {
        "c3_64n_fast": (C3, dict(pipeline=True), C3_FAST_ORDER, None, "c3_auto"),
        "c3_64n_fast_auth": (C3, dict(pipeline=True, device_authoritative=True), "D", None,
                             "c3_auto"),
        "c2_16n_signed_fast": (C2, dict(auth_wave=auth_wave), C2_FAST_ORDER, None,
                               "c2_signed"),
        "c2_16n_signed_fast_streaming": (
            C2, dict(auth_wave=auth_wave, streaming_auth=True), "D", None, "c2_signed"),
        # c2's one 1,024-row verdict wave on the "mxu" kernel (VERIFY_PINS).
        "c2_16n_signed_fast_mxu": (C2, dict(auth_wave=auth_wave), "D", None, "c2_signed"),
        "4n_signed_corrupt_fast": (
            SMALL_SIGNED, dict(auth_wave=SMALL_SIGNED_PLANE["auth_wave"]), "D",
            corrupt_signer, "4n_signed_corrupt"),
    }


def fast_device_run(name, profile=None):
    """One device run of fast path ``name`` (traced into ``profile`` when
    given).  Returns what drive_fast_paths checks and logs, as JSON-ready
    data, and the hash waves and verify inputs the report times."""
    from mirbft_tpu_torch.ops.crossover import measure_hash_probe
    from mirbft_tpu_torch.testengine import Spec

    shape, keywords, _, tweak, _ = fast_paths()[name]
    reset_launches()
    probes = measure_hash_probe.cache_info().misses
    with WaveLog() as waves, VerifyLog() as verify, SignClock() as signing, \
            PinnedVerify(name):
        verify_kernel = verify_counter()
        recording, steps, finals, wall, snap = run_fast(
            Spec(**shape, tweak_recorder=tweak), profile=profile, device=True, **keywords)
    screened = rejected = 0
    for valid, ok in verify.verdicts:
        screened += int((~valid).sum())
        rejected += int((valid & ~ok).sum())
    run = {
        "steps": steps,
        "finals": [[seq, digest.hex()] for seq, digest in finals],
        "wall": wall,
        "launches": read_launches(),
        "resolved": sorted(wave_kernels(waves.waves)
                           | ({verify_kernel} if verify.waves else set())),
        "verify_kernel": verify_kernel,
        "staged_waves": staged_waves(waves.waves),
        "probes": measure_hash_probe.cache_info().misses - probes,
        "committed": [{str(c): n for c, n in node.committed_reqs.items()}
                      for node in recording.nodes],
        "device_stall_s": recording.device_stall_s,
        "host_crypto_seconds": recording.host_crypto_seconds(),
        "engine_hash_s": recording._engine.stats()[3],
        "signing_s": signing.seconds,
        "screened": screened,
        "rejected": rejected,
        "verify_waves": verify.waves,
        "hash_waves": {f"{k[0]}{list(k[1])}": v[0] for k, v in waves.waves.items()},
    }
    for key in ("device_hash_dispatches", "device_hashed_messages", "device_verify_dispatches",
                "device_verified_signatures", "device_wait_seconds_sum",
                "device_wait_seconds_count"):
        run[key] = snap.get(key, 0)
    return run, waves.waves, verify.inputs


def traced_fast_child(name):
    """``chip_smoke.py --traced-fast NAME``: one traced device run of a fast
    path, in a process of its own, its busy time read from the trace; the
    run's data on the last line.  In the smoke's own process, after its
    earlier phases, torch.profiler dropped the first device records of
    most traced fast runs (their launches' runtime calls were in the
    trace); a fresh process's traces have kept them."""
    from mirbft_tpu_torch import _native
    from mirbft_tpu_torch.ops.crossover import hash_crossover_batch

    if _native.load_fast() is None:
        raise AssertionError("the fast engine is not built")
    hash_crossover_batch("cuda")  # TorchHasher's probe, outside the window
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    profile = os.path.join(out_dir, f"trace_{name}.json")
    run, _, _ = fast_device_run(name, profile=profile)
    run["busy"], run["events"], _ = device_busy(profile)
    print(json.dumps(run), flush=True)
    return 0


def traced_in_child(name):
    """traced_fast_child's data, from a child process."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--traced-fast", name],
        cwd=HERE, capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        raise AssertionError(f"{name}: the traced run failed: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def drive_fast_paths(host_fps):
    """Phase 6: the native engine's paths, each run held to the
    host-path fingerprint of its Recording path in ``host_fps``.  The mirror
    waves' digests are checked against the engine's by FastRecording
    itself; every device run must launch exactly the kernels its waves
    resolved to.  Returns per-path launches, hash waves and verify waves,
    as drive_paths does."""
    from mirbft_tpu_torch.testengine import Spec

    results, mirror_hash_s = {}, None
    for name, (shape, keywords, order, tweak, held_to) in fast_paths().items():
        signed = shape.get("signed_requests", False)
        corrupt = CORRUPT_CLIENT if tweak is not None else None
        target = {c: 0 if c == corrupt else shape["reqs_per_client"]
                  for c in range(shape["client_count"])}
        unique = sum(target.values())
        host_fp = host_fps[held_to]
        walls, path_launches, waves, verify_inputs = {"H": [], "D": []}, None, None, None
        kinds = list(order)
        # A traced run whose trace lost a launch appends another (the loop
        # reaches what is appended to the list it walks).
        for index, kind in enumerate(kinds):
            if kind == "H":
                recording, steps, finals, wall, _ = run_fast(
                    Spec(**shape, tweak_recorder=tweak), pipeline=keywords.get("pipeline"))
                if (steps, finals) != host_fp:
                    raise AssertionError(f"{name}: host-path run diverged from {held_to}'s")
                walls["H"].append(wall)
                log(f"fast {name} run {index} host path: steps={steps} (== {held_to}) "
                    f"wall_s={wall:.6f} unique_req_per_s={unique / wall:.1f} "
                    f"host_crypto_seconds={recording.host_crypto_seconds():.6f} "
                    f"engine_hash_s={recording._engine.stats()[3]:.6f}")
                continue
            if kind == "P":
                run = traced_in_child(name)
            else:
                run, run_waves, run_inputs = fast_device_run(name)
            steps, wall, launches = run["steps"], run["wall"], run["launches"]
            finals = tuple((seq, bytes.fromhex(digest)) for seq, digest in run["finals"])
            if (steps, finals) != host_fp:
                raise AssertionError(f"{name}: device run diverged from {held_to}'s host path")
            for node in run["committed"]:
                got = {c: node.get(str(c), 0) for c in target}
                if got != target:
                    raise AssertionError(f"{name}: a node committed {got}, not {target}")
            dispatches = run["device_hash_dispatches"]
            verifies = run["device_verify_dispatches"]
            if not signed and dispatches <= 0:
                raise AssertionError(f"{name}: no device hash wave launched")
            if keywords.get("device_authoritative"):
                if mirror_hash_s is None or run["engine_hash_s"] > mirror_hash_s:
                    raise AssertionError(
                        f"{name}: the engine hashed {run['engine_hash_s']} s on the host, "
                        f"the mirror run {mirror_hash_s} s")
            elif not signed:
                mirror_hash_s = run["engine_hash_s"]
            if signed:
                # Bitmap mode verifies every signed row (the corrupt
                # signer's too) before the run, in waves of auth_wave;
                # streaming mode in several lookahead passes.  Each
                # dispatch launches the kernel once.
                rows = shape["client_count"] * shape["reqs_per_client"]
                want = -(-rows // keywords["auth_wave"])
                counter = run["verify_kernel"]
                if (verifies <= 1 if keywords.get("streaming_auth") else verifies != want) \
                        or launches[counter] != verifies:
                    raise AssertionError(
                        f"{name}: {verifies} verify dispatches ({want} waves of the pre-run "
                        f"pass) and {launches[counter]} {counter} launches")
                if corrupt is not None and run["rejected"] < 1:
                    raise AssertionError(f"{name}: no corrupt row reached the kernel")
            for kernel, count in launches.items():
                if (count > 0) != (kernel in run["resolved"]):
                    raise AssertionError(f"{name}: {kernel} launched {count} times")
            if launches["pack_wave"] != run["staged_waves"]:
                raise AssertionError(f"{name}: {launches['pack_wave']} pack launches for "
                                     f"{run['staged_waves']} staged hash waves")
            if path_launches is None:
                path_launches, waves, verify_inputs = launches, run_waves, run_inputs
            elif launches != path_launches:
                raise AssertionError(f"{name}: launches {launches} != {path_launches}")
            head = (f"fast {name} run {index} device run"
                    f"{' under torch.profiler, in a process of its own' if kind == 'P' else ''}: "
                    f"steps={steps} (== {held_to}) wall_s={wall:.6f} "
                    f"unique_req_per_s={unique / wall:.1f} committed={target} on every node "
                    f"device_stall_s={run['device_stall_s']:.6f} "
                    f"device_wait_seconds_sum={run['device_wait_seconds_sum']:.6f} "
                    f"device_wait_seconds_count={int(run['device_wait_seconds_count'])} "
                    f"host_crypto_seconds={run['host_crypto_seconds']:.6f} "
                    f"engine_hash_s={run['engine_hash_s']:.6f} "
                    f"crossover_probes_in_window={run['probes']}")
            if kind == "P":
                busy, names = run["busy"], run["events"]
                lost = {k: n for k, n in launches.items()
                        if sum(c for event, c in names.items() if k in event) < n}
                if lost:
                    log(f"{head}; the trace lost launches of {lost}: idle share not "
                        f"measured; device_events={names}")
                    if kinds.count("P") < TRACE_ATTEMPTS:
                        kinds.append("P")
                else:
                    log(f"{head} device_busy_s={busy:.9f} idle_share={1 - busy / wall:.9f} "
                        f"device_events={names}")
                continue
            walls["D"].append(wall)
            log(head)
            log(f"fast {name} run {index} traffic: device_hash_dispatches={dispatches} "
                f"device_hashed_messages={run['device_hashed_messages']} "
                f"device_verify_dispatches={verifies} "
                f"device_verified_signatures={run['device_verified_signatures']} "
                f"verify waves (rows, real rows)={run['verify_waves']} launches={launches} "
                f"hash waves={run['hash_waves']}"
                + (f" signing_s={run['signing_s']:.3f}" if signed else ""))
            if signed:
                log(f"fast {name} run {index} verdicts: real rows the host screen rejected="
                    f"{run['screened']} real rows the kernel rejected={run['rejected']}")
        if walls["H"] and walls["D"]:
            host_s, dev_s = (sum(w) / len(w) for w in (walls["H"], walls["D"]))
            log(f"fast {name} walls in order {order.replace('P', '')}: host {walls['H']} "
                f"device {walls['D']}; mean device/host {dev_s / host_s:.4f}")
        results[name] = (path_launches, waves, verify_inputs, None)
    return results



# Phase 7, deploy.  The cohost plane's wave at bench.py's anatomy shape
# (bench_cohost_fused, bench.py:1893-1965): 2 groups x 96 rows of 608-byte
# messages, one fixed wave of 192, six timed rounds; the signed mux wave's
# 1,024 rows, split between the two tenants' auth planes (8 clients x 64
# requests each, group 0's client 3 a corrupt signer); the mux Recordings'
# shared wave, fixed at the planes' own hash_wave (at 192 neither c2's nor
# c3's rows ever fill a wave, and every one is hashed on the host); the
# embedded node runtime at c2's load (16 clients x
# 50 signed requests on 4 threaded nodes); and the cohost deployment of
# tools/mirnet.py (2 groups x 4 nodes, 200 requests a group).
MUX_GROUPS, MUX_ROWS, MUX_MSG_LEN, MUX_ROUNDS = 2, 96, 608, 6
MUX_SIGNED_CLIENTS, MUX_SIGNED_REQS = 8, 64
MUX_REC_WAVE = C3_PLANE["hash_wave"]
NODE_COUNT, NODE_CLIENTS, NODE_REQS, NODE_TICK, NODE_BATCH = 4, 16, 50, 0.02, 100
COHOST = dict(groups=2, nodes_per_group=4, reqs_per_group=200, layout="cohost")


def check_stream_shared():
    """The cohost plane and the embedded nodes' hashers are called from
    many threads, and a group's collect may run on another thread than its
    dispatch: every thread must enqueue on, and wait for, one stream.  A
    thread's current stream is the device's default (legacy) stream unless
    it sets another, and nothing in the port does."""
    import threading

    import torch

    if DEVICE != "cuda":
        return
    seen = {}
    worker = threading.Thread(
        target=lambda: seen.update(s=torch.cuda.current_stream(DEVICE).cuda_stream))
    worker.start()
    worker.join()
    main = torch.cuda.current_stream(DEVICE).cuda_stream
    default = torch.cuda.default_stream(DEVICE).cuda_stream
    if not seen["s"] == main == default:
        raise AssertionError(f"streams differ: worker {seen['s']} main {main} default {default}")
    log(f"deploy streams: a worker thread's current stream {seen['s']:#x} == the main "
        f"thread's == the default stream")


def mux_rows(tag, r):
    pad = b"\x00" * MUX_MSG_LEN  # past the 512-byte host fast path: rows take the card
    return [[[b"cohost-%s-%d-%d-%d" % (tag, r, g, i) + pad] for i in range(MUX_ROWS)]
            for g in range(MUX_GROUPS)]


def signed_mux_envelopes():
    """The signed mux wave's requests: MUX_SIGNED_CLIENTS clients a group,
    MUX_SIGNED_REQS sealed requests each, group 0's CORRUPT_CLIENT with a
    tampered R.  Returns (keys, envelopes, provider, signed rows)."""
    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.processor.verify import seal, signing_payload

    keys = {}
    envelopes = {}
    for g in range(MUX_GROUPS):
        for c in range(MUX_SIGNED_CLIENTS):
            cid = 100 * g + c
            pub, sign = e.keypair_from_seed(bytes([g + 1, c + 1]) * 16)
            keys[cid] = pub
            for r in range(MUX_SIGNED_REQS):
                payload = b"mux-signed-%d-%d" % (cid, r)
                sig = sign(signing_payload(cid, r, payload))
                if g == 0 and c == CORRUPT_CLIENT:
                    sig = sig[:5] + bytes([sig[5] ^ 0x10]) + sig[6:]  # R tampered, S < L
                envelopes[cid, r] = seal(payload, sig)

    def provider(client_id, start_req):
        return [(r, envelopes[client_id, r])
                for r in range(start_req, MUX_SIGNED_REQS) if (client_id, r) in envelopes]

    return keys, envelopes, provider, MUX_GROUPS * MUX_SIGNED_CLIENTS * MUX_SIGNED_REQS


def signed_mux_wave(keys, provider, n_signed):
    """One mux wave carrying both tenants' pending signatures, on a fresh
    pipeline, mux and planes, as a cohost host's first signed wave: each
    tenant's digest against hashlib.  Returns (seconds from the enqueue to
    both tenants' collects, the pipeline, the tenants' auth planes)."""
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline
    from mirbft_tpu_torch.testengine.crypto import (
        DeviceAuthPlane,
        DeviceHashPlane,
        SharedWaveMux,
    )

    pipe = FusedCryptoPipeline(n_groups=MUX_GROUPS, device=DEVICE)
    mux = SharedWaveMux(pipe, wave_size=MUX_GROUPS, adaptive=False)
    auths, tenants = [], []
    for g in range(MUX_GROUPS):
        auth = DeviceAuthPlane(provider, device=True, wave_size=2 * n_signed,
                               device_floor=1, lookahead=MUX_SIGNED_REQS, torch_device=DEVICE)
        hash_plane = DeviceHashPlane(device=True, wave_size=MUX_GROUPS, device_floor=1,
                                     torch_device=DEVICE)
        hash_plane.attach_mux(mux, g, auth)
        for c in range(MUX_SIGNED_CLIENTS):
            auth.register(100 * g + c, keys[100 * g + c])
            auth.note(100 * g + c, 0)
        auths.append(auth)
        tenants.append(hash_plane)
    hash_batches = [[[b"signed-wave-%d" % g, bytes([g]) * MUX_MSG_LEN]] for g in range(MUX_GROUPS)]
    torch_sync()
    start = time.perf_counter()
    for g in range(MUX_GROUPS):
        tenants[g].enqueue(hash_batches[g])
    for g in range(MUX_GROUPS):
        got = tenants[g].hash_batches(hash_batches[g])
        if got != [hashlib.sha256(b"".join(hash_batches[g][0])).digest()]:
            raise AssertionError(f"signed mux wave: group {g} digest != hashlib")
    return time.perf_counter() - start, pipe, auths


def check_mux_waves():
    """Phase 7, part 1: the cohost plane's shared wave on the card at the
    bench's anatomy shape, against hashlib and two solo per-group fused
    pipelines on the same rows (one tenant's collect on another thread);
    one mux wave carrying both tenants' signatures, each group's verdicts
    against verify_torch on the card with the forgery in its own group;
    and a multi-group gated quorum wave against its plain version."""
    import threading

    import numpy as np
    import torch

    from mirbft_tpu_torch import metrics
    from mirbft_tpu_torch.groups.cohost import CohostCryptoPlane
    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline, host_fused_reference
    from mirbft_tpu_torch.ops.quorum import quorum_accumulate_torch
    from mirbft_tpu_torch.processor.verify import seal, signing_payload
    from mirbft_tpu_torch.testengine.crypto import (
        DeviceAuthPlane,
        DeviceHashPlane,
        SharedWaveMux,
    )

    check_stream_shared()
    metrics.default_registry.reset()
    wave = MUX_GROUPS * MUX_ROWS
    plane = CohostCryptoPlane(MUX_GROUPS, wave_size=wave, adaptive=False, torch_device=DEVICE)
    muxed = [plane.hasher_for(g) for g in range(MUX_GROUPS)]
    solo = []
    for _ in range(MUX_GROUPS):
        p = DeviceHashPlane(device=True, wave_size=wave, adaptive=False, torch_device=DEVICE)
        p.attach_fused(FusedCryptoPipeline(device=DEVICE))
        solo.append(p)

    def run_round(hashers, batches):
        handles = [hashers[g].dispatch_batches(batches[g]) for g in range(MUX_GROUPS)]
        out = {}
        # The last tenant collects on a thread of its own, as a cohost
        # host's nodes do.
        last = MUX_GROUPS - 1
        worker = threading.Thread(
            target=lambda: out.update({last: hashers[last].collect_batches(handles[last])}))
        worker.start()
        for g in range(last):
            out[g] = hashers[g].collect_batches(handles[g])
        worker.join()
        return [out[g] for g in range(MUX_GROUPS)]

    def timed(hashers, tag):
        rounds = [mux_rows(tag, r) for r in range(MUX_ROUNDS + 1)]
        first = run_round(hashers, rounds[0])  # warm
        torch_sync()
        start = time.perf_counter()
        digests = [run_round(hashers, batches) for batches in rounds[1:]]
        torch_sync()
        return (time.perf_counter() - start) / MUX_ROUNDS, [first] + digests, rounds

    muxed_s, muxed_digests, rounds = timed(muxed, b"anatomy")
    occupancy = metrics.gauge("fused_wave_occupancy").value
    groups_per_wave = metrics.gauge("wave_mux_groups_per_wave").value
    mux_dispatches = int(metrics.counter("fused_wave_dispatches").value)
    solo_s, solo_digests, _ = timed(solo, b"anatomy")
    for r, batches in enumerate(rounds):
        for g in range(MUX_GROUPS):
            want = [hashlib.sha256(parts[0]).digest() for parts in batches[g]]
            if muxed_digests[r][g] != want:
                raise AssertionError(f"mux wave round {r} group {g}: digests != hashlib")
            if solo_digests[r][g] != want:
                raise AssertionError(f"solo wave round {r} group {g}: digests != hashlib")
    if mux_dispatches != MUX_ROUNDS + 1 or groups_per_wave != MUX_GROUPS:
        raise AssertionError(f"{mux_dispatches} mux waves of {groups_per_wave} groups for "
                             f"{MUX_ROUNDS + 1} rounds of {MUX_GROUPS} groups")
    log(f"deploy mux wave: groups={MUX_GROUPS} rows_per_group={MUX_ROWS} "
        f"msg_len={MUX_MSG_LEN} wave={wave} rounds={MUX_ROUNDS} digests == hashlib == two "
        f"solo fused pipelines, last tenant collected on another thread; "
        f"fused_wave_occupancy={occupancy:.6f} groups_per_wave={groups_per_wave:.0f} "
        f"mux_wave_ms={muxed_s * 1e3:.6f} (one shared wave a round) "
        f"solo_waves_ms={solo_s * 1e3:.6f} (two per-group waves a round) "
        f"solo/mux={solo_s / muxed_s:.4f} | {nvidia_smi_line()}")

    # One mux wave that carries both tenants' pending signatures.
    keys, envelopes, provider, n_signed = signed_mux_envelopes()
    with FusedLog() as flog:
        signed_s, pipe, auths = signed_mux_wave(keys, provider, n_signed)
    if flog.signed != [n_signed] or [a.verified_count for a in auths] != \
            [n_signed // MUX_GROUPS] * MUX_GROUPS:
        raise AssertionError(f"signed mux wave: rows per wave {flog.signed}, verified "
                             f"{[a.verified_count for a in auths]}")
    order = sorted(envelopes)
    pubs = [keys[cid] for cid, _ in order]
    msgs, sigs = [], []
    for cid, r in order:
        payload, sig = envelopes[cid, r][:-64], envelopes[cid, r][-64:]
        msgs.append(signing_payload(cid, r, payload))
        sigs.append(sig)
    arrays = pipe.verifier.pack_inputs(pubs, msgs, sigs)
    plain = e.verify_torch(*(torch.from_numpy(a).to(DEVICE) for a in arrays[:5]))
    want = plain.cpu().numpy()[: len(order)] & arrays[5][: len(order)]
    got = np.array([auths[cid // 100].authenticate(cid, r, envelopes[cid, r])
                    for cid, r in order])
    if not (got == want).all():
        raise AssertionError("signed mux wave: a group's verdicts != verify_torch")
    corrupt = [i for i, (cid, _) in enumerate(order) if cid == CORRUPT_CLIENT]
    valid, ok = flog.verdicts[0]
    # The wave's verify stage holds group 0's rows, then group 1's, in
    # the order the tenants' auth planes queued them: map by (client, req).
    if sorted(np.flatnonzero(~got)) != corrupt:
        raise AssertionError("signed mux wave: rejections outside group 0's corrupt signer")
    kernel_rejected = int((valid & ~ok).sum())
    if kernel_rejected < 1:
        raise AssertionError("signed mux wave: the kernel rejected no corrupt row")
    if [a.verified_count for a in auths] != [n_signed // MUX_GROUPS] * MUX_GROUPS:
        raise AssertionError("signed mux wave: verdicts were verified again on the host")
    log(f"deploy signed mux wave: signed_rows={n_signed} in one wave, "
        f"{n_signed // MUX_GROUPS} a group (verify slices), verdicts == verify_torch, "
        f"corrupt signer's rows={len(corrupt)}, all rejected and all in group 0, "
        f"{kernel_rejected} of them by the kernel (the rest by the host screen); "
        f"signed_mux_wave_ms={signed_s * 1e3:.6f} (dispatch to both tenants' collects)")

    # A gated quorum wave over both tenants' slabs.
    rng = np.random.default_rng(SEED + 7)
    msgs = [rng.integers(0, 256, size=MUX_MSG_LEN, dtype=np.uint8).tobytes()
            for _ in range(MUX_GROUPS * MUX_ROWS)]
    groups = [i % MUX_GROUPS for i in range(len(msgs))]
    digests = [hashlib.sha256(m).digest() for m in msgs]
    quorum = []
    for w in range(64):
        g = w % MUX_GROUPS
        rows = []
        for k in range(8):
            row = int(rng.integers(0, len(msgs)))
            kind = k % 4  # own row right claim, own row wrong claim, other tenant's, ungated
            if kind == 0:
                row -= (groups[row] - g) % MUX_GROUPS
                rows.append((int(rng.integers(0, FUSED_SLOTS)), k % 4, row, digests[row]))
            elif kind == 1:
                rows.append((int(rng.integers(0, FUSED_SLOTS)), 1, row, b"\xff" * 32))
            elif kind == 2:
                row += 1 if groups[row] == g else 0
                row %= len(msgs)
                rows.append((int(rng.integers(0, FUSED_SLOTS)), 2, row, digests[row]))
            else:
                rows.append((int(rng.integers(0, FUSED_SLOTS)), 3, None, None))
        quorum.append((g, w, rows))
    qpipe = FusedCryptoPipeline(n_slots=FUSED_SLOTS, n_digest_slots=FUSED_DIGEST_SLOTS,
                                n_groups=MUX_GROUPS, device=DEVICE)
    with FusedLog() as flog:
        res = qpipe.collect(qpipe.dispatch_wave(msgs, quorum=quorum, groups=groups))
    ((_, inputs),) = flog.quorum.values()
    masks, counts, posts, newbits = quorum_accumulate_torch(*inputs[:5], tuple(inputs[5:]))
    torch_sync()
    dev_masks, dev_counts = qpipe.quorum_state()
    if not ((dev_masks == masks.cpu().numpy().view(np.uint32)).all()
            and (dev_counts == counts.cpu().numpy()).all()
            and (res.posts == posts.cpu().numpy()).all()
            and (res.newbits == newbits.cpu().numpy()).all()):
        raise AssertionError("multi-group quorum wave != accumulate_torch")
    zeros = (np.zeros(tuple(qpipe.masks.shape), np.uint32),
             np.zeros(tuple(qpipe.counts.shape), np.int32))
    rd, _, rm, rc, _, _ = host_fused_reference(msgs, None, quorum, *zeros, groups=groups,
                                               n_slots=FUSED_SLOTS)
    if res.digests != rd or not ((dev_masks == rm).all() and (dev_counts == rc).all()):
        raise AssertionError("multi-group quorum wave != host_fused_reference")
    opened = int(np.asarray(res.posts[: len(quorum)]).astype(bool).sum())
    log(f"deploy multi-group quorum wave: groups={MUX_GROUPS} slots={FUSED_SLOTS} a group "
        f"waves={len(quorum)} K=8 (own-row right claims, wrong claims, other tenant's rows "
        f"with the right digest, ungated) == accumulate_torch and host_fused_reference; "
        f"touches that posted={opened}")
    return {"mux_wave_ms": muxed_s * 1e3, "solo_waves_ms": solo_s * 1e3,
            "signed_mux_wave_ms": signed_s * 1e3}


def drain_interleaved(recordings, timeout=100_000_000):
    """Round-robin ``step()`` across co-hosted recordings until each meets
    drain_clients' completion condition; per-recording step counts."""

    def done(rec):
        target = {c.config.id: 0 if c.config.corrupt else c.config.total
                  for c in rec.clients.values()}
        for node in rec.nodes:
            for client_state in node.state.checkpoint_state.clients:
                want = target.get(client_state.id)
                if want is not None and want != client_state.low_watermark:
                    return False
        finished = {cid for cid, total in target.items() if total == 0 or any(
            node.state.committed_reqs.get(cid, 0) >= total for node in rec.nodes)}
        return finished >= set(target)

    steps = [0] * len(recordings)
    finished = [False] * len(recordings)
    while not all(finished):
        for k, rec in enumerate(recordings):
            if finished[k]:
                continue
            steps[k] += 1
            rec.step()
            finished[k] = done(rec)
            if steps[k] > timeout:
                raise AssertionError("interleaved drain stalled")
    return steps


def drive_mux_recordings(host_fps):
    """Phase 7, part 2: c2_signed's and c3's Recordings as two co-hosted
    groups on one SharedWaveMux over a 2-group fused pipeline on the card,
    stepped in turns; each held to its phase-5 host-path fingerprint."""
    from mirbft_tpu_torch import metrics
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline
    from mirbft_tpu_torch.testengine import CryptoConfig, Spec
    from mirbft_tpu_torch.testengine.crypto import SharedWaveMux

    # c2's plane with hash_floor 1, as on c2_signed_fused: at its floor of
    # 8 its 32 unique digests are all hashed on the host and group 0 would
    # send the mux nothing.
    tenants = (("c2_signed", C2, dict(C2_PLANE, hash_floor=1)), ("c3_auto", C3, C3_PLANE))
    metrics.default_registry.reset()
    pipe = FusedCryptoPipeline(n_groups=len(tenants), device=DEVICE)
    mux = SharedWaveMux(pipe, wave_size=MUX_REC_WAVE, adaptive=False)
    recordings = [
        Spec(**shape, crypto=CryptoConfig(**plane, kernel="auto", torch_device=DEVICE, mux=mux,
                                          mux_group=g)).recorder().recording()
        for g, (_, shape, plane) in enumerate(tenants)
    ]
    reset_launches()
    with WaveLog() as run_waves, VerifyLog() as run_verify, FusedLog() as run_fused:
        start = time.perf_counter()
        steps = drain_interleaved(recordings)
        torch_sync()
        wall = time.perf_counter() - start
    launches = read_launches()
    snap = metrics.snapshot()
    for g, ((name, shape, _), recording) in enumerate(zip(tenants, recordings)):
        finals = tuple((n.state.checkpoint_seq_no, n.state.checkpoint_hash)
                       for n in recording.nodes)
        check_checkpoints(finals)
        if (steps[g], finals) != host_fps[name]:
            raise AssertionError(f"mux group {g}: steps and checkpoints != {name}'s host path")
        for node in recording.nodes:
            got = {c: node.state.committed_reqs.get(c, 0) for c in range(shape["client_count"])}
            if set(got.values()) != {shape["reqs_per_client"]}:
                raise AssertionError(f"mux group {g}: node {node.id} committed {got}")
    dispatches = int(snap.get("fused_wave_dispatches", 0))
    all_waves = dict(run_waves.waves)
    for key, (count, inputs) in run_fused.waves.items():
        all_waves[key] = (all_waves.get(key, (0, None))[0] + count, inputs)
    resolved = wave_kernels(all_waves)
    if run_verify.waves or any(run_fused.signed):
        resolved.add(verify_counter())
    if run_fused.signed:
        resolved.add("quorum_accumulate")
    for kernel, count in launches.items():
        if (count > 0) != (kernel in resolved):
            raise AssertionError(f"mux recordings: {kernel} launched {count} times")
    if launches["pack_wave"] != staged_waves(all_waves):
        raise AssertionError(f"mux recordings: {launches['pack_wave']} pack launches for "
                             f"{staged_waves(all_waves)} staged hash waves")
    if dispatches <= 0 or launches["quorum_accumulate"] != dispatches or \
            run_waves.waves:
        raise AssertionError(f"mux recordings: {dispatches} mux waves, {launches} launches, "
                             f"plain hash waves {run_waves.waves}")
    on_mux, touched = sum(run_fused.signed), run_fused.valid_touches()
    rows = {g: int(snap.get(f'wave_mux_rows_total{{group="{g}"}}', 0)) for g in range(2)}
    log(f"deploy mux recordings: {tenants[0][0]} (group 0) and {tenants[1][0]} (group 1) "
        f"stepped in turns on one mux (wave {MUX_REC_WAVE}, fixed): steps={steps} "
        f"(== their host paths) wall_s={wall:.3f} committed every request on every node")
    log(f"deploy mux recordings fused traffic: fused_wave_dispatches={dispatches} "
        f"fused_wave_messages={int(snap.get('fused_wave_messages', 0))} "
        f"wave_mux_rows_total={rows} groups_per_wave(last)="
        f"{snap.get('wave_mux_groups_per_wave', 0)} "
        f"fused_partial_collects={int(snap.get('fused_partial_collects', 0))} "
        f"quorum launches (W, D, N, K, P, B)={ {k: v[0] for k, v in run_fused.quorum.items()} } "
        f"valid quorum touches={touched} signatures on mux waves={on_mux} "
        f"on the auth plane's own waves={sum(real for _, real in run_verify.waves)} "
        f"launches={launches} waves="
        f"{ {f'{k[0]}{list(k[1])}': v[0] for k, v in all_waves.items()} }")
    # As on the fused paths: the auth plane flushes its own pending set at
    # the first authenticate, so no signature rides a mux wave, and the
    # hash plane sends no quorum touches; the signed mux wave and the
    # quorum wave of part 1 hold those stages.
    if on_mux or touched:
        raise AssertionError(f"mux recordings: {on_mux} signatures and {touched} valid quorum "
                             f"touches rode mux waves; check them here")
    if min(rows.values()) <= 0:
        raise AssertionError(f"mux recordings: a tenant sent no rows {rows}")
    return launches, all_waves, run_verify.inputs, run_fused.quorum


class _Transport:
    """In-memory links between threaded nodes: one delivery thread and one
    bounded queue a node, dropping on overflow (the protocol tolerates
    loss)."""

    def __init__(self, node_count, buffer=10000):
        import queue
        import threading

        self._queue_mod = queue
        self.queues = [queue.Queue(maxsize=buffer) for _ in range(node_count)]
        self.nodes = []
        self.threads = []
        self.stopping = threading.Event()

    def link(self, source):
        transport = self

        class _Link:
            def send(self, dest, msg):
                try:
                    transport.queues[dest].put_nowait((source, msg))
                except transport._queue_mod.Full:
                    pass

        return _Link()

    def start(self, nodes):
        import threading

        self.nodes = nodes
        for i in range(len(nodes)):
            thread = threading.Thread(target=self._deliver, args=(i,), daemon=True)
            thread.start()
            self.threads.append(thread)

    def _deliver(self, dest):
        while not self.stopping.is_set():
            try:
                source, msg = self.queues[dest].get(timeout=0.05)
            except self._queue_mod.Empty:
                continue
            try:
                self.nodes[dest].step(source, msg)
            except Exception:
                return  # the node stopped

    def stop(self):
        self.stopping.set()
        for thread in self.threads:
            thread.join(timeout=5)


class _CommitLog:
    """An app that keeps every applied entry, counts commits, and keeps the
    network state of its last state transfer."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.entries = []
        self.commits = {}
        self.transfers = []
        self.transferred = None

    def apply(self, entry):
        with self.lock:
            self.entries.append(entry)
            for req in entry.requests:
                key = (req.client_id, req.req_no)
                self.commits[key] = self.commits.get(key, 0) + 1

    def snap(self, network_config, client_states):
        from mirbft_tpu_torch import wire
        from mirbft_tpu_torch.messages import NetworkState

        encoded = wire.encode(NetworkState(config=network_config, clients=tuple(client_states),
                                           pending_reconfigurations=()))
        return hashlib.sha256(encoded).digest() + encoded, ()

    def transfer_to(self, seq_no, snap):
        from mirbft_tpu_torch import wire

        state = wire.decode(snap[32:])
        with self.lock:
            self.transfers.append(seq_no)
            self.transferred = state
        return state

    def held(self):
        """The requests this node's state holds: those it applied, and
        those its last transferred checkpoint records as committed (below
        a client's low watermark, or set in its committed mask)."""
        from mirbft_tpu_torch.statemachine.stateless import Bitmask

        with self.lock:
            held, state = set(self.commits), self.transferred
        for client in state.clients if state is not None else ():
            mask = Bitmask(client.committed_mask)
            held.update((client.id, r) for r in range(client.low_watermark))
            held.update((client.id, client.low_watermark + i) for i in range(mask.bits())
                        if mask.is_bit_set(i))
        return held


def batch_digest(request_bytes):
    """The processor's digest rules on the host: a request's digest is
    SHA-256 of its bytes, a batch's is SHA-256 over its requests' digests
    in order, and a null batch has none."""
    if not request_bytes:
        return b""
    return hashlib.sha256(b"".join(hashlib.sha256(d).digest() for d in request_bytes)).digest()


def embedded_requests():
    """c2's 800 signed envelopes (16 clients x 50), the clients' public
    keys, and one forged envelope (client 0's first signature with a bit
    flipped, sent as the request after its last)."""
    from mirbft_tpu_torch.ops.ed25519 import keypair_from_seed
    from mirbft_tpu_torch.processor.verify import seal, signing_payload

    keys, envelopes = {}, {}
    for c in range(NODE_CLIENTS):
        pub, sign = keypair_from_seed(hashlib.sha256(b"embedded-client-%d" % c).digest())
        keys[c] = pub
        for r in range(NODE_REQS):
            payload = b"embedded-req-%d-%d" % (c, r)
            envelopes[c, r] = seal(payload, sign(signing_payload(c, r, payload)))
    good = envelopes[0, 0]
    forged = seal(b"embedded-forged", good[-64:-59] + bytes([good[-59] ^ 0x10]) + good[-58:])
    return keys, envelopes, forged


def dump_thread_stacks(name):
    """Every thread's name and stack, written to chiprun_out/``name``;
    returns the path.  A stalled run's record of where each thread waits."""
    import threading
    import traceback

    frames = sys._current_frames()
    path = os.path.join(HERE, "chiprun_out", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        for thread in threading.enumerate():
            fh.write(f"--- {thread.name} (daemon={thread.daemon})\n")
            frame = frames.get(thread.ident)
            if frame is not None:
                fh.write("".join(traceback.format_stack(frame)))
    return path


def run_embedded_cluster(tmp, keys, envelopes, forged, tick=None, timeout_s=240):
    """Four threaded Nodes in this process, each with a durable WAL and
    request store, hashing through TorchHasher and gating signed requests
    on an Ed25519BatchVerifier on DEVICE, ticking every ``tick`` seconds
    (NODE_TICK by default); one thread proposes every envelope to every
    node.  Runs until every node's state holds every
    request (applied, or carried by a transferred checkpoint), then
    proposes the forgery.  Returns the nodes' logs, the wall to that
    point, each node's final epoch, and the forgery's verdict.  Raises
    if a node fails or the timeout passes first."""
    import threading

    from mirbft_tpu_torch.config import Config, standard_initial_network_state
    from mirbft_tpu_torch.node import AuthenticationError, Node, ProcessorConfig
    from mirbft_tpu_torch.ops.ed25519 import Ed25519BatchVerifier
    from mirbft_tpu_torch.ops.sha256 import TorchHasher
    from mirbft_tpu_torch.processor.verify import RequestAuthenticator
    from mirbft_tpu_torch.reqstore import Store
    from mirbft_tpu_torch.simplewal import WAL

    tick = NODE_TICK if tick is None else tick
    ingress = [(c, r, envelopes[c, r]) for (c, r) in sorted(envelopes)]
    ingress.append((0, NODE_REQS, forged))
    network_state = standard_initial_network_state(NODE_COUNT, *range(NODE_CLIENTS))
    transport = _Transport(NODE_COUNT, buffer=0)
    nodes, logs = [], []
    start = time.perf_counter()
    for i in range(NODE_COUNT):
        auth = RequestAuthenticator(
            verifier=Ed25519BatchVerifier(min_device_batch=1, device=DEVICE))
        for c, pub in keys.items():
            auth.register(c, pub)
        # The ingress window in one verify wave; the propose gate serves
        # from the memoized verdicts.
        verdicts = auth.authenticate_batch(ingress, memoize=True)
        if not verdicts[:-1].all() or verdicts[-1]:
            raise AssertionError(f"node {i}: ingress verdicts wrong")
        logs.append(_CommitLog())
        nodes.append(Node(i, Config(id=i, batch_size=NODE_BATCH), ProcessorConfig(
            link=transport.link(i),
            hasher=TorchHasher(min_device_batch=1, device=DEVICE),
            app=logs[-1],
            wal=WAL(os.path.join(tmp, f"wal-{i}")),
            request_store=Store(os.path.join(tmp, f"reqs-{i}.db")),
            authenticator=auth,
        )))
    transport.start(nodes)
    for node in nodes:
        node.process_as_new_node(network_state, b"initial", tick_interval=tick)
    failures = []

    def propose():
        # One thread proposes every client's requests to every node in
        # turn, as the reference's stress cluster does for its client.
        try:
            for r in range(NODE_REQS):
                for c in range(NODE_CLIENTS):
                    for node in nodes:
                        for _ in range(3000):
                            try:
                                node.client(c).propose(r, envelopes[c, r])
                                break
                            except KeyError:
                                time.sleep(0.01)  # the client window is not allocated
                        else:
                            raise AssertionError(f"client {c} window never reached {r}")
        except BaseException as exc:  # reported below, never swallowed
            failures.append(exc)

    proposer = threading.Thread(target=propose, daemon=True)
    proposer.start()
    want = set(envelopes)
    deadline = time.time() + timeout_s
    try:
        while True:
            if failures:
                raise failures[0]
            for node in nodes:
                if node.notifier.err() is not None:
                    raise AssertionError(f"node {node.id} failed: {node.notifier.err()!r}")
            if all(log_.held() >= want for log_ in logs):
                wall = time.perf_counter() - start
                break
            if time.time() > deadline:
                stacks = dump_thread_stacks("embedded_stall_stacks.txt")
                raise AssertionError(
                    f"embedded nodes: not every node holds every request after {timeout_s} s: "
                    f"held {[len(want & l.held()) for l in logs]}, applied "
                    f"{[len(l.commits) for l in logs]}, state transfers "
                    f"{[l.transfers for l in logs]}; every thread's stack in {stacks}")
            time.sleep(0.05)
        proposer.join(timeout=30)
        epochs = [node.status().epoch_tracker.active_epoch.number for node in nodes]
        try:
            nodes[0].client(0).propose(NODE_REQS, forged)
            forgery = "accepted"
        except AuthenticationError:
            forgery = "AuthenticationError"
    finally:
        for node in nodes:
            node.stop()
        transport.stop()
    return {"logs": logs, "wall": wall, "epochs": epochs, "forgery": forgery}


def embedded_runs(ticks, runs):
    """``chip_smoke.py --embedded TICKS RUNS``: run_embedded_cluster on the
    card RUNS times at each tick in TICKS (comma-separated seconds, in
    turns), one line a run: the wall, requests applied and held a node,
    state transfers, final epochs, the forgery's verdict.  It checks
    nothing; a run that raises prints its error and the next one starts."""
    import tempfile

    from mirbft_tpu_torch.ops import _build

    log(f"build: {_build.build_all()} | {nvidia_smi_line()}")
    keys, envelopes, forged = embedded_requests()
    want = set(envelopes)
    for index in range(runs):
        for tick in ticks:
            start = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "chiprun_out")) as tmp:
                try:
                    run = run_embedded_cluster(tmp, keys, envelopes, forged, tick=tick,
                                               timeout_s=150)
                except Exception as exc:  # this mode reports, the smoke checks
                    log(f"embedded tick={tick} run={index} raised after "
                        f"{time.perf_counter() - start:.3f} s: {exc!r}")
                    continue
            logs = run["logs"]
            log(f"embedded tick={tick} run={index} wall_s={run['wall']:.3f} applied="
                f"{[len(l.commits) for l in logs]} held={[len(want & l.held()) for l in logs]} "
                f"state_transfers={[l.transfers for l in logs]} epochs={run['epochs']} "
                f"forgery={run['forgery']}")
    return 0


HOST_COST_SIGNED_WAVES = 5


def host_costs():
    """``chip_smoke.py --host-costs``: the host costs a wave's staging
    changes, in a form that also runs against an older tree of the package
    (copy the script into that tree's root): the tiny wave's dispatch, the
    signed mux wave on HOST_COST_SIGNED_WAVES fresh pipelines in turn, and
    one embedded-node run's mean hash dispatch seconds (the
    ``hash_dispatch_seconds`` histogram: staging or packing, copies,
    launches)."""
    import tempfile

    import numpy as np

    from mirbft_tpu_torch import metrics
    from mirbft_tpu_torch.ops import _build

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    log(f"host costs: {nvidia_smi_line()}; build {_build.build_all()}; package {HERE}")
    tiny_wave_dispatch()
    keys, _, provider, n_signed = signed_mux_envelopes()
    waves = [signed_mux_wave(keys, provider, n_signed)[0] * 1e3
             for _ in range(HOST_COST_SIGNED_WAVES)]
    log(f"signed_mux_wave_ms on {len(waves)} fresh pipelines in turn: "
        f"{[round(w, 6) for w in waves]} median={float(np.median(waves)):.6f}")
    keys, envelopes, forged = embedded_requests()
    metrics.default_registry.reset()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "chiprun_out")) as tmp:
        run = run_embedded_cluster(tmp, keys, envelopes, forged)
    snap = metrics.snapshot()
    means = {name: snap.get(f"{name}_sum", 0.0) / max(snap.get(f"{name}_count", 0), 1) * 1e3
             for name in ("hash_dispatch_seconds", "hash_pack_seconds",
                          "hash_device_dispatch_seconds")}
    log(f"embedded_node wall_s={run['wall']:.3f} epochs={run['epochs']} hash dispatches="
        f"{snap.get('hash_dispatch_seconds_count', 0)} mean ms: "
        + " ".join(f"{k}={v:.6f}" for k, v in means.items()))
    return 0


def drive_embedded_node(tmp):
    """Phase 7, part 3: run_embedded_cluster on the card at c2's load.
    Every node's state must hold all 800 requests: each applied exactly
    once, or carried by a checkpoint the node state-transferred to (the
    reference's own stress test, tests/test_node_runtime.py, counts a
    transferred node the same way); no node applies a request twice or
    one never sent; every applied batch's digest is hashlib's; and the
    kernel rejects the forgery on every node."""
    from mirbft_tpu_torch import metrics

    check_stream_shared()
    keys, envelopes, forged = embedded_requests()
    metrics.default_registry.reset()
    reset_launches()
    with WaveLog() as run_waves, VerifyLog() as run_verify:
        run = run_embedded_cluster(tmp, keys, envelopes, forged)
        torch_sync()
    launches = read_launches()
    snap = metrics.snapshot()
    logs, want = run["logs"], set(envelopes)
    for i, log_ in enumerate(logs):
        if any(n != 1 for n in log_.commits.values()) or not set(log_.commits) <= want:
            raise AssertionError(f"node {i}: a request committed twice, or one never sent")
        for entry in log_.entries:
            data = [envelopes[req.client_id, req.req_no] for req in entry.requests]
            if entry.digest != batch_digest(data):
                raise AssertionError(f"node {i}: batch {entry.seq_no} digest != hashlib")
    if run["forgery"] != "AuthenticationError":
        raise AssertionError("embedded nodes: the forged envelope was accepted")
    kernel_rejected = sum(int((valid & ~ok).sum()) for valid, ok in run_verify.verdicts)
    if kernel_rejected != NODE_COUNT:
        raise AssertionError(f"embedded nodes: the kernel rejected {kernel_rejected} rows, not "
                             f"the forgery on each of {NODE_COUNT} nodes")
    if snap.get("hash_dispatch_seconds_count", 0) <= 0:
        raise AssertionError("embedded nodes: no hash dispatch was timed")
    counter = verify_counter()
    resolved = wave_kernels(run_waves.waves) | {counter}
    for kernel, count in launches.items():
        if (count > 0) != (kernel in resolved):
            raise AssertionError(f"embedded nodes: {kernel} launched {count} times")
    if launches[counter] != len(run_verify.waves):
        raise AssertionError(f"embedded nodes: {len(run_verify.waves)} verify waves, "
                             f"{launches[counter]} kernel launches")
    unique, wall = len(want), run["wall"]
    applied_all = sum(set(l.commits) == want for l in logs)
    log(f"deploy embedded nodes: {NODE_COUNT} threaded Nodes, {NODE_CLIENTS} clients x "
        f"{NODE_REQS} signed requests, one proposer thread, batch_size {NODE_BATCH}, tick "
        f"{NODE_TICK} s: every node holds all {unique}, {applied_all} of {NODE_COUNT} by "
        f"applying each (requests applied a node {[len(l.commits) for l in logs]}, none "
        f"twice; state transfers {[l.transfers for l in logs]}; final epochs "
        f"{run['epochs']}), every batch digest == hashlib; wall_s={wall:.3f} (until every "
        f"node held every request) unique_req_per_s={unique / wall:.1f}; verify waves "
        f"(rows, real rows)={run_verify.waves} real rows the kernel rejected="
        f"{kernel_rejected} (the forgery, once a node; propose raised AuthenticationError) "
        f"hash_dispatch_seconds_count={int(snap['hash_dispatch_seconds_count'])} "
        f"hash_dispatch_seconds_sum={snap.get('hash_dispatch_seconds_sum', 0.0):.6f} "
        f"launches={launches} hash waves="
        f"{ {f'{k[0]}{list(k[1])}': v[0] for k, v in run_waves.waves.items()} } "
        f"| {nvidia_smi_line()}")
    return launches, run_waves.waves, run_verify.inputs, None


def run_cohost(shared_wave):
    """One cohost deployment of tools/mirnet.py (COHOST), its processes
    started fresh: returns (result, root)."""
    import shutil

    from mirbft_tpu_torch.tools import mirnet

    root = os.path.join(HERE, "chiprun_out", f"deploy_cohost_{'card' if shared_wave else 'host'}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return mirnet.run_sharded_deployment(root_dir=root, shared_wave=shared_wave, timeout_s=240,
                                         **COHOST), root


def check_cohost_logs(root, label):
    """Every host process ran clean, a quorum of every group's nodes (the
    harness waits for 2f + 1) committed all its group's requests, and every
    batch digest in every commits.log is the processor's, recomputed with
    hashlib from the requests the harness submitted (``b"mirnet-%d"``).
    Returns (batches, requests committed a node)."""
    import glob

    for path in glob.glob(os.path.join(root, "host-*.log")):
        with open(path, errors="replace") as fh:
            if "Traceback" in fh.read():
                raise AssertionError(f"{label}: {path} holds a traceback")
    batches, per_node = 0, {}
    quorum = COHOST["nodes_per_group"] - (COHOST["nodes_per_group"] - 1) // 3
    for g in range(COHOST["groups"]):
        for h in range(COHOST["nodes_per_group"]):
            path = os.path.join(root, f"group-{g}", f"node-{h}", "commits.log")
            with open(path) as fh:
                lines = [line for line in fh.read().splitlines() if line]
            reqs = set()
            for line in lines:
                _seq, digest, refs = line.split(" ", 2)
                nums = [int(ref.split(":")[1]) for ref in refs.split(",") if ref]
                reqs.update(nums)
                if digest != batch_digest([b"mirnet-%d" % r for r in nums]).hex():
                    raise AssertionError(f"{label}: {path}: {line!r} digest != hashlib")
            if not reqs <= set(range(COHOST["reqs_per_group"])):
                raise AssertionError(f"{label}: {path} committed requests never submitted")
            per_node[f"{g}/{h}"] = len(reqs)
            batches += len(lines)
        done = sum(per_node[f"{g}/{h}"] == COHOST["reqs_per_group"]
                   for h in range(COHOST["nodes_per_group"]))
        if done < quorum:
            raise AssertionError(f"{label}: group {g}: {done} nodes committed every request")
    return batches, per_node


def drive_cohost_deployment():
    """Phase 7, part 4: tools/mirnet.py's cohost deployment (4 host
    processes, each serving its node of both groups, each with its own
    CohostCryptoPlane built on "cuda"), then the same deployment with
    per-group CPU hashers as its host twin.  At mirnet's load the plane
    launches no wave (its rows are single parts under 512 bytes, which it
    hashes on the host, in both packages), so this part puts no kernel
    work on the card and its launches are 0 (ROADMAP Next 16)."""
    from mirbft_tpu_torch.tools import mirnet

    for name in ("MIRNET_SHARED_WAVE", "MIRNET_TORCH_DEVICE"):
        os.environ.pop(name, None)
    # The host processes start as ``python -m mirbft_tpu_torch.tools.mirnet``.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    runs = {}
    reset_launches()
    for shared_wave in (True, False):
        res, root = run_cohost(shared_wave)
        label = "cohost, shared-wave plane built on cuda" if shared_wave else "cohost host twin"
        batches, per_node = check_cohost_logs(root, label)
        hosts = []
        for h in range(COHOST["nodes_per_group"]):
            prom = os.path.join(root, "group-0", f"node-{h}", "metrics.prom")
            value = lambda name: mirnet._metric_file_value(mirnet.Path(prom), name)
            hosts.append({
                "wave_mux_active": value("wave_mux_active"),
                "device_hashed_messages": int(value("device_hashed_messages")),
                "fused_wave_dispatches": int(value("fused_wave_dispatches")),
                "host_hashed_fast_messages": int(value("host_hashed_fast_messages")),
                "host_hashed_straggler_messages": int(value("host_hashed_straggler_messages")),
            })
        runs[shared_wave] = (res, hosts)
        log(f"deploy {label}: groups={COHOST['groups']} nodes_per_group="
            f"{COHOST['nodes_per_group']} host processes={COHOST['nodes_per_group']} "
            f"requests={COHOST['groups'] * COHOST['reqs_per_group']} committed, agreement "
            f"clean, node 0's unique_reqs_total={res['unique_reqs_total']}, requests "
            f"committed a node (group/node)={per_node}, {batches} batch digests in "
            f"{COHOST['groups'] * COHOST['nodes_per_group']} commits.log == hashlib; "
            f"wall_s={res['elapsed_s']:.3f} "
            f"unique_req_per_s={COHOST['groups'] * COHOST['reqs_per_group'] / res['elapsed_s']:.1f}; "
            f"per host "
            f"{hosts}")
        for h, host in enumerate(hosts):
            if host["wave_mux_active"] != (1 if shared_wave else 0):
                raise AssertionError(f"{label}: host {h} wave_mux_active="
                                     f"{host['wave_mux_active']}")
            if not shared_wave and (host["fused_wave_dispatches"] or
                                    host["device_hashed_messages"]):
                raise AssertionError(f"{label}: host {h} used the card: {host}")
            if shared_wave and host["host_hashed_fast_messages"] <= 0:
                raise AssertionError(f"{label}: host {h}'s plane served no hash")
    card, host = runs[True][0], runs[False][0]
    total = COHOST["groups"] * COHOST["reqs_per_group"]
    log(f"deploy cohost walls: shared-wave planes built on cuda {card['elapsed_s']:.3f} s "
        f"({total / card['elapsed_s']:.1f} req/s), per-group CPU hashers "
        f"{host['elapsed_s']:.3f} s ({total / host['elapsed_s']:.1f} req/s); "
        f"mux waves on the card {sum(h['fused_wave_dispatches'] for h in runs[True][1])}, "
        f"device_hashed_messages {sum(h['device_hashed_messages'] for h in runs[True][1])} | "
        f"{nvidia_smi_line()}")
    # Launches in this process: the harness's; the nodes run in the hosts.
    return read_launches(), {}, None, None


def drive_deploy(host_fps):
    """Phase 7: the deployment stack on the card."""
    import tempfile

    check_mux_waves()
    results = {"mux_recordings": drive_mux_recordings(host_fps)}
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "chiprun_out")) as tmp:
        results["embedded_node"] = drive_embedded_node(tmp)
    results["cohost_deployment"] = drive_cohost_deployment()
    return results

# Phase 8, mesh.  The sharded hash at c3's wave ([64, 64, 16]) and at 4,096
# rows of 640 bytes (bench.py's fused wave width), the verify step with 0, 1
# and 2 corrupted digests, the sharded verify at c2's wave of 1,024 signed
# rows (the corrupt signer's 64 among them) packed with 64 padding rows, the
# count kernel alone at row counts under a warp, past a warp and past a
# block, and the mesh paths: c2's Recording and its FastRecording with
# mesh_devices set to the cards the machine has.
MESH_LONG_WAVE, MESH_MSG_LEN = 4096, 640
MESH_SIGNED, MESH_PADDING = 1024, 64
MESH_COUNT_ROWS = (1, 7, 33, 4097)
# A digest row reads its 8 words and 8 expected words; a verdict row reads
# ok, valid and real and writes ok back; the launch writes one count word.
MESH_DIGEST_BYTES_PER_ROW, MESH_VERDICT_BYTES_PER_ROW, MESH_COUNT_BYTES = 64, 4, 4
# Integer operations a row (loads' address math aside): a digest row's 8
# XORs, 7 ORs, the compare and the add; a verdict row's tests, AND, store
# and add.
MESH_DIGEST_OPS_PER_ROW, MESH_VERDICT_OPS_PER_ROW = 17, 6


def mesh_count_bound(mode, rows):
    """(bound_ms, bound_by) of one count launch over ``rows`` rows."""
    per_row, ops = ((MESH_DIGEST_BYTES_PER_ROW, MESH_DIGEST_OPS_PER_ROW) if mode == "digests"
                    else (MESH_VERDICT_BYTES_PER_ROW, MESH_VERDICT_OPS_PER_ROW))
    byte_ms = (rows * per_row + MESH_COUNT_BYTES) / HBM_BYTES_PER_S * 1e3
    op_ms = rows * ops / ISSUE_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def mesh_count_case(rng, mode, rows, mask):
    """Inputs of one count launch on the card: digest words and expected
    words differing in the masked rows, or verdicts, validity and the
    masked rows as real."""
    import numpy as np
    import torch

    pick = {"all": np.ones(rows, bool), "none": np.zeros(rows, bool),
            "random": rng.random(rows) < 0.3}[mask]
    if mode == "digests":
        words = rng.integers(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)
        expected = words.copy()
        cols = rng.integers(0, 8, size=rows)
        expected[pick, cols[pick]] ^= np.uint32(1 << 7)
        return [torch.from_numpy(a.view(np.int32)).to(DEVICE) for a in (words, expected)]
    return [torch.from_numpy(a).to(DEVICE)
            for a in (rng.random(rows) < 0.6, rng.random(rows) < 0.8, pick)]


def check_mesh_count(mode, tensors, worst):
    """The count kernel on ``tensors`` against its plain version on the
    card (the count, and in verdict mode the verdicts written back)."""
    from mirbft_tpu_torch.parallel import shard_count, shard_count_torch

    import torch

    a, rest = tensors[0], tensors[1:]
    got_a, want_a = a.clone(), a.clone()
    got = int(shard_count(mode, got_a, *rest))
    want = int(shard_count_torch(mode, want_a, *rest))
    torch_sync()
    err = max(abs(got - want), int((got_a.to(torch.int64) - want_a.to(torch.int64)).abs().max())
              if a.numel() else 0)
    worst["mesh_count"] = max(worst.get("mesh_count", 0), err)
    if err:
        raise AssertionError(f"mesh_count ({mode}, {a.shape[0]} rows): kernel {got} != plain {want}")
    return got


def time_mesh_count(mode, tensors):
    """(ms, plain_ms) of one count (CUDA events over back-to-back counts,
    each launch in turn after the one before, as a path's count follows
    its verify or hash kernel) and of its plain version."""
    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.parallel import shard_count, shard_count_torch

    a, rest = tensors[0].clone(), tensors[1:]
    ms = time_cuda(lambda: shard_count(mode, a, *rest)) * 1e3
    plain_ms = time_plain(lambda: shard_count_torch(mode, a, *rest), repeats=5) * 1e3
    return ms, plain_ms


def count_after_verify_ms(verify_arrays, part, tensors, repeats=9):
    """Median ms of one verdict count enqueued right after the shard's
    verify kernel, as the mesh paths launch it: CUDA events bracket the
    count alone, while the verify kernel holds the stream."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.parallel import shard_count

    inputs = [torch.from_numpy(a[part]).to(DEVICE) for a in verify_arrays]
    ok, rest = tensors[0].clone(), tensors[1:]
    times = []
    for _ in range(repeats + 1):
        e.ed25519_verify_kernel(*inputs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        shard_count("verdicts", ok, *rest)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


MESH_COUNT_TRACED = 8


def traced_counts_child():
    """``chip_smoke.py --count-trace``: count_operations in digest and
    verdict mode at one block (33 rows) and at several (4,096), printed
    as one JSON line [[mode, rows, ops], ...]."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    out = [[mode, rows, count_operations(mode, mesh_count_case(rng, mode, rows, "random"))]
           for mode in ("digests", "verdicts") for rows in (MESH_COUNT_ROWS[2], MESH_LONG_WAVE)]
    print(json.dumps(out), flush=True)
    return 0


def traced_counts_in_child():
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--count-trace"],
                         cwd=HERE, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"the traced counts failed: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def count_operations(mode, tensors):
    """(kernel launches the wrapper counted, the trace's mesh_count_kernel
    records, its memset records, its other device records) of
    MESH_COUNT_TRACED counts under torch.profiler: one launch and nothing
    else on the stream a count."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from mirbft_tpu_torch.parallel import shard_count

    a, rest = tensors[0].clone(), tensors[1:]
    shard_count(mode, a, *rest)  # the stream's accumulator exists before the window
    torch_sync()
    before = shard_count.launches
    path = os.path.join(HERE, "chiprun_out", f"trace_mesh_count_{mode}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MESH_COUNT_TRACED):
            shard_count(mode, a, *rest)
        torch_sync()
    prof.export_chrome_trace(path)
    _, names, _ = device_busy(path)
    kernels = sum(v for k, v in names.items() if "mesh_count_kernel" in k)
    memsets = sum(v for k, v in names.items() if "emset" in k)
    return shard_count.launches - before, kernels, memsets, sum(names.values()) - kernels


def check_mesh(worst):
    """Phase 8, part 1: the mesh of every card against the unsharded
    kernels, hashlib and the plain versions; the count kernel alone; the
    dry run.  Returns the digest-mode count times for the report."""
    import numpy as np
    import torch

    from mirbft_tpu_torch import graft_entry, parallel
    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.sha256 import digests_from_words, pack_messages, wave_to_torch
    from mirbft_tpu_torch.ops.sha256_pallas import sha256_batch

    n = torch.cuda.device_count()
    mesh = parallel.make_mesh(n, device=DEVICE)
    try:
        parallel.make_mesh(n + 1, device=DEVICE)
    except ValueError as exc:
        log(f"mesh: {mesh}; make_mesh({n + 1}) raises ValueError: {exc}")
    else:
        raise AssertionError(f"make_mesh({n + 1}) did not raise with {n} cards")
    rng = np.random.default_rng(SEED + 8)
    long_messages = [rng.integers(0, 256, size=MESH_MSG_LEN, dtype=np.uint8).tobytes()
                     for _ in range(MESH_LONG_WAVE)]
    long_blocks, long_n = pack_messages(long_messages, batch_multiple=n)
    waves = {"c3_wave": ragged_wave(rng, 64, 64, "batch"),
             "long_wave": (long_messages, long_blocks, long_n)}
    verify_step = parallel.distributed_verify_step(mesh)
    timings = {}
    for name, (messages, blocks, n_blocks) in waves.items():
        words = parallel.sharded_sha256(mesh)(blocks, n_blocks)
        bt, nt = wave_to_torch(blocks, n_blocks, DEVICE)
        whole = sha256_batch(bt, nt)
        torch_sync()
        if words.device != mesh.devices[0] or not torch.equal(words, whole):
            raise AssertionError(f"mesh {name}: sharded digests != the unsharded kernel's")
        host = words.cpu().numpy().view(np.uint32)
        sample = rng.choice(len(messages), size=min(64, len(messages)), replace=False)
        digests = digests_from_words(host)
        for i in sample:
            if digests[i] != hashlib.sha256(messages[i]).digest():
                raise AssertionError(f"mesh {name}: row {i} != hashlib")
        counts = []
        for corrupt in (0, 1, 2):
            expected = host.copy()
            for row in rng.choice(len(messages), size=corrupt, replace=False):
                expected[row, rng.integers(0, 8)] ^= np.uint32(1 << 31)
            step_words, count = verify_step(blocks, n_blocks, expected)
            torch_sync()
            if int(count) != corrupt or not torch.equal(step_words, whole):
                raise AssertionError(f"mesh {name}: verify step counted {int(count)} of {corrupt}")
            counts.append(int(count))
        rows = blocks.shape[0] // n
        tensors = [whole[:rows], torch.from_numpy(expected[:rows].view(np.int32)).to(DEVICE)]
        check_mesh_count("digests", tensors, worst)
        ms, plain_ms = time_mesh_count("digests", tensors)
        bound_ms, by = mesh_count_bound("digests", rows)
        timings[f"{rows}_rows_ms"] = ms
        log(f"mesh {name}: sharded_sha256 {list(blocks.shape)} == sha256_batch and hashlib "
            f"({len(sample)} sampled rows); verify step counts {counts} for 0, 1, 2 corrupted; "
            f"kernel mesh_count digests rows={rows} ms={ms:.6f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.9f} ({by})")

    pubs, msgs, sigs, corrupt = signed_rows(MESH_SIGNED)
    batch = -(-(MESH_SIGNED + MESH_PADDING) // n) * n
    packed = e.Ed25519BatchVerifier(device="cpu").pack_inputs(pubs, msgs, sigs, batch=batch)
    real = np.arange(batch) < MESH_SIGNED
    ok, invalid = parallel.sharded_ed25519_verify(mesh)(*packed, real)
    plain = e.verify_torch(*(torch.from_numpy(a).to(DEVICE) for a in packed[:5]))
    plain &= torch.from_numpy(packed[5]).to(DEVICE)
    torch_sync()
    if not torch.equal(ok, plain):
        raise AssertionError("mesh: sharded verdicts != verify_torch on the card")
    if int(invalid) != len(corrupt) or ok.cpu().numpy()[corrupt].any():
        raise AssertionError(f"mesh: count {int(invalid)} of {len(corrupt)} corrupt real rows")
    log(f"mesh sharded_ed25519_verify: {batch} rows ({MESH_SIGNED} real, {len(corrupt)} of the "
        f"corrupt signer's, {batch - MESH_SIGNED} padding) == verify_torch on the card; "
        f"count {int(invalid)}")
    # The same rows on the "mxu" kernel: one launch a card.
    before = e.ed25519_verify_mxu_kernel.launches
    ok, invalid = parallel.sharded_ed25519_verify(mesh, kernel="mxu")(*packed, real)
    launched = e.ed25519_verify_mxu_kernel.launches - before
    plain = e.verify_torch(*(torch.from_numpy(a).to(DEVICE) for a in packed[:5]),
                           mul=e._mul_mxu)
    plain &= torch.from_numpy(packed[5]).to(DEVICE)
    torch_sync()
    if not torch.equal(ok, plain) or launched != n:
        raise AssertionError(f"mesh mxu: sharded verdicts != verify_torch(_mul_mxu) on the "
                             f"card, or {launched} mxu launches on {n} cards")
    if int(invalid) != len(corrupt) or ok.cpu().numpy()[corrupt].any():
        raise AssertionError(f"mesh mxu: count {int(invalid)} of {len(corrupt)} corrupt rows")
    log(f"mesh sharded_ed25519_verify kernel=mxu: the same {batch} rows == verify_torch with "
        f"_mul_mxu on the card; count {int(invalid)}; ed25519_verify_mxu launches {launched}")

    for mode in ("digests", "verdicts"):
        for rows in MESH_COUNT_ROWS:
            got = {mask: check_mesh_count(mode, mesh_count_case(rng, mode, rows, mask), worst)
                   for mask in ("all", "none", "random")}
            log(f"kernel mesh_count {mode} rows={rows}: counts {got} == plain on the card")
    # One block (one CTA stores the count) and several (the last block's
    # ticket): each count one launch, no memset.  Traced in a process of
    # its own: in the smoke's process, after its earlier phases,
    # torch.profiler has dropped device records.
    for mode, rows, ops in traced_counts_in_child():
        log(f"kernel mesh_count {mode} rows={rows}: {MESH_COUNT_TRACED} counts traced in a "
            f"process of its own: wrapper launches={ops[0]} mesh_count_kernel "
            f"records={ops[1]} memset records={ops[2]} other device records={ops[3]}")
        if tuple(ops) != (MESH_COUNT_TRACED, MESH_COUNT_TRACED, 0, 0):
            raise AssertionError(f"mesh_count {mode} rows={rows}: {ops} (launches, kernel "
                                 f"records, memsets, other records) for "
                                 f"{MESH_COUNT_TRACED} counts")
    counters = graft_entry.dryrun_multichip(n, device=DEVICE)
    log(f"mesh dryrun_multichip({n}): {counters}")
    return timings


def mesh_paths():
    """name -> (Spec shape, Recording plane or None, FastRecording keywords
    or None, the Recording path whose host-path run it is held to)."""
    return {
        # hash_floor 1, as on c2_signed_fused: at c2's floor of 8 its 32
        # unique digests are hashed on the host and no hash wave crosses.
        "c2_signed_mesh": (C2, dict(C2_PLANE, kernel="auto", hash_floor=1), None, "c2_signed"),
        "c2_16n_signed_fast_mesh": (C2, None, dict(auth_wave=C2_PLANE["auth_wave"]),
                                    "c2_signed"),
    }


def drive_mesh(host_fps, worst):
    """Phase 8: the mesh checks, then the mesh paths, each device run held to
    its host-path fingerprint with an exact launch set: every mesh verify
    wave launches the verify and count kernels once a card, every mesh hash
    wave the batch-major kernel once a card (FastRecording's hash mirror
    stays off the mesh, as in the JAX package)."""
    import torch

    from mirbft_tpu_torch.testengine import CryptoConfig, Spec

    timings = check_mesh(worst)
    n = torch.cuda.device_count()
    results = {}
    for name, (shape, plane, fast, held_to) in mesh_paths().items():
        target = {c: shape["reqs_per_client"] for c in range(shape["client_count"])}
        reset_launches()
        with WaveLog() as run_waves, VerifyLog() as run_verify:
            if fast is None:
                recording, steps, finals, wall, snap = run_spec(
                    Spec(**shape, crypto=CryptoConfig(**plane, mesh_devices=n,
                                                      torch_device=DEVICE)))
                committed = [node.state.committed_reqs for node in recording.nodes]
            else:
                recording, steps, finals, wall, snap = run_fast(
                    Spec(**shape, crypto=CryptoConfig(mesh_devices=n, torch_device=DEVICE)),
                    device=True, **fast)
                committed = [node.committed_reqs for node in recording.nodes]
        launches = read_launches()
        if (steps, finals) != host_fps[held_to]:
            raise AssertionError(f"{name}: device run diverged from {held_to}'s host path")
        for got in committed:
            if {c: got.get(c, 0) for c in target} != target:
                raise AssertionError(f"{name}: a node committed {dict(got)}, not {target}")
        mesh = {k: int(snap.get(k, 0)) for k in (
            "mesh_hash_dispatches", "mesh_hashed_messages", "mesh_verify_dispatches",
            "mesh_verified_signatures")}
        resolved = wave_kernels(run_waves.waves)
        counter = verify_counter()
        if run_verify.waves:
            resolved |= {counter, "mesh_count"}
        for kernel, count in launches.items():
            if (count > 0) != (kernel in resolved):
                raise AssertionError(f"{name}: {kernel} launched {count} times")
        verifies = mesh["mesh_verify_dispatches"]
        if verifies <= 0 or not (launches[counter] == launches["mesh_count"]
                                 == n * verifies):
            raise AssertionError(f"{name}: {verifies} mesh verify waves, launches {launches}")
        if fast is None and (mesh["mesh_hash_dispatches"] <= 0
                             or launches["sha256_batch"] != n * mesh["mesh_hash_dispatches"]
                             or snap.get("device_hash_dispatches") != mesh["mesh_hash_dispatches"]):
            raise AssertionError(f"{name}: mesh hash waves {mesh}, launches {launches}")
        screened = rejected = 0
        for valid, ok in run_verify.verdicts:
            screened += int((~valid).sum())
            rejected += int((valid & ~ok).sum())
        log(f"mesh path {name}: steps={steps} (== {held_to}'s host path) wall_s={wall:.6f} "
            f"unique_req_per_s={sum(target.values()) / wall:.1f} committed={target} on every "
            f"node; {mesh} launches={launches} verify waves (rows, real rows)="
            f"{run_verify.waves} hash waves="
            f"{ {f'{k[0]}{list(k[1])}': v[0] for k, v in run_waves.waves.items()} } "
            f"real rows the host screen rejected={screened} the kernels rejected={rejected}")
        results[name] = (launches, dict(run_waves.waves), run_verify.inputs, None)
    return results, timings


def fused_alone():
    """``chip_smoke.py --fused``: the builds and phase 4 alone (the fused
    wave's checks, its times and its ``fused_split`` lines)."""
    from mirbft_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    log(f"fused alone: {smi}; build {_build.build_all()}")
    log(_build.ptxas_report("pack").strip())
    check_pack()
    take_verify_probe()
    check_fused((sm_clock_hz(),))
    check_fused_mxu()
    log(smi)
    return 0


def mesh_alone():
    """``chip_smoke.py --mesh``: phase 8 alone over every card of the
    machine, after c2's host-path run (the mesh paths' fingerprint), and
    the count kernel's report entry.  On a machine of several cards this
    is the check of the mesh across cards that the one-card smoke cannot
    make."""
    import torch

    from mirbft_tpu_torch import _native
    from mirbft_tpu_torch.ops import _build
    from mirbft_tpu_torch.testengine import Spec

    log(f"mesh alone: {nvidia_smi_line()} x{torch.cuda.device_count()}; "
        f"build {_build.build_all()}")
    # The fast engine's g++ build (~35 s) must not land in a timed run.
    if _native.load_fast() is None:
        raise AssertionError("g++ could not build the fast engine (_native/fastengine.cpp)")
    _, steps, finals, wall, _ = run_spec(Spec(**C2))
    log(f"mesh alone: c2_signed host path steps={steps} wall_s={wall:.3f}; verify probe "
        f"{take_verify_probe()[0]}, auto resolves to {verify_counter()}")
    worst = {}
    start = time.perf_counter()
    results, timings = drive_mesh({"c2_signed": (steps, finals)}, worst)
    log(json.dumps({"kernels": [report_mesh(results, worst, timings)]}))
    log(f"mesh alone: phase 8 and the report in {time.perf_counter() - start:.1f} s")
    return 0


def report_mesh(paths, worst, timings):
    """The count kernel's entry: timed in verdict mode on each shard of each
    verify wave the mesh paths launched it on (the wave's own verdicts,
    validity and real-row mask, sliced per shard as the mesh splits them),
    held to its plain version there, averaged over the launches; with the
    digest mode's times at the mesh checks' shapes beside it."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops import ed25519 as e

    name = "mesh_count"
    launches = sum(entry[0].get(name, 0) for entry in paths.values())
    if launches <= 0:
        raise AssertionError(f"{name} was launched on no path")
    n = torch.cuda.device_count()
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0, "bytes": 0}
    count_all = 0
    for path, (path_launches, _, inputs, _) in paths.items():
        if not path_launches.get(name):
            continue
        for rows, (count, packed) in (inputs or {}).items():
            shard = rows // n
            for i in range(n):
                part = slice(i * shard, (i + 1) * shard)
                ok = e.ed25519_verify_kernel(
                    *(torch.from_numpy(a[part]).to(DEVICE) for a in packed[:5]))
                valid = torch.from_numpy(packed[5][part]).to(DEVICE)
                real = torch.from_numpy(packed[6][part]).to(DEVICE)
                tensors = [ok, valid, real]
                check_mesh_count("verdicts", tensors, worst)
                ms, plain_ms = time_mesh_count("verdicts", tensors)
                after_ms = count_after_verify_ms(packed[:5], part, tensors)
                bound_ms, by = mesh_count_bound("verdicts", shard)
                log(f"path-wave {path} {name} verdicts shard={i} rows={shard} "
                    f"real_rows={int(packed[6][part].sum())} launches={count} "
                    f"ms={ms:.6f} after_verify_ms={after_ms:.6f} plain_ms={plain_ms:.3f} "
                    f"bound_ms={bound_ms:.9f} ({by})")
                tot["ms"] += count * ms
                tot["plain_ms"] += count * plain_ms
                tot["bound_ms"] += count * bound_ms
                tot["ops" if by == "operations" else "bytes"] += count
                count_all += count
    return {
        "name": name,
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/mesh.cu",
        "replaces": "mirbft_tpu/parallel/mesh.py:125",
        "launches": launches,
        "launches_by_path": {p: entry[0].get(name, 0) for p, entry in paths.items()},
        "max_abs_err": worst["mesh_count"],
        "ms": tot["ms"] / count_all,
        "plain_ms": tot["plain_ms"] / count_all,
        "bound_ms": tot["bound_ms"] / count_all,
        "bound_by": "operations" if tot["ops"] > tot["bytes"] else "bytes",
        "library_ms": None,
        **{f"digest_mode_{k}": v for k, v in timings.items()},
        "digest_mode_replaces": "mirbft_tpu/parallel/mesh.py:83",
    }


def report(paths, worst, clock, mesh_timings):
    """Phase 9: time each kernel on the inputs its paths launched it on."""
    import numpy as np

    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.ops.sha256 import wave_to_torch

    kernels = []
    for name, (kernel, plain, layout, replaces) in kernel_table().items():
        launches = sum(entry[0][name] for entry in paths.values())
        if launches <= 0:
            raise AssertionError(f"{name} was launched on no path")
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0,
               "cycles_per_round": 0.0, "chain_floor_ms": 0.0}
        n = 0
        for path, (_, waves, _, _) in paths.items():
            for (wave_layout, shape), (count, logged) in waves.items():
                if wave_layout != layout:
                    continue
                blocks, n_blocks = logged.words()
                bt, nt = wave_to_torch(blocks, n_blocks, DEVICE)
                want, plain_s = plain_once(lambda: plain(bt, nt))
                got = kernel(bt, nt)
                torch_sync()
                err = int(np.abs(u32(got).astype(np.int64) - u32(want).astype(np.int64)).max())
                worst[name] = max(worst[name], err)
                if err:
                    raise AssertionError(f"{name}: kernel != plain on a path wave {shape}")
                L = shape[1]
                bound_ms, by = bound_of(n_blocks, L, got.numel())
                ms = time_cuda(lambda: kernel(bt, nt)) * 1e3
                plain_ms = plain_s * 1e3
                cycles, floor_ms = chain_of(ms, n_blocks, L, clock)
                log(f"path-wave {path} {name} shape={list(shape)} launches={count} "
                    f"live_blocks={int(np.minimum(n_blocks, L).sum())} "
                    f"longest={int(np.minimum(n_blocks, L).max())} ms={ms:.6f} "
                    f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} ({by}) "
                    f"chain_floor_ms={floor_ms:.6f} cycles_per_round={cycles:.2f}")
                tot["ms"] += count * ms
                tot["plain_ms"] += count * plain_ms
                tot["bound_ms"] += count * bound_ms
                tot["cycles_per_round"] += count * cycles
                tot["chain_floor_ms"] += count * floor_ms
                tot["ops" if by == "operations" else "bytes"] += count
                n += count
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mirbft_tpu_torch/csrc/sha256.cu",
            "replaces": replaces,
            "launches": launches,
            "launches_by_path": {p: entry[0][name] for p, entry in paths.items()},
            "max_abs_err": worst[name],
            "ms": tot["ms"] / n,
            "plain_ms": tot["plain_ms"] / n,
            "bound_ms": tot["bound_ms"] / n,
            "bound_by": "operations" if tot["ops"] >= tot["bytes"] else "bytes",
            "library_ms": None,
            "chain_floor_ms": tot["chain_floor_ms"] / n,
            "cycles_per_round": tot["cycles_per_round"] / n,
        })
    kernels.append(report_pack(paths, worst))
    kernels.append(report_ed25519(paths, worst, clock))
    kernels.append(report_ed25519_mxu(paths, worst))
    kernels.append(report_quorum(paths, worst))
    kernels.append(report_mesh(paths, worst, mesh_timings))
    return kernels


def report_pack(paths, worst):
    """The pack kernel's entry: timed on each staged hash wave shape the
    paths launched it on (the wave's own bytes), held to its plain version
    and the host packer there, averaged over the launches."""
    name = "pack_wave"
    launches = sum(entry[0][name] for entry in paths.values())
    if launches <= 0:
        raise AssertionError(f"{name} was launched on no path")
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    n = 0
    for path, (_, waves, _, _) in paths.items():
        for shape, (count, logged) in (waves or {}).items():
            if not logged.staged:
                continue
            ms, plain_ms, bound_ms, err = pack_case(logged.staged_tensors(), logged.batch,
                                                    logged.bucket, logged.layout,
                                                    logged.words())
            worst[name] = max(worst.get(name, 0), err)
            log(f"path-wave {path} {name} {logged.layout}{list(shape[1])} "
                f"rows={len(logged.inputs[2])} launches={count} ms={ms:.6f} "
                f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.9f} (bytes)")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * bound_ms
            n += count
    return {
        "name": name,
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/pack.cu",
        "replaces": "none: host work of mirbft_tpu/ops/sha256.py:242 (pack_messages)",
        "launches": launches,
        "launches_by_path": {p: entry[0][name] for p, entry in paths.items()},
        "max_abs_err": worst[name],
        "ms": tot["ms"] / n,
        "plain_ms": tot["plain_ms"] / n,
        "bound_ms": tot["bound_ms"] / n,
        "bound_by": "bytes",
        "library_ms": None,
    }


def report_ed25519(paths, worst, clock):
    """The verify kernel's entry: timed on each verify wave shape the paths
    launched, held to verify_torch there, averaged over the launches."""
    import torch

    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.crossover import time_cuda

    name = "ed25519_verify"
    launches = sum(entry[0][name] for entry in paths.values())
    if launches <= 0:
        raise AssertionError(f"{name} was launched on no path")
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "issue_bound_ms": 0.0, "ops": 0,
           "bytes": 0}
    n = 0
    for path, (launched, _, inputs, _) in paths.items():
        if not launched[name]:
            continue  # its verify waves ran the "mxu" kernel
        for rows, (count, packed) in (inputs or {}).items():
            tensors = [torch.from_numpy(a).to(DEVICE) for a in packed[:5]]
            want, plain_s = plain_once(lambda: e.verify_torch(*tensors))
            got = e.ed25519_verify_kernel(*tensors)
            torch_sync()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            worst[name] = max(worst[name], err)
            if err:
                raise AssertionError(f"{name}: kernel != plain on a path wave of {rows} rows")
            ms = time_cuda(lambda: e.ed25519_verify_kernel(*tensors), repeats=5) * 1e3
            plain_ms = plain_s * 1e3
            bound_ms, by = verify_bound(rows, clock[0])
            issue_ms = verify_issue_bound(rows, clock)
            log(f"path-wave {path} {name} rows={rows} valid_rows={int(packed[5].sum())} "
                f"launches={count} ms={ms:.6f} plain_ms={plain_ms:.3f} "
                f"bound_ms={bound_ms:.6f} ({by}) of_bound={bound_ms / ms:.4f} "
                f"imad_wide_issue_bound_ms={issue_ms:.6f} "
                f"cycles_per_mul={cycles_per_mul(ms, clock):.1f}")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * bound_ms
            tot["issue_bound_ms"] += count * issue_ms
            tot["ops" if by == "operations" else "bytes"] += count
            n += count
    return {
        "name": name,
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/ed25519.cu",
        "replaces": "mirbft_tpu/ops/ed25519.py:372",
        "launches": launches,
        "launches_by_path": {p: entry[0][name] for p, entry in paths.items()},
        "max_abs_err": worst[name],
        "ms": tot["ms"] / n,
        "plain_ms": tot["plain_ms"] / n,
        "bound_ms": tot["bound_ms"] / n,
        "bound_by": "operations" if tot["ops"] >= tot["bytes"] else "bytes",
        "library_ms": None,
        "imad_wide_issue_bound_ms": tot["issue_bound_ms"] / n,
    }


def report_ed25519_mxu(paths, worst):
    """The "mxu" verify kernel's entry: timed on each verify wave shape of
    the paths that launched it, held to verify_torch with _mul_mxu there,
    averaged over the launches."""
    import torch

    from mirbft_tpu_torch.ops import ed25519 as e
    from mirbft_tpu_torch.ops.crossover import time_cuda

    name = "ed25519_verify_mxu"
    launches = sum(entry[0][name] for entry in paths.values())
    if launches <= 0:
        raise AssertionError(f"{name} was launched on no path")
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "vpu_ms": 0.0}
    n = 0
    for path, (launched, _, inputs, _) in paths.items():
        if not launched[name]:
            continue
        for rows, (count, packed) in (inputs or {}).items():
            tensors = [torch.from_numpy(a).to(DEVICE) for a in packed[:5]]
            want, plain_s = plain_once(lambda: e.verify_torch(*tensors, mul=e._mul_mxu))
            got = e.ed25519_verify_kernel(*tensors, backend="mxu")
            torch_sync()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            worst[name] = max(worst[name], err)
            if err:
                raise AssertionError(f"{name}: kernel != plain on a path wave of {rows} rows")
            ms = time_cuda(lambda: e.ed25519_verify_kernel(*tensors, backend="mxu"),
                           repeats=3) * 1e3
            vpu_ms = time_cuda(lambda: e.ed25519_verify_kernel(*tensors), repeats=5) * 1e3
            bound_ms, _ = mxu_bound(rows)
            log(f"path-wave {path} {name} rows={rows} valid_rows={int(packed[5].sum())} "
                f"launches={count} ms={ms:.6f} plain_ms={plain_s * 1e3:.3f} "
                f"bound_ms={bound_ms:.6f} of_bound={bound_ms / ms:.4f} vpu_ms={vpu_ms:.6f}")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_s * 1e3
            tot["bound_ms"] += count * bound_ms
            tot["vpu_ms"] += count * vpu_ms
            n += count
    return {
        "name": name,
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/ed25519_mxu.cu",
        "replaces": "mirbft_tpu/ops/ed25519.py:234 (_mul_mxu in _verify_kernel_body :372)",
        "launches": launches,
        "launches_by_path": {p: entry[0][name] for p, entry in paths.items()},
        "max_abs_err": worst[name],
        "ms": tot["ms"] / n,
        "plain_ms": tot["plain_ms"] / n,
        "bound_ms": tot["bound_ms"] / n,
        "bound_by": "operations",
        "library_ms": None,
        "vpu_ms": tot["vpu_ms"] / n,
    }


def report_quorum(paths, worst):
    """The quorum kernel's entry: timed on the inputs of each quorum launch
    shape the fused paths made, held to its plain version there, averaged
    over the launches."""
    import torch

    from mirbft_tpu_torch.ops import latency_probe
    from mirbft_tpu_torch.ops.quorum import quorum_accumulate_torch

    name = "quorum_accumulate"
    launches = sum(entry[0][name] for entry in paths.values())
    if launches <= 0:
        raise AssertionError(f"{name} was launched on no path")
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "dependent_launches_ms": 0.0,
           "launch_floor_ms": 0.0, "ops": 0, "bytes": 0}
    n = 0
    for path, (_, _, _, inputs) in paths.items():
        for key, (count, tensors) in (inputs or {}).items():
            tensors = list(tensors)
            got = run_quorum(tensors)
            want = quorum_accumulate_torch(*tensors[:5], tuple(tensors[5:]))
            torch_sync()
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      for a, b in zip(got, want))
            worst[name] = max(worst.get(name, 0), err)
            if err:
                raise AssertionError(f"{name}: kernel != plain on a path launch {key}")
            ms, plain_ms, bound_ms, by, dep_ms = time_quorum(tensors)
            floor_ms = latency_probe.launch_floor_ms()
            log(f"path-wave {path} {name} (W, D, N, K, P, B)={list(key)} launches={count} "
                f"ms={ms:.6f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} ({by}) "
                f"dependent_launches_ms={dep_ms:.6f} launch_floor_ms={floor_ms:.6f}")
            tot["launch_floor_ms"] += count * floor_ms
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * bound_ms
            tot["dependent_launches_ms"] += count * dep_ms
            tot["ops" if by == "operations" else "bytes"] += count
            n += count
    return {
        "name": name,
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/quorum.cu",
        "replaces": "mirbft_tpu/ops/quorum.py:66",
        "launches": launches,
        "launches_by_path": {p: entry[0][name] for p, entry in paths.items()},
        "max_abs_err": worst[name],
        "ms": tot["ms"] / n,
        "plain_ms": tot["plain_ms"] / n,
        "bound_ms": tot["bound_ms"] / n,
        "bound_by": "operations" if tot["ops"] >= tot["bytes"] else "bytes",
        "library_ms": None,
        "dependent_launches_ms": tot["dependent_launches_ms"] / n,
        "launch_floor_ms": tot["launch_floor_ms"] / n,
    }


def main() -> int:
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--traced-fast"]:
        return traced_fast_child(sys.argv[2])
    if sys.argv[1:2] == ["--count-trace"]:
        return traced_counts_child()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs only on the card", file=sys.stderr)
        return 1
    try:
        from mirbft_tpu_torch.ops import _build
    except ImportError:
        print("chip_smoke: mirbft_tpu_torch is not beside this script", file=sys.stderr)
        return 1

    if sys.argv[1:2] == ["--mesh"]:
        return mesh_alone()
    if sys.argv[1:2] == ["--fused"]:
        return fused_alone()
    if sys.argv[1:2] == ["--host-costs"]:
        return host_costs()
    if sys.argv[1:2] == ["--embedded"]:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        return embedded_runs([float(t) for t in sys.argv[2].split(",")], int(sys.argv[3]))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} "
        f"x{torch.cuda.device_count()}")

    from mirbft_tpu_torch import _native

    log(f"native ack/vote planes (g++ build of _native/ackplane.cpp): "
        f"{'loaded' if _native.available else 'unavailable, pure-Python planes'}")
    # The fast engine's g++ build (~35 s) runs beside the nvcc builds, and
    # before any timed window.
    import threading

    fast_build = {}

    def build_fast():
        begin = time.perf_counter()
        fast_build["module"] = _native.load_fast()
        fast_build["seconds"] = time.perf_counter() - begin

    build_thread = threading.Thread(target=build_fast)
    # Wall seconds of each phase, logged before the report's lines.
    phase_s, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 1)
        mark[0] = now

    start = time.perf_counter()
    build_thread.start()
    seconds = _build.build_all()
    build_thread.join()
    log(f"build: {seconds} wall_s={time.perf_counter() - start:.2f}")
    if fast_build["module"] is None:
        raise AssertionError("g++ could not build the fast engine (_native/fastengine.cpp)")
    log(f"fast engine: g++ build of _native/fastengine.cpp loaded as "
        f"{fast_build['module'].__name__} in {fast_build['seconds']:.2f} s")
    log(_build.ptxas_report("sha256").strip())
    log(_build.ptxas_report("ed25519").strip())
    log(_build.ptxas_report("ed25519_mxu").strip())
    log(_build.ptxas_report("quorum").strip())
    log(_build.ptxas_report("mesh").strip())
    log(_build.ptxas_report("pack").strip())
    for name, (ops, static) in sass_mix(_build.so_path("sha256"), list(kernel_table())).items():
        int_ops = {k: v for k, v in ops.items() if k in INTEGER_ALU}
        log(f"sass {name}: {sum(ops.values())} instructions, integer ALU "
            f"{sum(int_ops.values())} {dict(sorted(int_ops.items()))}; "
            f"static_cycles_per_round={static:.2f}; all "
            f"{dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    for name, (ops, _) in sass_mix(_build.so_path("ed25519"), ["ed25519_verify"]).items():
        log(f"sass {name}: {sum(ops.values())} instructions (ladder and inversion loops "
            f"appear once); local stack loads LDL={ops.get('LDL', 0)} stores "
            f"STL={ops.get('STL', 0)}; all {dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    mxu_regs = ptxas_kernel(_build.ptxas_report("ed25519_mxu"), "ed25519_verify_mxu_kernel")
    log(f"ptxas ed25519_verify_mxu_kernel: {mxu_regs} (__launch_bounds__(256, 2): at most "
        f"128 registers, two blocks an SM; its noinline field functions' frames are above)")
    quorum_regs = ptxas_kernel(_build.ptxas_report("quorum"), "quorum_accumulate_kernel")
    log(f"ptxas quorum_accumulate_kernel: {quorum_regs}")
    if quorum_regs.get("spill_stores", 1) or quorum_regs.get("spill_loads", 1) or \
            quorum_regs.get("stack_bytes", 1):
        raise AssertionError(f"quorum_accumulate_kernel spills or has a stack: {quorum_regs}")
    for name, (ops, _) in sass_mix(_build.so_path("quorum"), ["quorum_accumulate"]).items():
        log(f"sass {name}: {sum(ops.values())} instructions; barriers BAR={ops.get('BAR', 0)} "
            f"atomics ATOMG={ops.get('ATOMG', 0)} REDG={ops.get('REDG', 0)} shared "
            f"ATOMS={ops.get('ATOMS', 0)} generic ATOM={ops.get('ATOM', 0)}; all "
            f"{dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")

    from mirbft_tpu_torch.ops.crossover import hash_crossover_batch, measure_hash_probe
    from mirbft_tpu_torch.ops import latency_probe

    latency, probe_hz = latency_probe.dependent_issue_latency()
    issue = {op: latency_probe.issue_cycles(op) for op in latency_probe.ISSUE_OPS}
    # (SM Hz, cycles per dependent instruction, issue cycles of IMAD.WIDE)
    clock = (sm_clock_hz(), latency, issue["IMAD.WIDE"])
    log(f"clock: sm_clock_mhz={clock[0] / 1e6:.0f} (nvidia-smi clocks.sm during a spin "
        f"kernel) dependent_issue_latency_cycles={latency:.4f} (SHF/LOP3/add chain, "
        f"csrc/latency_probe.cu) probe_clock_mhz={probe_hz / 1e6:.1f} "
        f"(clock64 over globaltimer) | {smi}")
    log("issue: cycles per warp instruction, one warp issuing independent "
        "instructions (pairs in turn): " + " ".join(
            f"{op}={cycles:.3f}" for op, cycles in issue.items()))
    log(f"rounds: the kernels' round chain alone (csrc/sha256_round.cuh, one warp, "
        f"no ring): {latency_probe.round_cycles(1):.3f} cycles per round, one message "
        f"per lane; {latency_probe.round_cycles(2):.3f} per step of two interleaved")
    log("field: cycles per call of a chain of dependent Ed25519 field operations "
        "(csrc/ed25519_field.cuh, one warp): " + " ".join(
            f"{op.replace(' ', '_')}={latency_probe.field_cycles(op):.1f}"
            for op in latency_probe.FIELD_OPS))
    mma_cycles = (latency_probe.mma_cycles(4), latency_probe.mma_cycles(8))
    log(f"mma: cycles per int8-by-uint8 m16n8k32 mma.sync (csrc/ed25519_mxu_tile.cuh's) of "
        f"one warp issuing independent MMAs, one warp on each of the SM's four "
        f"sub-partitions / two on each (csrc/latency_probe.cu): "
        f"m16n8k32={mma_cycles[0]:.2f}/{mma_cycles[1]:.2f}")
    log("tile: cycles per K tile of csrc/ed25519_mxu.cu's contraction (its own tile_block, "
        "operands staged in shared memory), one warp on each sub-partition / two / four "
        "(csrc/latency_probe.cu): kernel=" + "/".join(
            f"{latency_probe.tile_cycles(warps):.2f}" for warps in (4, 8, 16)))

    lap("device_build_probes")
    # The process's first verify probe, as a card's first verifier takes
    # it at construction (phase 3 builds one): its wall seconds are the
    # one-time cost of "auto"; the kernels are built and not yet loaded.
    (vpu_s, mxu_s), first_s = take_verify_probe()
    log(f"verify probe: vpu_s={vpu_s:.9f} mxu_s={mxu_s:.9f} (each kernel on 256 zero "
        f"rows, CUDA events, the first \"auto\" resolution's race) auto resolves to "
        f"{verify_counter()} first_use_wall_s={first_s:.6f} (loading both libraries, a "
        f"warm-up and 5 timed launches of each kernel) | {smi}")
    worst = check_kernels(clock)
    worst["pack_wave"] = check_pack()
    worst["ed25519_verify"], pool = check_ed25519(clock)
    worst["ed25519_verify_mxu"] = check_ed25519_mxu(clock, pool, mma_cycles[0])
    worst["quorum_accumulate"] = check_quorum()
    check_fused(clock)
    check_fused_mxu()
    probe = measure_hash_probe("cuda")
    log(f"crossover: lanes_tile_s={probe[0]:.9f} batch_fixed_s={probe[1]:.9f} "
        f"batch_slope_s_per_msg={probe[2]:.15f} (128 to 4096 messages) "
        f"crossover_batch={hash_crossover_batch('cuda')}")

    lap("kernels_fused")
    paths, host_fps = drive_paths()
    lap("paths")
    paths.update(drive_fast_paths(host_fps))
    lap("fast")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    paths.update(drive_deploy(host_fps))
    lap("deploy")
    mesh_results, mesh_timings = drive_mesh(host_fps, worst)
    paths.update(mesh_results)
    lap("mesh")
    kernels = report(paths, worst, clock, mesh_timings)
    lap("report")
    log(f"phase seconds: {phase_s}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
