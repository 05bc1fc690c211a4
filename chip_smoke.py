#!/usr/bin/env python3
"""Chip smoke for mirbft_tpu_torch: drive the port on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with one H100

Phases (any failure raises, and the script exits nonzero without a result):

1. device   the card's name and power limit (nvidia-smi) and torch's view of
            it; no card, or no port package beside this script -> exit 1.
2. build    every CUDA source of the port, one nvcc each, started together;
            build seconds, the ptxas report (registers, spills, the local
            stack; the quorum kernel must have no spill and no stack) and
            each kernel's SASS instruction mix (cuobjdump).  Then
            the SM clock (nvidia-smi, sampled while a spin kernel runs) and
            the integer pipes (csrc/latency_probe.cu): the dependent-issue
            latency, the issue cost of each instruction kind, the SHA-256
            kernels' round chain alone, and the latency of each Ed25519
            field operation.
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
            the verifier (rejected).  Then the quorum kernel (gate and
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
            for bit against its plain version on the card.
4. fused    the fused wave at the bench's width (bench.py's
            bench_fused_pipeline: 4,096 messages of 640 bytes, 4,096 slots,
            4 digest slots, eight one-touch quorum waves): digests against
            hashlib on every row, quorum state against the plain version
            fed the same streams, fused_wave_4096_ms pipelined 20 deep; the
            same wave with 1,024 signed rows riding it (a corrupt signer's
            among them), verdicts against verify_torch on the card and
            verify_one on 64 sampled rows; and a two-wave chain (the second
            gated on the first's digests), a partial collect and a full
            one, against host_fused_reference, every lease released.
5. paths    the main path: the c3 Recording (64 replicas, 64 clients x 100
            requests, batch 100) with the device hash plane on kernel="auto",
            held to the port's host-path run of the same Spec (steps and
            per-node checkpoints), all 6,400 requests committed on every node,
            no divergent checkpoint.  Its runs go host, device, device, host,
            so neither side always runs second, and one more device run is
            traced with torch.profiler for the card's busy time.  Then two
            4-node Recordings pinned to kernel="lanes" and kernel="scan", each
            held to its host-path run.  The signed paths: c2_signed, bench.py's
            c2py_16n_signed shape (16 replicas, 16 clients x 50 Ed25519-signed
            requests, batch 100, auth_wave 1,024), host, device, device, host,
            all 800 requests committed on every node; and 4n_signed_corrupt
            (4 replicas, 4 x 20 signed requests, client 3 a corrupt signer),
            whose 60 honest requests commit on every node and client 3's on
            none, with at least one corrupt row rejected by the kernel itself.
            Then the same three through the fused pipeline (fused=True):
            c3_fused, c2_signed_fused (with hash_floor 1, so that c2's 32
            unique digests reach the card at all) and
            4n_signed_corrupt_fused, each device run held to the host-path
            run of its unfused twin, with fused waves launched and the
            signatures that rode fused waves and the auth plane's own waves
            counted.  Every kernel's launch count is set to 0 just before each device
            run and read just after; each run must launch exactly the kernels
            its waves resolve to.
6. report   the kernels' times at the shapes those runs launched, one JSON
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
C3_ORDER = "HDDHP"
C2_ORDER = "HDDHP"
C3_FUSED_ORDER = "DD"
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
# The fused bench wave (bench.py bench_fused_pipeline) and the signed rows
# of c2's verify wave that ride it in the signed case.
FUSED_BATCH, FUSED_MSG_LEN, FUSED_DEPTH = 4096, 640, 20
FUSED_SLOTS, FUSED_DIGEST_SLOTS = 4096, 4
FUSED_SIGNED = 1024


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
    dependent instruction)."""
    import numpy as np

    hz, latency = clock
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

    def timed(kwargs_of):
        torch_sync()
        start = time.perf_counter()
        handles = [pipe.dispatch_wave(msg_sets[i % 2], quorum=quorum, **kwargs_of(i))
                   for i in range(FUSED_DEPTH)]
        pipe.collect(handles[-1])
        piped = (time.perf_counter() - start) / FUSED_DEPTH
        for h in handles:
            pipe._release_lease(h)
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
    piped = timed(lambda i: {})
    same_state("pipelined waves")

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
    piped_signed = timed(lambda i: {"signed": signed})
    same_state("pipelined signed waves")

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
    bound_ms, signed_bound_ms = fused_bound(pipe, quorum, FUSED_SIGNED, clock[0])
    log(f"fused_wave messages={FUSED_BATCH} msg_len={FUSED_MSG_LEN} layout={layout} "
        f"rows={handle.rows} quorum_waves={len(quorum)} depth={FUSED_DEPTH} "
        f"fused_wave_4096_ms={piped * 1e3:.6f} bound_ms={bound_ms:.6f} "
        f"signed_rows={FUSED_SIGNED} fused_wave_4096_signed_ms={piped_signed * 1e3:.6f} "
        f"signed_bound_ms={signed_bound_ms:.6f} (sums of the stages' bounds) "
        f"corrupt_rows_rejected_by_the_kernel={rejected} of {len(corrupt)} "
        f"verify_one_rows={len(sample)} chain: wave 2 layout={h2.layout} gated on "
        f"wave 1 rows, collect_ready + collect == host_fused_reference, leases released | "
        f"{nvidia_smi_line()}")
    return {"fused_wave_4096_ms": piped * 1e3, "fused_wave_4096_signed_ms": piped_signed * 1e3,
            "bound_ms": bound_ms, "signed_bound_ms": signed_bound_ms}


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
        self.waves = {}  # (layout, blocks shape) -> (dispatches, (blocks, n_blocks))
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
            key = (packed.layout, packed.blocks.shape)
            count, _ = log_.waves.get(key, (0, None))
            log_.waves[key] = (count + 1, (packed.blocks.copy(), packed.n_blocks.copy()))
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
            key = (packed.layout, packed.blocks.shape)
            count, _ = log_.waves.get(key, (0, None))
            log_.waves[key] = (count + 1, (packed.blocks.copy(), packed.n_blocks.copy()))
            return log_.real(hasher, packed)

        self.cls.dispatch_packed = dispatch_packed
        return self

    def __exit__(self, *exc):
        self.cls.dispatch_packed = self.real


class VerifyLog:
    """Observes the auth plane's verify waves by wrapping the verifier:
    each dispatch's rows and real rows, the packed inputs of each wave shape
    (the latest), and each collect's validity mask and kernel verdicts.
    Launches are counted only by the kernel wrapper."""

    def __init__(self):
        from mirbft_tpu_torch.ops.ed25519 import Ed25519BatchVerifier

        self.cls = Ed25519BatchVerifier
        self.real = (self.cls.dispatch, self.cls.pack_inputs, self.cls.collect)
        self.waves = []  # (rows, real rows) per dispatch
        self.inputs = {}  # rows -> (dispatches, packed arrays)
        self.verdicts = []  # (valid, kernel verdict) per collect, real rows only
        self.real_rows = {}  # id(in-flight handle) -> its real rows

    def __enter__(self):
        dispatch, pack_inputs, collect = self.real
        log_ = self

        def wrapped_dispatch(verifier, pubs, msgs, sigs, n_real=None):
            real = len(pubs) if n_real is None else n_real
            log_.waves.append((len(pubs), real))
            handle = dispatch(verifier, pubs, msgs, sigs, n_real)
            log_.real_rows[id(handle)] = real
            return handle

        def wrapped_pack(verifier, pubs, msgs, sigs, batch=None):
            packed = pack_inputs(verifier, pubs, msgs, sigs, batch)
            rows = packed[0].shape[0]
            count, _ = log_.inputs.get(rows, (0, None))
            log_.inputs[rows] = (count + 1, tuple(a.copy() for a in packed))
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
    from mirbft_tpu_torch.ops import ed25519

    from mirbft_tpu_torch.ops import quorum

    kernels = {name: entry[0] for name, entry in kernel_table().items()}
    kernels["ed25519_verify"] = ed25519.ed25519_verify_kernel
    kernels["quorum_accumulate"] = quorum.quorum_accumulate
    return kernels


def reset_launches():
    for kernel in counted_kernels().values():
        kernel.launches = 0


def read_launches():
    return {name: kernel.launches for name, kernel in counted_kernels().items()}


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
    by_seq = {}
    for seq, digest in finals:
        by_seq.setdefault(seq, set()).add(digest)
    if any(len(d) != 1 for d in by_seq.values()):
        raise AssertionError("divergent checkpoint")
    return recording, steps, finals, wall, metrics.snapshot()


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
                    SignClock() as signing:
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
            if signed and (verifies <= 0 or launches["ed25519_verify"] <= 0):
                raise AssertionError(f"{name}: no verify wave launched the kernel")
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
            resolved = {f"sha256_{layout}" for (layout, _) in all_waves}
            if run_verify.waves or any(run_fused.signed):
                resolved.add("ed25519_verify")
            if run_fused.signed:
                resolved.add("quorum_accumulate")
            if pinned is not None and resolved != {pinned}:
                raise AssertionError(f"{name}: waves resolved to {resolved}, not {pinned}")
            for kernel, count in launches.items():
                if (count > 0) != (kernel in resolved):
                    raise AssertionError(f"{name}: {kernel} launched {count} times")
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
                f"{dev_s / host_s:.4f}; mean fused/unfused device {dev_s / twin_s:.4f}")
        elif len(walls["H"]) > 1 or len(walls["D"]) > 1:
            host_s, dev_s = (sum(w) / len(w) for w in (walls["H"], walls["D"]))
            log(f"path {name} walls in order {order.replace('P', '')}: host {walls['H']} "
                f"device {walls['D']}; mean device/host {dev_s / host_s:.4f}")
        results[name] = (path_launches, waves, verify_inputs, quorum_inputs)
    return results


def report(paths, worst, clock):
    """Phase 6: time each kernel on the inputs its paths launched it on."""
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
            for (wave_layout, shape), (count, (blocks, n_blocks)) in waves.items():
                if wave_layout != layout:
                    continue
                bt, nt = wave_to_torch(blocks, n_blocks, DEVICE)
                got, want = kernel(bt, nt), plain(bt, nt)
                torch_sync()
                err = int(np.abs(u32(got).astype(np.int64) - u32(want).astype(np.int64)).max())
                worst[name] = max(worst[name], err)
                if err:
                    raise AssertionError(f"{name}: kernel != plain on a path wave {shape}")
                L = shape[1]
                bound_ms, by = bound_of(n_blocks, L, got.numel())
                ms = time_cuda(lambda: kernel(bt, nt)) * 1e3
                plain_ms = time_plain(lambda: plain(bt, nt)) * 1e3
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
    kernels.append(report_ed25519(paths, worst, clock))
    kernels.append(report_quorum(paths, worst))
    return kernels


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
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0, "bytes": 0}
    n = 0
    for path, (_, _, inputs, _) in paths.items():
        for rows, (count, packed) in (inputs or {}).items():
            tensors = [torch.from_numpy(a).to(DEVICE) for a in packed[:5]]
            got, want = e.ed25519_verify_kernel(*tensors), e.verify_torch(*tensors)
            torch_sync()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            worst[name] = max(worst[name], err)
            if err:
                raise AssertionError(f"{name}: kernel != plain on a path wave of {rows} rows")
            ms = time_cuda(lambda: e.ed25519_verify_kernel(*tensors), repeats=5) * 1e3
            plain_ms = time_plain(lambda: e.verify_torch(*tensors)) * 1e3
            bound_ms, by = verify_bound(rows, clock[0])
            log(f"path-wave {path} {name} rows={rows} valid_rows={int(packed[5].sum())} "
                f"launches={count} ms={ms:.6f} plain_ms={plain_ms:.3f} "
                f"bound_ms={bound_ms:.6f} ({by}) of_bound={bound_ms / ms:.4f} "
                f"cycles_per_mul={cycles_per_mul(ms, clock):.1f}")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * bound_ms
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

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} "
        f"x{torch.cuda.device_count()}")

    from mirbft_tpu_torch import _native

    log(f"native ack/vote planes (g++ build of _native/ackplane.cpp): "
        f"{'loaded' if _native.available else 'unavailable, pure-Python planes'}")
    start = time.perf_counter()
    seconds = _build.build_all()
    log(f"build: {seconds} wall_s={time.perf_counter() - start:.2f}")
    log(_build.ptxas_report("sha256").strip())
    log(_build.ptxas_report("ed25519").strip())
    log(_build.ptxas_report("quorum").strip())
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

    from mirbft_tpu_torch.ops.crossover import (
        hash_crossover_batch,
        measure_hash_probe,
        measure_verify_probe,
    )
    from mirbft_tpu_torch.ops import latency_probe

    latency, probe_hz = latency_probe.dependent_issue_latency()
    clock = (sm_clock_hz(), latency)
    log(f"clock: sm_clock_mhz={clock[0] / 1e6:.0f} (nvidia-smi clocks.sm during a spin "
        f"kernel) dependent_issue_latency_cycles={latency:.4f} (SHF/LOP3/add chain, "
        f"csrc/latency_probe.cu) probe_clock_mhz={probe_hz / 1e6:.1f} "
        f"(clock64 over globaltimer) | {smi}")
    log("issue: cycles per warp instruction, one warp issuing independent "
        "instructions (pairs in turn): " + " ".join(
            f"{op}={latency_probe.issue_cycles(op):.3f}" for op in latency_probe.ISSUE_OPS))
    log(f"rounds: the kernels' round chain alone (csrc/sha256_round.cuh, one warp, "
        f"no ring): {latency_probe.round_cycles(1):.3f} cycles per round, one message "
        f"per lane; {latency_probe.round_cycles(2):.3f} per step of two interleaved")
    log("field: cycles per call of a chain of dependent Ed25519 field operations "
        "(csrc/ed25519_field.cuh, one warp): " + " ".join(
            f"{op.replace(' ', '_')}={latency_probe.field_cycles(op):.1f}"
            for op in latency_probe.FIELD_OPS))

    worst = check_kernels(clock)
    worst["ed25519_verify"] = check_ed25519(clock)
    worst["quorum_accumulate"] = check_quorum()
    check_fused(clock)
    # The one-time probes launch the kernels: take them before the paths,
    # whose launch counts must hold path launches only.
    probe = measure_hash_probe("cuda")
    log(f"crossover: lanes_tile_s={probe[0]:.9f} batch_fixed_s={probe[1]:.9f} "
        f"batch_slope_s_per_msg={probe[2]:.15f} (128 to 4096 messages) "
        f"crossover_batch={hash_crossover_batch('cuda')}")
    log(f"verify probe: vpu_s={measure_verify_probe('cuda')[0]:.9f} (256 zero rows); "
        f"auto resolves to vpu, the card's one verify kernel")

    paths = drive_paths()
    kernels = report(paths, worst, clock)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
