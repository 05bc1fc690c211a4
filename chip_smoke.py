#!/usr/bin/env python3
"""Chip smoke for mirbft_tpu_torch: drive the port on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with one H100

Phases (any failure raises, and the script exits nonzero without a result):

1. device   the card's name and power limit (nvidia-smi) and torch's view of
            it; no card, or no port package beside this script -> exit 1.
2. build    every CUDA source of the port, one nvcc each, started together;
            build seconds, the ptxas report (registers, spills) and each
            kernel's SASS instruction mix (cuobjdump).
3. kernels  each kernel at every shape the hash plane gives it (block buckets
            4/16/64, waves of 64/1024/4096, ragged n_blocks including 0 and
            garbage words past every row's last block) against its plain
            PyTorch version on the card (exact) and hashlib (a sample of
            rows); CUDA-event times beside the bound.
4. paths    the main path: the c3 Recording (64 replicas, 64 clients x 100
            requests, batch 100) with the device hash plane on kernel="auto",
            held to the port's host-path run of the same Spec (steps and
            per-node checkpoints), all 6,400 requests committed on every node,
            no divergent checkpoint.  Its runs go host, device, device, host,
            so neither side always runs second, and one more device run is
            traced with torch.profiler for the card's busy time.  Then two
            4-node Recordings pinned to kernel="lanes" and kernel="scan", each
            held to its host-path run.  Every kernel's launch count is set to
            0 just before each device run and read just after; each run must
            launch the kernels it resolves to.
5. report   the kernels' times at the shapes those runs launched, one JSON
            line {"kernels": [...]}, the nvidia-smi line, and last the JSON
            device line.

Bounds: the operations of one live 64-byte block are counted as sm_90
instructions at their fan-in (a rotate is one SHF, any two- or three-input
logic one LOP3, up to three addends one IADD3), as in csrc/sha256.cu: 1,024
shifts and logic ops, which only the INT32 pipe runs (64 lanes per SM per
clock), and 360 adds, which the compiler may also issue as IMAD on the FMA
pipe.  The operation time is the larger of the shifts and logic at the INT32
rate and all 1,384 at the SM's issue ceiling (128 lanes per clock); the byte
time moves the live blocks, n_blocks and the digests at the HBM rate; the
bound is the larger of the two.
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
SEED = 20261016
DEVICE = "cuda"
# The main path: bench.py's c3 shape (BASELINE config 3) with its plane
# settings; and the 4-node shape of the pinned-kernel paths.
C3 = dict(node_count=64, client_count=64, reqs_per_client=100, batch_size=100)
C3_PLANE = dict(device=True, hash_wave=64, hash_floor=8, defer_unready=False)
SMALL = dict(node_count=4, client_count=4, reqs_per_client=20, batch_size=5)
SMALL_PLANE = dict(device=True, hash_wave=4, hash_floor=1, defer_unready=False)


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


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


def sass_mix(so):
    """kernel name -> {base opcode: count} of the built library's SASS, by
    cuobjdump beside nvcc; {} where cuobjdump is missing.  The block loop is
    not unrolled, so one block's instructions appear once per kernel."""
    import re

    from mirbft_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    mix, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = next((k for k in kernel_table() if k + "_kernel" in name), None)
            if current is not None:
                mix[current] = {}
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if current is not None and op:
            mix[current][op.group(1)] = mix[current].get(op.group(1), 0) + 1
    return mix


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


def ragged_wave(rng, wave, L, layout):
    """A packed wave of ``wave`` rows at block bucket ``L``: 7/8 real
    messages of ragged lengths (1..L blocks), padding rows with n_blocks 0,
    and random words in every block past a row's last one."""
    import numpy as np

    from mirbft_tpu_torch.ops.sha256 import pack_messages

    count = wave - wave // 8
    lengths = rng.integers(0, 64 * L - 8, size=count)
    messages = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]
    packed = pack_messages(messages, block_bucket=L, batch_bucket=wave, layout=layout)
    blocks, n_blocks = packed.blocks, packed.n_blocks
    b = np.arange(L)
    if layout == "batch":
        dead = b[None, :] >= n_blocks[:, None]
        blocks[dead] = rng.integers(0, 2**32, size=(int(dead.sum()), 16), dtype=np.uint32)
    else:
        dead = b[None, :, None, None, None] >= n_blocks[:, None, :, :, :]
        dead = np.broadcast_to(dead, blocks.shape[:1] + (L, 16) + blocks.shape[3:])
        blocks[dead] = rng.integers(0, 2**32, size=int(dead.sum()), dtype=np.uint32)
    return messages, blocks, n_blocks


def rows_of(words, layout):
    if layout == "lanes":
        return words.transpose(0, 2, 3, 1).reshape(-1, 8)
    return words


def check_kernels():
    """Phase 3: every kernel at every ladder shape against its plain version
    on the card and against hashlib."""
    import numpy as np
    import torch

    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.ops.sha256 import _H0, digests_from_words, wave_to_torch

    rng = np.random.default_rng(SEED)
    worst = {}
    for name, (kernel, plain, layout, _) in kernel_table().items():
        worst[name] = 0
        for wave in WAVES:
            for L in LADDER:
                messages, blocks, n_blocks = ragged_wave(rng, wave, L, layout)
                bt, nt = wave_to_torch(blocks, n_blocks, DEVICE)
                got = kernel(bt, nt)
                want = plain(bt, nt)
                torch.cuda.synchronize()
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
                plain_ms = time_plain(lambda: plain(bt, nt)) * 1e3
                bound_ms, by = bound_of(n_blocks, L, got.numel())
                log(f"kernel {name} wave={wave} L={L} rows={rows.shape[0]} "
                    f"ms={ms:.6f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} "
                    f"({by}) max_abs_err={err} hashlib_rows={len(sample)} ok")
    return worst


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


def reset_launches():
    for kernel, *_ in kernel_table().values():
        kernel.launches = 0


def read_launches():
    return {name: entry[0].launches for name, entry in kernel_table().items()}


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
    """(busy seconds, {name: count}) of the device events of a Chrome trace:
    kernels, copies and fills."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    busy, names = 0.0, {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += float(ev.get("dur", 0.0)) * 1e-6
            names[ev.get("name", "?")] = names.get(ev.get("name", "?"), 0) + 1
    return busy, names


def torch_sync():
    import torch

    torch.cuda.synchronize()


def drive_paths():
    """Phase 4: the main path (c3, kernel auto) and the two pinned-kernel
    4-node paths; returns per-path launches and the observed waves.

    Each path's runs go in the order of its ``order`` string: H a host-path
    run, D a device run, P a device run traced by torch.profiler.  Every run
    is held to the first host-path run."""
    from mirbft_tpu_torch.testengine import CryptoConfig, Spec

    paths = [
        ("c3_auto", C3, dict(C3_PLANE, kernel="auto"), None, "HDDHP"),
        ("4n_lanes", SMALL, dict(SMALL_PLANE, kernel="lanes"), "sha256_lanes", "HD"),
        ("4n_scan", SMALL, dict(SMALL_PLANE, kernel="scan"), "sha256_batch", "HD"),
    ]
    out_dir = os.path.join(HERE, "chiprun_out")
    results = {}
    for name, shape, crypto, pinned, order in paths:
        unique = shape["client_count"] * shape["reqs_per_client"]
        host_fp, walls, path_launches, waves = None, {"H": [], "D": []}, None, None
        for run, kind in enumerate(order):
            if kind == "H":
                _, steps, finals, wall, _ = run_spec(Spec(**shape))
                if host_fp is None:
                    host_fp = (steps, finals)
                elif (steps, finals) != host_fp:
                    raise AssertionError(f"{name}: host-path runs disagree")
                walls["H"].append(wall)
                log(f"path {name} run {run} host path: steps={steps} wall_s={wall:.3f}")
                continue
            profile = None
            if kind == "P":
                os.makedirs(out_dir, exist_ok=True)
                profile = os.path.join(out_dir, f"trace_{name}.json")
            reset_launches()
            with WaveLog() as run_waves:
                recording, steps, finals, wall, snap = run_spec(
                    Spec(**shape, crypto=CryptoConfig(**crypto, torch_device=DEVICE)),
                    profile=profile,
                )
            launches = read_launches()
            if (steps, finals) != host_fp:
                raise AssertionError(f"{name}: device run diverged from the host-path run")
            for node in recording.nodes:
                if sum(node.state.committed_reqs.values()) != unique:
                    raise AssertionError(f"{name}: node {node.id} did not commit all {unique}")
            dispatches = int(snap.get("device_hash_dispatches", 0))
            if dispatches <= 0 or sum(launches.values()) <= 0:
                raise AssertionError(f"{name}: no device hash wave launched")
            # The kernels this run resolved its waves to must each have
            # launched, and no other kernel may have.
            resolved = {f"sha256_{layout}" for (layout, _) in run_waves.waves}
            if pinned is not None and resolved != {pinned}:
                raise AssertionError(f"{name}: waves resolved to {resolved}, not {pinned}")
            for kernel, count in launches.items():
                if (count > 0) != (kernel in resolved):
                    raise AssertionError(f"{name}: {kernel} launched {count} times")
            if path_launches is None:
                path_launches, waves = launches, run_waves.waves
            elif launches != path_launches:
                raise AssertionError(f"{name}: launches {launches} != {path_launches}")
            if kind == "P":
                busy, names = device_busy(profile)
                log(f"path {name} run {run} device run under torch.profiler: "
                    f"wall_s={wall:.3f} device_busy_s={busy:.9f} "
                    f"idle_share={1 - busy / wall:.9f} device_events={names}"
                    if names else
                    f"path {name} run {run} device run under torch.profiler: "
                    f"wall_s={wall:.3f}; the trace held no device events: not measured")
                continue
            walls["D"].append(wall)
            device_msgs = int(snap.get("device_hashed_messages", 0))
            host = {k: int(snap.get(f"host_hashed_{k}_messages", 0))
                    for k in ("fast", "oversize", "straggler")}
            total_host = sum(host.values())
            unique_host = host["oversize"] + host["straggler"]
            log(f"path {name} run {run} device run: steps={steps} (== host path) "
                f"wall_s={wall:.3f} unique_req_per_s={unique / wall:.1f} "
                f"committed={unique} on every node")
            log(f"path {name} run {run} hash traffic: device_hash_dispatches={dispatches} "
                f"device_hashed_messages={device_msgs} host_hashed={host} "
                f"host_share={total_host / max(1, total_host + device_msgs):.6f} "
                f"unique_content_host_share={unique_host / max(1, unique_host + device_msgs):.6f}")
            log(f"path {name} run {run} host side of the waves: " + " ".join(
                f"{k}={snap.get(k, 0.0):.6f}" for k in (
                    "hash_pack_seconds_sum", "hash_device_dispatch_seconds_sum",
                    "device_wait_seconds_sum", "device_wait_seconds_count",
                    "host_crypto_seconds")))
            log(f"path {name} run {run} launches: {launches} waves: "
                f"{ {f'{k[0]}{list(k[1])}': v[0] for k, v in run_waves.waves.items()} }")
        if len(walls["H"]) > 1 or len(walls["D"]) > 1:
            host_s, dev_s = (sum(w) / len(w) for w in (walls["H"], walls["D"]))
            log(f"path {name} walls in order {order.replace('P', '')}: host {walls['H']} "
                f"device {walls['D']}; mean device/host {dev_s / host_s:.4f}")
        results[name] = (path_launches, waves)
    return results


def report(paths, worst):
    """Phase 5: time each kernel on the inputs its paths launched it on."""
    import numpy as np

    from mirbft_tpu_torch.ops.crossover import time_cuda
    from mirbft_tpu_torch.ops.sha256 import wave_to_torch

    kernels = []
    for name, (kernel, plain, layout, replaces) in kernel_table().items():
        launches = sum(launches[name] for launches, _ in paths.values())
        if launches <= 0:
            raise AssertionError(f"{name} was launched on no path")
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0}
        n = 0
        for path, (_, waves) in paths.items():
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
                log(f"path-wave {path} {name} shape={list(shape)} launches={count} "
                    f"live_blocks={int(np.minimum(n_blocks, L).sum())} ms={ms:.6f} "
                    f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.6f} ({by})")
                tot["ms"] += count * ms
                tot["plain_ms"] += count * plain_ms
                tot["bound_ms"] += count * bound_ms
                tot["ops" if by == "operations" else "bytes"] += count
                n += count
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mirbft_tpu_torch/csrc/sha256.cu",
            "replaces": replaces,
            "launches": launches,
            "launches_by_path": {p: launches_[name] for p, (launches_, _) in paths.items()},
            "max_abs_err": worst[name],
            "ms": tot["ms"] / n,
            "plain_ms": tot["plain_ms"] / n,
            "bound_ms": tot["bound_ms"] / n,
            "bound_by": "operations" if tot["ops"] >= tot["bytes"] else "bytes",
            "library_ms": None,
        })
    return kernels


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
    for name, ops in sass_mix(_build.so_path("sha256")).items():
        int_ops = {k: v for k, v in ops.items() if k in INTEGER_ALU}
        log(f"sass {name}: {sum(ops.values())} instructions, integer ALU "
            f"{sum(int_ops.values())} {dict(sorted(int_ops.items()))}; all "
            f"{dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")

    from mirbft_tpu_torch.ops.crossover import hash_crossover_batch, measure_hash_probe

    worst = check_kernels()
    # The one-time crossover probe launches both kernels: take it before the
    # paths, whose launch counts must hold path launches only.
    probe = measure_hash_probe("cuda")
    log(f"crossover: lanes_tile_s={probe[0]:.9f} batch_fixed_s={probe[1]:.9f} "
        f"batch_slope_s_per_msg={probe[2]:.15f} (128 to 4096 messages) "
        f"crossover_batch={hash_crossover_batch('cuda')}")

    paths = drive_paths()
    kernels = report(paths, worst)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
