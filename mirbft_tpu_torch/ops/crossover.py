"""Measured kernel crossover: pick the hash kernel per wave empirically.

The lanes-major kernel pays a fixed cost per 1024-message tile; the
batch-major kernel pays a fixed cost per launch and scales per message.  So
``kernel="auto"`` resolves each wave through a measured crossover:

* For CPU tensors the answer is static: "scan", the plain twin.  Measuring
  the twins would only add noise.
* On the card, a one-time probe per process times one lanes tile and the
  batch-major kernel at two wave sizes, which give its fixed cost and its
  per-message slope (CUDA events around launches on device-resident
  inputs).  The break-even wave is
  ``(lanes_tile_time - batch_fixed_time) / batch_per_message_time``:
  waves at or above it launch the lanes kernel; smaller waves keep the
  batch-major kernel.  ``TorchHasher`` takes the probe when it is built,
  so no wave's latency carries it.

The verifier's field-multiply backend resolves the same way: on the CPU
``auto`` is "vpu"; on the card the first ``auto`` resolution of a process
races the two verify kernels, "vpu" (``csrc/ed25519.cu``) and "mxu"
(``csrc/ed25519_mxu.cu``, the contraction on the tensor cores), on one
``_PROBE_VERIFY_BATCH``-row wave (``measure_verify_probe``, cached for the
process) and keeps the faster, as the JAX package does on its accelerator.
``Ed25519BatchVerifier`` resolves "auto" on the card when it is built, so
no dispatch's latency carries the probe either.

Every resolver takes the backend name and the probe result as injectable
arguments, so the CPU tests pin the resolution logic.  The environment
overrides ``MIRBFT_TPU_TORCH_HASH_KERNEL`` and
``MIRBFT_TPU_TORCH_VERIFY_KERNEL`` short-circuit everything for A/B runs
(names of their own, so this package and the JAX package can be set apart
in one process).
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Callable, Optional, Tuple

import numpy as np

ENV_HASH_KERNEL = "MIRBFT_TPU_TORCH_HASH_KERNEL"
ENV_VERIFY_KERNEL = "MIRBFT_TPU_TORCH_VERIFY_KERNEL"

# Probe shape: one lanes tile of 4-block messages — the smallest shape that
# exercises the lanes kernel's real geometry, and the block bucket the
# planes' BLOCK_LADDER dispatches most.  The batch-major slope is taken
# between the smallest and the largest wave the crossover can pick from.
_PROBE_BLOCK_BUCKET = 4
_PROBE_BATCHES = (128, 4096)
_PROBE_VERIFY_BATCH = 256


def time_cuda(fn: Callable[[], object], repeats: int = 20) -> float:
    """Device seconds per call of ``fn`` on the current stream, by CUDA
    events around ``repeats`` calls after one warm-up call.

    A spin kernel holds the stream while the host enqueues the calls, so
    the events bracket back-to-back device work and not the host's launch
    overhead (which exceeds a small wave's kernel time)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of device cycles
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / repeats


def _default_backend() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


@functools.lru_cache(maxsize=None)
def measure_hash_probe(backend: Optional[str] = None) -> Tuple[float, float, float]:
    """(lanes_tile_seconds, batch_fixed_seconds, batch_per_message_seconds)
    measured on the card: the batch-major kernel's line through its times
    at the two probe waves (the slope may come out zero or below when both
    are one pass of threads).  Only called for the "cuda" backend (callers
    gate)."""
    from .sha256 import wave_to_torch
    from .sha256_pallas import sha256_batch
    from .sha256_pallas_lanes import TILE, pack_lanes_major, sha256_lanes

    small, large = _PROBE_BATCHES
    rng = np.random.default_rng(7)
    blocks = rng.integers(
        0, 2**32, size=(large, _PROBE_BLOCK_BUCKET, 16), dtype=np.uint32
    )
    n_blocks = np.full(large, _PROBE_BLOCK_BUCKET, dtype=np.uint32)
    lanes = wave_to_torch(*pack_lanes_major(blocks[:TILE], n_blocks[:TILE]), "cuda")
    lanes_t = time_cuda(lambda: sha256_lanes(*lanes))
    batch_t = []
    for size in (small, large):
        wave = wave_to_torch(blocks[:size], n_blocks[:size], "cuda")
        batch_t.append(time_cuda(lambda: sha256_batch(*wave)))
    slope = (batch_t[1] - batch_t[0]) / (large - small)
    return lanes_t, batch_t[0] - slope * small, slope


def hash_crossover_batch(
    backend: Optional[str] = None,
    probe: Optional[Tuple[float, float, float]] = None,
) -> int:
    """Smallest wave size at which the lanes kernel should win; waves below
    it keep the batch-major kernel.  Off the card the answer is "never" (a
    sentinel above any real wave)."""
    env = os.environ.get(ENV_HASH_KERNEL)
    if env == "lanes":
        return 1
    if env in ("scan", "pallas"):
        return 1 << 30
    backend = backend or _default_backend()
    if backend != "cuda":
        return 1 << 30
    from .sha256_pallas_lanes import TILE

    if probe is None:
        probe = measure_hash_probe(backend)
    lanes_tile_t, batch_fixed_t, batch_per_msg_t = probe
    excess = lanes_tile_t - batch_fixed_t
    if excess <= 0:
        return TILE // 8
    if batch_per_msg_t <= 0:
        return TILE
    crossover = int(excess / batch_per_msg_t)
    # A wave always pads to whole tiles, so below an eighth of a tile the
    # padding waste dominates regardless of the slope; above one tile the
    # lanes kernel amortizes by construction.
    return max(TILE // 8, min(crossover, TILE))


def resolve_hash_kernel(
    requested: str,
    batch: int,
    backend: Optional[str] = None,
    probe: Optional[Tuple[float, float, float]] = None,
) -> str:
    """Resolve a hasher's ``kernel`` setting for one wave of ``batch``
    messages: explicit names pass through, ``auto`` applies the measured
    crossover ("scan" on the CPU, "lanes" on the card past the crossover)."""
    if requested != "auto":
        return requested
    env = os.environ.get(ENV_HASH_KERNEL)
    if env in ("scan", "pallas", "lanes"):
        return env
    if batch >= hash_crossover_batch(backend, probe):
        return "lanes"
    return "scan"


# The verify probe's cache fills under the lock.
MIRLINT_SHARED_STATE = {"_verify_probe": "_VERIFY_PROBE_LOCK"}
_VERIFY_PROBE_LOCK = threading.Lock()


def measure_verify_probe(backend: Optional[str] = None) -> Tuple[float, float]:
    """(vpu_seconds, mxu_seconds) for one ``_PROBE_VERIFY_BATCH`` verify
    wave on the card, each kernel timed by CUDA events on the same zero
    rows; measured once per process.  Threads that ask together wait for
    the one probe (a cache alone lets each miss measure, and they would
    time each other's kernels).  Only called for the "cuda" backend
    (callers gate)."""
    with _VERIFY_PROBE_LOCK:
        return _verify_probe(backend)


@functools.lru_cache(maxsize=None)
def _verify_probe(backend: Optional[str]) -> Tuple[float, float]:
    import torch

    from .ed25519 import NUM_LIMBS, ed25519_verify_kernel

    batch = _PROBE_VERIFY_BATCH
    limbs = torch.zeros((batch, NUM_LIMBS), dtype=torch.int32, device="cuda")
    bits = torch.zeros((batch, 256), dtype=torch.int32, device="cuda")

    def wave(name):
        return lambda: ed25519_verify_kernel(limbs, limbs, limbs, bits, bits, backend=name)

    return time_cuda(wave("vpu"), repeats=5), time_cuda(wave("mxu"), repeats=5)


def resolve_verify_backend(
    requested: str,
    backend: Optional[str] = None,
    probe: Optional[Tuple[float, float]] = None,
) -> str:
    """Resolve a verifier's ``kernel`` setting: explicit names pass
    through; ``auto`` is "vpu" on the CPU and the probe's winner on the
    card ("mxu" exactly when it is faster), the probe taken once per
    process unless one is given."""
    if requested != "auto":
        return requested
    env = os.environ.get(ENV_VERIFY_KERNEL)
    if env in ("vpu", "mxu"):
        return env
    backend = backend or _default_backend()
    if backend != "cuda":
        return "vpu"
    if probe is None:
        probe = measure_verify_probe(backend)
    vpu_t, mxu_t = probe
    return "mxu" if mxu_t < vpu_t else "vpu"
