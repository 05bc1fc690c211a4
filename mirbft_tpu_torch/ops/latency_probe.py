"""Probes of the card's integer pipes: the dependent-issue latency (the
factor of the SHA-256 kernels' chain floor), issue costs, the round chain
alone, and the latency of one Ed25519 field operation.

``dependent_issue_latency`` launches the chain probe of
``csrc/latency_probe.cu`` (one warp, a long SHF -> LOP3 -> add chain timed
with ``clock64()`` and the global timer) and returns the mean cycles
between one instruction of the chain and the next, with the SM clock the
chain ran at.  A SHA-256 round's loop-carried chain is four such
instructions, so a wave whose longest message has ``n`` live blocks takes at
least ``n * 64 * 4 * latency`` cycles (``chip_smoke.py``'s ``chain_floor_ms``).
``issue_cycles``, ``round_cycles`` and ``field_cycles`` time the file's
other probes, and ``launch_floor_ms`` an empty kernel's launch.
They measure the card only: there is no CPU version.
"""

from __future__ import annotations

from typing import Tuple

# 16.5 M dependent instructions, about 0.04 s at 2 GHz: long enough that
# the launch and the timer reads do not show.
_TRIPS = 1 << 18


def dependent_issue_latency(trips: int = _TRIPS) -> Tuple[float, float]:
    """(cycles per dependent instruction, SM clock in Hz during the chain),
    measured on the current CUDA device."""
    import torch

    from . import _build

    if not torch.cuda.is_available():
        raise RuntimeError("the latency probe runs on a CUDA card only")
    lib = _build.library("latency_probe")
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    code = lib.mirbft_chain_latency(
        out.data_ptr(), 20261016, trips, torch.cuda.current_stream().cuda_stream
    )
    _build.check(lib, code, "chain_latency")
    cycles, nanos, _ = (int(v) for v in out.cpu())
    links = trips * lib.mirbft_chain_links_per_trip()
    return cycles / links, cycles / nanos * 1e9


# Instruction mixes of ``issue_cycles``.
ISSUE_OPS = ("SHF", "LOP3", "IADD3", "IMAD", "SHF+LOP3", "SHF+IMAD", "SHF+IADD3",
             "IMAD.WIDE", "IMAD.HI")


def issue_cycles(op: str, trips: int = 1 << 14) -> float:
    """Cycles per warp instruction when one warp issues independent
    instructions of ``op`` (one of ``ISSUE_OPS``; a pair alternates): the
    issue cost of that mix on one SM sub-partition."""
    import torch

    from . import _build

    lib = _build.library("latency_probe")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    code = lib.mirbft_issue_probe(
        out.data_ptr(), ISSUE_OPS.index(op), 7, trips,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, code, "issue_probe")
    return int(out[0].item()) / (trips * lib.mirbft_issue_per_trip())


def round_cycles(messages_per_lane: int = 1, blocks: int = 1 << 12) -> float:
    """Cycles per round step of the kernels' round chain
    (``csrc/sha256_round.cuh``) run by one warp on KW in shared memory, with
    no ring and no producers; with two messages per lane a step is one round
    of each."""
    import torch

    from . import _build

    lib = _build.library("latency_probe")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    code = lib.mirbft_rounds_probe(
        out.data_ptr(), messages_per_lane, 7, blocks,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, code, "rounds_probe")
    return int(out[0].item()) / (blocks * 64)


# Field operations of ``field_cycles`` (csrc/ed25519_field.cuh); "fe_mul x2"
# is two independent multiply chains in turn, a call being one of each.
FIELD_OPS = ("fe_mul", "fe_sqr", "fe_add", "fe_sub", "fe_mul x2")


def field_cycles(op: str, calls: int = 1 << 12) -> float:
    """Cycles per call of the field operation ``op`` (one of ``FIELD_OPS``)
    when one warp runs a chain of calls, each on the last one's result: the
    latency of that operation in the verify kernel's chain of stages."""
    import torch

    from . import _build

    lib = _build.library("latency_probe")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    code = lib.mirbft_field_probe(
        out.data_ptr(), FIELD_OPS.index(op), 7, calls,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(lib, code, "field_probe")
    return int(out[0].item()) / calls


def launch_floor_ms(repeats: int = 20) -> float:
    """Device milliseconds per launch of an empty kernel, back to back on
    the current stream by ``crossover.time_cuda``: the floor under any
    launch, against which a one-wave quorum launch is read."""
    import torch

    from . import _build
    from .crossover import time_cuda

    lib = _build.library("latency_probe")

    def launch():
        _build.check(lib, lib.mirbft_empty_launch(torch.cuda.current_stream().cuda_stream),
                     "empty_launch")

    return time_cuda(launch, repeats=repeats) * 1e3
