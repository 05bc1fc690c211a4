"""Probes of the card's integer pipes: the dependent-issue latency (the
factor of the SHA-256 kernels' chain floor), issue costs, and the round
chain alone.

``dependent_issue_latency`` launches the chain probe of
``csrc/latency_probe.cu`` (one warp, a long SHF -> LOP3 -> add chain timed
with ``clock64()`` and the global timer) and returns the mean cycles
between one instruction of the chain and the next, with the SM clock the
chain ran at.  A SHA-256 round's loop-carried chain is four such
instructions, so a wave whose longest message has ``n`` live blocks takes at
least ``n * 64 * 4 * latency`` cycles (``chip_smoke.py``'s ``chain_floor_ms``).
``issue_cycles`` and ``round_cycles`` time the file's other two probes.
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
ISSUE_OPS = ("SHF", "LOP3", "IADD3", "IMAD", "SHF+LOP3", "SHF+IMAD", "SHF+IADD3")


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
