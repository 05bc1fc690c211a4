"""Stateless protocol math: quorums, bucket mapping, committed bitmask, and
the PBFT view-change decision function.

Rebuild of reference ``pkg/statemachine/stateless.go`` semantics:
quorum formulas (stateless.go:106-113), bucket mappings (:115-121), committed
bitmask (:32-100), ``constructNewEpochConfig`` (:123-321), and
``epochChangeHashData`` flattening (:323-352).  All functions are pure; they
run on host CPU — the only compute-heavy consumer (hashing the flattened
epoch-change data) is dispatched to the TPU batcher in ``mirbft_tpu_torch.ops``.
"""

from __future__ import annotations

import bisect

from typing import Dict, List, Mapping, Optional, Protocol, Tuple

from ..messages import (
    CheckpointMsg,
    ClientState,
    EpochChange,
    EpochChangeSetEntry,
    EpochConfig,
    NetworkConfig,
    NewEpochConfig,
)

# ---------------------------------------------------------------------------
# Quorums (reference stateless.go:106-113).
# ---------------------------------------------------------------------------


def intersection_quorum(config: NetworkConfig) -> int:
    """Nodes required so any two such sets share a correct node:
    ceil((n+f+1)/2) == (n+f+2)//2 in truncating math."""
    return (len(config.nodes) + config.f + 2) // 2


def some_correct_quorum(config: NetworkConfig) -> int:
    """Nodes such that at least one is correct: f+1."""
    return config.f + 1


# ---------------------------------------------------------------------------
# Bucket mapping (reference stateless.go:115-121).  Buckets partition the
# request space across leaders — the protocol-level parallelism of Mir.
# ---------------------------------------------------------------------------


def client_req_to_bucket(client_id: int, req_no: int, config: NetworkConfig) -> int:
    return (client_id + req_no) % config.number_of_buckets


def seq_to_bucket(seq_no: int, config: NetworkConfig) -> int:
    return seq_no % config.number_of_buckets


# ---------------------------------------------------------------------------
# Committed bitmask (reference stateless.go:18-100).  MSB-first within each
# byte, matching the reference's wire-compatible committed_mask layout.
# ---------------------------------------------------------------------------


class Bitmask:
    """Mutable MSB-first bitmask over a byte buffer."""

    __slots__ = ("_buf",)

    def __init__(self, data: bytes = b"", nbits: Optional[int] = None):
        if nbits is not None:
            size = (nbits + 7) // 8
            self._buf = bytearray(size)
            # never let the seed data grow the buffer past the declared size
            # (e.g. shrinking a client window must truncate the old mask)
            self._buf[: min(len(data), size)] = data[:size]
        else:
            self._buf = bytearray(data)

    def bits(self) -> int:
        return 8 * len(self._buf)

    def is_bit_set(self, bit_index: int) -> bool:
        byte_index = bit_index // 8
        if byte_index >= len(self._buf):
            return False
        return bool(self._buf[byte_index] & (0x80 >> (bit_index % 8)))

    def set_bit(self, bit_index: int) -> None:
        byte_index = bit_index // 8
        if byte_index >= len(self._buf):
            raise IndexError(
                f"bit {bit_index} out of range for {len(self._buf)}-byte mask"
            )
        self._buf[byte_index] |= 0x80 >> (bit_index % 8)

    def to_bytes(self) -> bytes:
        return bytes(self._buf)


def is_committed(req_no: int, client_state: ClientState) -> bool:
    """Reference stateless.go:18-30, with the window bound made exclusive:
    the client window is exactly ``width`` slots [lw, lw+width-1].  The
    reference exposes width+1 slots here (``> lw+width``) while its
    committing-client bookkeeping tracks width slots, which overflows its
    fixed slice and trips its full-window assertions once a large batch
    commits an entire client window within one checkpoint interval."""
    offset = req_no - client_state.low_watermark
    if offset < 0:
        return True
    if offset >= client_state.width:
        return False
    # Allocation-free Bitmask(...).is_bit_set(offset): this runs on the
    # window-allocation and commit-drain hot paths.
    mask = client_state.committed_mask
    byte_index = offset >> 3
    if byte_index >= len(mask):
        return False  # short/empty mask: bit unset (Bitmask.is_bit_set)
    return bool(mask[byte_index] & (0x80 >> (offset & 7)))


# ---------------------------------------------------------------------------
# Epoch-change hash flattening (reference stateless.go:323-352).  The result
# feeds an ActionHashRequest, which the TPU batcher concatenates + pads into a
# fixed-shape SHA-256 dispatch.
# ---------------------------------------------------------------------------


def uint64_to_bytes(value: int) -> bytes:
    return value.to_bytes(8, "big")


def epoch_change_hash_data(epoch_change: EpochChange) -> List[bytes]:
    """Flatten an EpochChange into the canonical byte-slice list whose hash
    identifies it: [new_epoch, (seq,value)*, (epoch,seq,digest)* for P and Q]."""
    out: List[bytes] = [uint64_to_bytes(epoch_change.new_epoch)]
    for cp in epoch_change.checkpoints:
        out.append(uint64_to_bytes(cp.seq_no))
        out.append(cp.value)
    for entry in epoch_change.p_set:
        out.append(uint64_to_bytes(entry.epoch))
        out.append(uint64_to_bytes(entry.seq_no))
        out.append(entry.digest)
    for entry in epoch_change.q_set:
        out.append(uint64_to_bytes(entry.epoch))
        out.append(uint64_to_bytes(entry.seq_no))
        out.append(entry.digest)
    return out


# ---------------------------------------------------------------------------
# The PBFT view-change decision function (reference stateless.go:123-321).
# ---------------------------------------------------------------------------


class ParsedEpochChangeLike(Protocol):
    """Minimal view of epoch_change.ParsedEpochChange needed here."""

    underlying: EpochChange
    low_watermark: int
    p_set: Mapping[int, EpochChangeSetEntry]  # seq_no -> entry
    q_set: Mapping[int, Mapping[int, bytes]]  # seq_no -> {epoch -> digest}


def construct_new_epoch_config(
    config: NetworkConfig,
    new_leaders: Tuple[int, ...],
    epoch_changes: Mapping[int, "ParsedEpochChangeLike"],
) -> Optional[NewEpochConfig]:
    """Deterministically derive the new-epoch configuration from ≥2f+1 epoch
    changes, or return None if no decision is possible yet.

    Implements the classic PBFT new-view computation, multi-bucket flavored:
    1. Starting checkpoint: the max seq checkpoint supported by a weak quorum
       (value agreement) whose seq is covered by an intersection quorum of
       low-watermarks.
    2. Per sequence in the 2-checkpoint-interval window after it, select a
       P-set digest satisfying conditions A1 (intersection quorum saw nothing
       newer/conflicting) and A2 (weak quorum has it in Q-set), else require
       condition B (intersection quorum has no P-entry → null request), else
       no decision yet.
    """
    # --- starting checkpoint selection ---
    checkpoint_supporters: Dict[Tuple[int, bytes], List[int]] = {}
    new_epoch_number = 0
    # iterate in config.nodes order for determinism
    for node in config.nodes:
        ec = epoch_changes.get(node)
        if ec is None:
            continue
        new_epoch_number = ec.underlying.new_epoch
        # dedup per node: a byzantine node listing the same checkpoint twice
        # must not count twice toward the weak quorum
        seen = set()
        for cp in ec.underlying.checkpoints:
            key = (cp.seq_no, cp.value)
            if key in seen:
                continue
            seen.add(key)
            checkpoint_supporters.setdefault(key, []).append(node)

    max_checkpoint: Optional[Tuple[int, bytes]] = None
    for key, supporters in checkpoint_supporters.items():
        if len(supporters) < some_correct_quorum(config):
            continue
        lower_watermarks = sum(
            1 for ec in epoch_changes.values() if ec.low_watermark <= key[0]
        )
        if lower_watermarks < intersection_quorum(config):
            continue
        if max_checkpoint is None:
            max_checkpoint = key
            continue
        if max_checkpoint[0] > key[0]:
            continue
        if max_checkpoint[0] == key[0]:
            raise AssertionError(
                f"two correct quorums disagree on checkpoint value at seq "
                f"{key[0]}: {max_checkpoint[1].hex()} != {key[1].hex()}"
            )
        max_checkpoint = key

    if max_checkpoint is None:
        return None

    cp_seq, cp_value = max_checkpoint
    window = 2 * config.checkpoint_interval
    final_preprepares: List[bytes] = [b""] * window
    any_selected = False

    # Precomputation for the per-sequence scan: the window is 2 checkpoint
    # intervals wide and p-sets are sparse (empty on a graceful rotation),
    # so probing every (offset, node) pair costs O(window * n) dict lookups
    # for nothing.  One pass over the p-sets yields, per offset, the
    # candidate entries in config.nodes order (the A-scan's iteration
    # order) and the count of changes that admit the seq with no P-entry
    # (condition B's numerator, combined with the sorted-watermark count).
    candidates: List[List] = [[] for _ in range(window)]
    entry_counts = [0] * window  # changes with lw < seq AND a P-entry at seq
    for node in config.nodes:  # deterministic order
        node_ec = epoch_changes.get(node)
        if node_ec is None:
            continue
        lw = node_ec.low_watermark
        for p_seq, p_entry in node_ec.p_set.items():
            p_off = p_seq - cp_seq - 1
            if 0 <= p_off < window:
                candidates[p_off].append(p_entry)
                if lw < p_seq:
                    entry_counts[p_off] += 1
    sorted_lws = sorted(ec.low_watermark for ec in epoch_changes.values())

    for offset in range(window):
        seq_no = cp_seq + 1 + offset
        selected: Optional[EpochChangeSetEntry] = None

        for entry in candidates[offset]:

            # Condition A1: ≥ intersection quorum of nodes whose watermark
            # admits seq_no either saw nothing newer at seq_no, or agree.
            a1 = 0
            for other in epoch_changes.values():
                if other.low_watermark >= seq_no:
                    continue
                other_entry = other.p_set.get(seq_no)
                if other_entry is None or other_entry.epoch < entry.epoch:
                    a1 += 1
                    continue
                if other_entry.epoch > entry.epoch:
                    continue
                if other_entry.digest == entry.digest:
                    a1 += 1
            if a1 < intersection_quorum(config):
                continue

            # Condition A2: a weak quorum preprepared this digest at an epoch
            # ≥ entry.epoch (it survives in their Q-sets).
            a2 = 0
            for other in epoch_changes.values():
                epoch_digests = other.q_set.get(seq_no)
                if not epoch_digests:
                    continue
                if any(
                    epoch >= entry.epoch and digest == entry.digest
                    for epoch, digest in epoch_digests.items()
                ):
                    a2 += 1
            if a2 < some_correct_quorum(config):
                continue

            selected = entry
            break

        if selected is not None:
            final_preprepares[offset] = selected.digest
            any_selected = True
            continue

        # Condition B: an intersection quorum has no P-entry at seq_no
        # (→ safe to fill with a null request).  #changes with lw < seq_no
        # minus those that do have a P-entry there (precomputed above).
        b_count = (
            bisect.bisect_left(sorted_lws, seq_no) - entry_counts[offset]
        )
        if b_count < intersection_quorum(config):
            return None  # cannot satisfy A or B yet; wait for more changes

    return NewEpochConfig(
        config=EpochConfig(
            number=new_epoch_number,
            leaders=new_leaders,
            planned_expiration=cp_seq + config.max_epoch_length,
        ),
        starting_checkpoint=CheckpointMsg(seq_no=cp_seq, value=cp_value),
        final_preprepares=tuple(final_preprepares) if any_selected else (),
    )
