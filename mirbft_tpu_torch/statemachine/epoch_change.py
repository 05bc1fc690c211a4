"""Epoch-change message parsing and ACK accumulation.

Rebuild of reference ``pkg/statemachine/epoch_change.go``: ``ParsedEpochChange``
validates + indexes the P/Q sets (:71-124); ``EpochChangeVotes`` (the
reference's ``epochChange``) accumulates per-digest ACKs until a strong cert
forms (:38-60).  Digests here are computed by the TPU hash batcher over
``epoch_change_hash_data`` flattenings.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from ..messages import EpochChange, EpochChangeSetEntry, NetworkConfig
from .stateless import intersection_quorum


class ParsedEpochChange:
    """Validated, indexed view of one EpochChange message
    (reference epoch_change.go:63-124)."""

    __slots__ = ("underlying", "p_set", "q_set", "low_watermark", "acks")

    def __init__(self, underlying: EpochChange):
        if not underlying.checkpoints:
            raise ValueError("epoch change did not contain any checkpoints")

        low_watermark = underlying.checkpoints[0].seq_no
        seen_cp = set()
        for cp in underlying.checkpoints:
            low_watermark = min(low_watermark, cp.seq_no)
            if cp.seq_no in seen_cp:
                raise ValueError(
                    f"epoch change checkpoints duplicated seq_no {cp.seq_no}"
                )
            seen_cp.add(cp.seq_no)

        p_set: Dict[int, EpochChangeSetEntry] = {}
        for entry in underlying.p_set:
            if entry.seq_no in p_set:
                raise ValueError(
                    f"epoch change p_set duplicated seq_no {entry.seq_no}"
                )
            p_set[entry.seq_no] = entry

        q_set: Dict[int, Dict[int, bytes]] = {}
        for entry in underlying.q_set:
            views = q_set.setdefault(entry.seq_no, {})
            if entry.epoch in views:
                raise ValueError(
                    f"epoch change q_set duplicated seq_no={entry.seq_no} "
                    f"epoch={entry.epoch}"
                )
            views[entry.epoch] = entry.digest

        self.underlying = underlying
        self.low_watermark = low_watermark
        self.p_set = p_set
        self.q_set = q_set
        self.acks: Set[int] = set()


def try_parse_epoch_change(underlying: EpochChange) -> Optional[ParsedEpochChange]:
    try:
        return ParsedEpochChange(underlying)
    except ValueError:
        return None


class EpochChangeVotes:
    """Per-origin ACK accumulation keyed by epoch-change digest
    (reference epoch_change.go:18-60)."""

    __slots__ = ("network_config", "parsed_by_digest", "strong_cert")

    def __init__(self, network_config: NetworkConfig):
        self.network_config = network_config
        self.parsed_by_digest: Dict[bytes, ParsedEpochChange] = {}
        # digest of the EpochChange with a strong quorum of acks, if any
        self.strong_cert: Optional[bytes] = None

    def add_ack(self, source: int, msg: EpochChange, digest: bytes) -> None:
        parsed = self.parsed_by_digest.get(digest)
        if parsed is None:
            parsed = try_parse_epoch_change(msg)
            if parsed is None:
                return  # malformed; drop
            self.parsed_by_digest[digest] = parsed
        parsed.acks.add(source)
        if (
            self.strong_cert is None
            and len(parsed.acks) >= intersection_quorum(self.network_config)
        ):
            self.strong_cert = digest
