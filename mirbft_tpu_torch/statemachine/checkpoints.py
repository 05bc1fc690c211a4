"""Checkpoint agreement tracking and watermark garbage collection.

Rebuild of reference ``pkg/statemachine/checkpoints.go``: per-seq checkpoint
value agreement (f+1 → committed value; self + intersection quorum → stable,
:270-305), ≥3 active checkpoint windows, highest-checkpoint tracking per node
for far-future GC (:199-241), and buffered checkpoint messages.

Deviation from the reference (hardening): ``Checkpoint.apply_checkpoint_msg``
dedups votes per source node — the reference counts a duplicate Checkpoint
message from the same node twice toward quorum (checkpoints.go:277-279).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

from ..messages import CEntry, CheckpointMsg, Msg, NetworkConfig
from ..state import EventInitialParameters
from .msgbuffers import Applyable, MsgBuffer, NodeBuffers
from .persisted import PersistedLog
from .stateless import intersection_quorum, some_correct_quorum


class CheckpointState(enum.IntEnum):
    IDLE = 0
    GARBAGE_COLLECTABLE = 1


class Checkpoint:
    """Agreement state for one checkpoint seq_no (reference checkpoints.go:247-305)."""

    __slots__ = (
        "seq_no",
        "my_id",
        "network_config",
        "logger",
        "values",
        "committed_value",
        "my_value",
        "stable",
    )

    def __init__(self, seq_no: int, network_config: NetworkConfig, my_id: int, logger=None):
        self.seq_no = seq_no
        self.my_id = my_id
        self.network_config = network_config
        self.logger = logger
        self.values: Dict[bytes, List[int]] = {}
        self.committed_value: Optional[bytes] = None
        self.my_value: Optional[bytes] = None
        self.stable = False

    def apply_checkpoint_msg(self, source: int, value: bytes) -> None:
        supporters = self.values.setdefault(value, [])
        if source in supporters:
            return  # dedup double-votes (hardening vs reference)
        supporters.append(source)
        agreements = len(supporters)

        if agreements == some_correct_quorum(self.network_config):
            self.committed_value = value
        if source == self.my_id:
            self.my_value = value

        if self.my_value is not None and self.committed_value is not None and not self.stable:
            if value != self.committed_value:
                # Byzantine-assumption violation; reference panics here too.
                raise AssertionError(
                    "my checkpoint disagrees with the committed network view"
                )
            # >= (not ==): our own agreement may arrive after 2f+1 others.
            if agreements >= intersection_quorum(self.network_config):
                self.stable = True
                if self.logger is not None:
                    self.logger.debug(
                        "checkpoint stable",
                        seq_no=self.seq_no,
                        agreements=agreements,
                    )


class CheckpointTracker:
    """Reference checkpoints.go:29-245."""

    __slots__ = (
        "state",
        "highest_checkpoints",
        "checkpoint_map",
        "active_checkpoints",
        "msg_buffers",
        "network_config",
        "persisted",
        "node_buffers",
        "my_config",
        "logger",
        "catch_up_target",
    )

    def __init__(
        self,
        persisted: PersistedLog,
        node_buffers: NodeBuffers,
        my_config: EventInitialParameters,
        logger=None,
    ):
        self.state = CheckpointState.IDLE
        self.persisted = persisted
        self.node_buffers = node_buffers
        self.my_config = my_config
        self.logger = logger
        self.highest_checkpoints: Dict[int, int] = {}
        self.checkpoint_map: Dict[int, Checkpoint] = {}
        self.active_checkpoints: List[Checkpoint] = []
        self.msg_buffers: Dict[int, MsgBuffer] = {}
        self.network_config: Optional[NetworkConfig] = None
        # (seq_no, value) of a weak-quorum-attested checkpoint beyond our
        # windows — the mid-epoch catch-up trigger (docs/Divergences.md
        # #13).  Consumed by the machine's post-event hook.
        self.catch_up_target: Optional[Tuple[int, bytes]] = None

    # --- (re)initialization (reference checkpoints.go:56-112) ---

    def reinitialize(self) -> None:
        old_checkpoint_map = self.checkpoint_map
        old_msg_buffers = self.msg_buffers

        self.highest_checkpoints = {}
        self.checkpoint_map = {}
        self.active_checkpoints = []
        self.msg_buffers = {}
        self.network_config = None
        self.catch_up_target = None

        for _, entry in self.persisted.entries:
            if not isinstance(entry, CEntry):
                continue
            if self.network_config is None:
                # Fixed until next reinitialize.
                self.network_config = entry.network_state.config
            cp = self.checkpoint(entry.seq_no)
            cp.apply_checkpoint_msg(self.my_config.id, entry.checkpoint_value)
            self.active_checkpoints.append(cp)

        assert self.active_checkpoints, "log must contain a CEntry"
        self.active_checkpoints[0].stable = True

        valid_nodes = set(self.network_config.nodes)
        for node in self.network_config.nodes:
            buffer = old_msg_buffers.get(node)
            if buffer is None:
                buffer = MsgBuffer(
                    "checkpoints", self.node_buffers.node_buffer(node)
                )
            self.msg_buffers[node] = buffer

        # Re-apply remembered agreements (commutative, order-independent).
        for seq_no, cp in old_checkpoint_map.items():
            if seq_no < self.low_watermark():
                continue
            for value, agreements in cp.values.items():
                for node in agreements:
                    if node in valid_nodes:
                        self.apply_checkpoint_msg(node, seq_no, value)

        self.garbage_collect()

    # --- message handling (reference checkpoints.go:114-152) ---

    def filter(self, _source: int, msg: Msg) -> Applyable:
        assert isinstance(msg, CheckpointMsg)
        if msg.seq_no < self.active_checkpoints[0].seq_no:
            return Applyable.PAST
        if msg.seq_no > self.high_watermark():
            return Applyable.FUTURE
        return Applyable.CURRENT

    def step(self, source: int, msg: Msg) -> None:
        verdict = self.filter(source, msg)
        if verdict == Applyable.PAST:
            return
        if verdict == Applyable.FUTURE:
            self.msg_buffers[source].store(msg)
        # FUTURE messages are both buffered and applied (they feed
        # highest-checkpoint tracking); CURRENT just applied.
        self.apply_msg(source, msg)

    def apply_msg(self, source: int, msg: Msg) -> None:
        assert isinstance(msg, CheckpointMsg)
        self.apply_checkpoint_msg(source, msg.seq_no, msg.value)

    # --- GC (reference checkpoints.go:154-180) ---

    def garbage_collect(self) -> int:
        """Drop all windows below the highest stable checkpoint, extend to ≥3
        active windows, re-drain buffers; returns the new low watermark."""
        highest_stable_idx = 0
        for i, cp in enumerate(self.active_checkpoints):
            if not cp.stable:
                break
            highest_stable_idx = i

        for cp in self.active_checkpoints[:highest_stable_idx]:
            self.checkpoint_map.pop(cp.seq_no, None)
        self.active_checkpoints = self.active_checkpoints[highest_stable_idx:]

        while len(self.active_checkpoints) < 3:
            next_seq = self.high_watermark() + self.network_config.checkpoint_interval
            self.active_checkpoints.append(self.checkpoint(next_seq))

        for node in self.network_config.nodes:
            self.msg_buffers[node].iterate(self.filter, self.apply_msg)

        self.state = CheckpointState.IDLE
        return self.active_checkpoints[0].seq_no

    # --- accessors ---

    def checkpoint(self, seq_no: int) -> Checkpoint:
        cp = self.checkpoint_map.get(seq_no)
        if cp is None:
            cp = Checkpoint(
                seq_no, self.network_config, self.my_config.id, self.logger
            )
            self.checkpoint_map[seq_no] = cp
        return cp

    def high_watermark(self) -> int:
        return self.active_checkpoints[-1].seq_no

    def low_watermark(self) -> int:
        return self.active_checkpoints[0].seq_no

    # --- agreement application (reference checkpoints.go:199-241) ---

    def apply_checkpoint_msg(self, source: int, seq_no: int, value: bytes) -> None:
        above_high = seq_no > self.high_watermark()
        if above_high:
            highest = self.highest_checkpoints.get(source)
            if highest is None or seq_no > highest:
                self.highest_checkpoints[source] = seq_no
            # Deliberate divergence from the reference (part of
            # Divergences.md #13): the reference drops a source's LATER
            # above-window checkpoints outright (checkpoints.go:199-241,
            # replace-only-if-greater with an early return), which was
            # harmless when the tracking only fed far-future GC — but the
            # catch-up trigger needs f+1 agreement on a VALUE, and
            # staggered first-reports (e.g. under drop manglers) would
            # otherwise never converge on any single seq_no.  Agreements
            # keep accumulating; the per-checkpoint dedup handles repeats.

        cp = self.checkpoint(seq_no)
        cp.apply_checkpoint_msg(source, value)

        if above_high and cp.committed_value is not None:
            # A weak quorum attests a checkpoint beyond every window we
            # track: the network has provably moved past anything our
            # commit window can reach.  Arm the mid-epoch catch-up
            # transfer (docs/Divergences.md #13) — the reference has no
            # such path and strands a replica that falls this far behind
            # inside one epoch (its harness only exercises catch-up
            # against a quiescent cluster).
            cur = self.catch_up_target
            if cur is None or seq_no > cur[0]:
                self.catch_up_target = (seq_no, cp.committed_value)

        if cp.stable and seq_no > self.low_watermark() and not above_high:
            self.state = CheckpointState.GARBAGE_COLLECTABLE
            return

        if not above_high:
            return

        # GC any above-window checkpoints no node claims as current anymore.
        referenced = {cp.seq_no for cp in self.active_checkpoints}
        referenced.update(self.highest_checkpoints.values())
        for seq in list(self.checkpoint_map):
            if seq not in referenced:
                del self.checkpoint_map[seq]
