"""Epoch tracker: owns the current epoch target and routes epoch traffic.

Rebuild of reference ``pkg/statemachine/epoch_tracker.go``: routes the 10
epoch-scoped message types by epoch number (past-drop / future-buffer /
current-apply, :313-332), recovery logic deciding resume vs epoch-change from
the last N/F/EC entries (:60-218), f+1 max-epoch jump on ticks (:376-406),
and rolling to the next epoch target when the current one is done (:220-273).
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import state as st
from ..messages import (
    CEntry,
    Commit,
    ECEntry,
    EpochChange,
    EpochChangeAck,
    FEntry,
    Msg,
    NEntry,
    NewEpoch,
    NewEpochEcho,
    NewEpochReady,
    Preprepare,
    Prepare,
    QEntry,
    Suspect,
)
from ..state import EventInitialParameters
from .actions import EMPTY_ACTIONS, Actions
from .batch_tracker import BatchTracker
from .client_tracker import ClientTracker
from .commitstate import CommitState
from .disseminator import ClientHashDisseminator
from .epoch_change import ParsedEpochChange
from .epoch_target import EpochTarget, EpochTargetState
from .msgbuffers import Applyable, MsgBuffer, NodeBuffers
from .persisted import PersistedLog
from .stateless import some_correct_quorum

TICKS_OUT_OF_CORRECT_EPOCH_LIMIT = 10


def epoch_for_msg(msg: Msg) -> int:
    """Reference epoch_tracker.go:277-300."""
    if isinstance(msg, (Preprepare, Prepare, Commit, Suspect)):
        return msg.epoch
    if isinstance(msg, EpochChange):
        return msg.new_epoch
    if isinstance(msg, EpochChangeAck):
        return msg.epoch_change.new_epoch
    if isinstance(msg, NewEpoch):
        return msg.new_config.config.number
    if isinstance(msg, (NewEpochEcho, NewEpochReady)):
        return msg.config.config.number
    raise AssertionError(f"unexpected epoch message type {type(msg).__name__}")


class EpochTracker:
    """Reference epoch_tracker.go:17-41."""

    __slots__ = (
        "current_epoch",
        "persisted",
        "node_buffers",
        "commit_state",
        "network_config",
        "logger",
        "my_config",
        "batch_tracker",
        "client_tracker",
        "client_hash_disseminator",
        "future_msgs",
        "needs_state_transfer",
        "max_epochs",
        "max_correct_epoch",
        "ticks_out_of_correct_epoch",
    )

    def __init__(
        self,
        persisted: PersistedLog,
        node_buffers: NodeBuffers,
        commit_state: CommitState,
        my_config: EventInitialParameters,
        batch_tracker: BatchTracker,
        client_tracker: ClientTracker,
        client_hash_disseminator: ClientHashDisseminator,
        logger=None,
    ):
        self.current_epoch: Optional[EpochTarget] = None
        self.persisted = persisted
        self.node_buffers = node_buffers
        self.commit_state = commit_state
        self.network_config = None
        self.my_config = my_config
        self.batch_tracker = batch_tracker
        self.client_tracker = client_tracker
        self.client_hash_disseminator = client_hash_disseminator
        self.logger = logger
        self.future_msgs: Dict[int, MsgBuffer] = {}
        self.needs_state_transfer = False
        self.max_epochs: Dict[int, int] = {}
        self.max_correct_epoch = 0
        self.ticks_out_of_correct_epoch = 0

    def _new_target(self, number: int) -> EpochTarget:
        return EpochTarget(
            number,
            self.persisted,
            self.node_buffers,
            self.commit_state,
            self.client_tracker,
            self.client_hash_disseminator,
            self.batch_tracker,
            self.network_config,
            self.my_config,
            self.logger,
        )

    # --- recovery (reference epoch_tracker.go:60-218) ---

    def reinitialize(self) -> Actions:
        self.network_config = self.commit_state.active_state.config

        new_future_msgs = {}
        for node in self.network_config.nodes:
            buf = self.future_msgs.get(node)
            if buf is None:
                buf = MsgBuffer("future-epochs", self.node_buffers.node_buffer(node))
            new_future_msgs[node] = buf
        self.future_msgs = new_future_msgs

        actions = Actions()
        last_n: Optional[NEntry] = None
        last_ec: Optional[ECEntry] = None
        last_f: Optional[FEntry] = None
        highest_preprepared = 0
        for _, entry in self.persisted.entries:
            if isinstance(entry, NEntry):
                last_n = entry
            elif isinstance(entry, FEntry):
                last_f = entry
            elif isinstance(entry, ECEntry):
                last_ec = entry
            elif isinstance(entry, QEntry):
                highest_preprepared = max(highest_preprepared, entry.seq_no)
            elif isinstance(entry, CEntry):
                # After state transfer we may have a CEntry with no QEntry.
                highest_preprepared = max(highest_preprepared, entry.seq_no)

        if last_n is None and last_f is None:
            raise AssertionError("no active epoch and no last epoch in log")
        if last_n is not None and last_f is not None:
            if last_n.epoch_config.number <= last_f.ends_epoch_config.number:
                raise AssertionError(
                    "new epoch number must exceed last terminated epoch"
                )

        if last_n is not None and (
            last_ec is None or last_ec.epoch_number <= last_n.epoch_config.number
        ):
            # Reinitializing mid-epoch: resume it (and suspect it, since we
            # may have missed traffic while down).
            self.current_epoch = self._new_target(last_n.epoch_config.number)
            starting_seq_no = highest_preprepared + 1
            ci = self.network_config.checkpoint_interval
            while starting_seq_no % ci != 1:
                # Advance to the first sequence after some checkpoint, so we
                # never re-consent on sequences we already consented on.
                starting_seq_no += 1
                self.needs_state_transfer = True
            self.current_epoch.starting_seq_no = starting_seq_no
            self.current_epoch.state = EpochTargetState.RESUMING
            self.current_epoch.resume_epoch_config = last_n.epoch_config
            suspect = Suspect(epoch=last_n.epoch_config.number)
            actions.concat(self.persisted.add_suspect(suspect))
            actions.send(self.network_config.nodes, suspect)
        else:
            if last_f is not None and (
                last_ec is None
                or last_ec.epoch_number <= last_f.ends_epoch_config.number
            ):
                # Graceful epoch end, epoch change not yet sent: create it.
                last_ec = ECEntry(
                    epoch_number=last_f.ends_epoch_config.number + 1
                )
                actions.concat(self.persisted.add_ec_entry(last_ec))

            assert last_ec is not None
            if (
                self.current_epoch is not None
                and self.current_epoch.number == last_ec.epoch_number
            ):
                # Reinitialized during an epoch change; keep going.
                return actions.concat(self.current_epoch.advance_state())

            epoch_change = self.persisted.construct_epoch_change(
                last_ec.epoch_number
            )
            parsed = ParsedEpochChange(epoch_change)
            self.current_epoch = self._new_target(epoch_change.new_epoch)
            self.current_epoch.my_epoch_change = parsed
            # Leader selection is a placeholder in the reference too
            # (epoch_tracker.go:202-205): all nodes lead.
            self.current_epoch.my_leader_choice = self.network_config.nodes

        for node in self.network_config.nodes:
            self.future_msgs[node].iterate(
                self.filter,
                lambda source, msg: actions.concat(self.apply_msg(source, msg)),
            )
        return actions

    # --- epoch rollover (reference epoch_tracker.go:220-273) ---

    def advance_state(self) -> Actions:
        if self.current_epoch.state < EpochTargetState.DONE:
            return self.current_epoch.advance_state()

        if self.commit_state.checkpoint_pending:
            # Wait for pending checkpoints before initiating epoch change.
            return EMPTY_ACTIONS

        new_epoch_number = self.current_epoch.number + 1
        if self.max_correct_epoch > new_epoch_number:
            new_epoch_number = self.max_correct_epoch
        epoch_change = self.persisted.construct_epoch_change(new_epoch_number)
        my_epoch_change = ParsedEpochChange(epoch_change)

        self.current_epoch = self._new_target(new_epoch_number)
        self.current_epoch.my_epoch_change = my_epoch_change
        self.current_epoch.my_leader_choice = (self.my_config.id,)
        if self.logger is not None:
            self.logger.info(
                "initiating epoch change", new_epoch=new_epoch_number
            )

        actions = self.persisted.add_ec_entry(
            ECEntry(epoch_number=new_epoch_number)
        ).send(self.network_config.nodes, epoch_change)

        for node in self.network_config.nodes:
            self.future_msgs[node].iterate(
                self.filter,
                lambda source, msg: actions.concat(self.apply_msg(source, msg)),
            )
        return actions

    # --- routing (reference epoch_tracker.go:302-372) ---

    def filter(self, _source: int, msg: Msg) -> Applyable:
        epoch_number = epoch_for_msg(msg)
        if epoch_number < self.current_epoch.number:
            return Applyable.PAST
        if epoch_number > self.current_epoch.number:
            return Applyable.FUTURE
        return Applyable.CURRENT

    def step(self, source: int, msg: Msg) -> Actions:
        epoch_number = epoch_for_msg(msg)
        if epoch_number < self.current_epoch.number:
            return EMPTY_ACTIONS
        if epoch_number > self.current_epoch.number:
            if self.max_epochs.get(source, 0) < epoch_number:
                self.max_epochs[source] = epoch_number
            self.future_msgs[source].store(msg)
            return EMPTY_ACTIONS
        return self.apply_msg(source, msg)

    def apply_msg(self, source: int, msg: Msg) -> Actions:
        target = self.current_epoch
        if isinstance(msg, (Preprepare, Prepare, Commit)):
            return target.step(source, msg)
        if isinstance(msg, Suspect):
            target.apply_suspect_msg(source)
            return Actions()
        if isinstance(msg, EpochChange):
            return target.apply_epoch_change_msg(source, msg)
        if isinstance(msg, EpochChangeAck):
            return target.apply_epoch_change_ack_msg(
                source, msg.originator, msg.epoch_change
            )
        if isinstance(msg, NewEpoch):
            if msg.new_config.config.number % len(self.network_config.nodes) != source:
                return Actions()  # not from the epoch primary
            return target.apply_new_epoch_msg(msg)
        if isinstance(msg, NewEpochEcho):
            return target.apply_new_epoch_echo_msg(source, msg.config)
        if isinstance(msg, NewEpochReady):
            return target.apply_new_epoch_ready_msg(source, msg.config)
        raise AssertionError(f"unexpected epoch message type {type(msg).__name__}")

    def apply_batch_hash_result(
        self, epoch: int, seq_no: int, digest: bytes
    ) -> Actions:
        if (
            epoch != self.current_epoch.number
            or self.current_epoch.state != EpochTargetState.IN_PROGRESS
        ):
            return Actions()
        return self.current_epoch.active_epoch.apply_batch_hash_result(
            seq_no, digest
        )

    def apply_epoch_change_digest(
        self, origin: st.EpochChangeOrigin, digest: bytes
    ) -> Actions:
        target_number = origin.epoch_change.new_epoch
        if target_number < self.current_epoch.number:
            return Actions()  # old epoch we no longer care about
        if target_number > self.current_epoch.number:
            raise AssertionError(
                f"epoch change digest for future epoch {target_number} while "
                f"processing {self.current_epoch.number}"
            )
        return self.current_epoch.apply_epoch_change_digest(origin, digest)

    # --- ticks (reference epoch_tracker.go:376-406) ---

    def tick(self) -> Actions:
        for max_epoch in self.max_epochs.values():
            if max_epoch <= self.max_correct_epoch:
                continue
            # Count nodes reporting an epoch ≥ max_epoch.  (Deviation from
            # the reference, which seeds the count at 1 — effectively
            # counting ourselves as a supporter of an epoch we never saw,
            # letting a single byzantine report reach f+1 when f=1.)
            matches = sum(
                1 for reported in self.max_epochs.values() if reported >= max_epoch
            )
            if matches < some_correct_quorum(self.network_config):
                continue
            self.max_correct_epoch = max_epoch

        if self.max_correct_epoch > self.current_epoch.number:
            self.ticks_out_of_correct_epoch += 1
            if self.ticks_out_of_correct_epoch > TICKS_OUT_OF_CORRECT_EPOCH_LIMIT:
                self.current_epoch.state = EpochTargetState.DONE

        return self.current_epoch.tick()

    def move_low_watermark(self, seq_no: int) -> Actions:
        return self.current_epoch.move_low_watermark(seq_no)
