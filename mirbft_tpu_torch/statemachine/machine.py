"""Root deterministic state machine: event dispatch and the fixpoint loop.

Rebuild of reference ``pkg/statemachine/state_machine.go``: the 3-phase
lifecycle (UNINITIALIZED → LOADING_PERSISTED → INITIALIZED, :90-94), event
dispatch (:173-231), message routing by type (:310-349), hash-result demux by
origin (:351-371) — the return path of every TPU hash dispatch — checkpoint
results (:373-401), and the post-event loop: garbage-collect watermarks, then
iterate ``commit_state.drain()`` + ``epoch_tracker.advance_state()`` to
fixpoint (:239-267).

The machine is single-threaded and deterministic by construction: same event
sequence in, same action sequence out, on every replica and on every replay.
"""

from __future__ import annotations

import enum
from typing import Optional

from .. import state as st
from ..messages import (
    AckBatch,
    AckMsg,
    MsgBatch,
    CEntry,
    CheckpointMsg,
    Commit,
    EpochChange,
    EpochChangeAck,
    FEntry,
    FetchBatch,
    FetchRequest,
    ForwardBatch,
    ForwardRequest,
    Msg,
    NEntry,
    NewEpoch,
    NewEpochEcho,
    NewEpochReady,
    Preprepare,
    Prepare,
    Suspect,
)
from .actions import Actions
from .batch_tracker import BatchTracker
from .checkpoints import CheckpointState, CheckpointTracker
from .client_tracker import ClientTracker
from .commitstate import CommitState
from .disseminator import ClientHashDisseminator
from .epoch_target import EpochTargetState
from .epoch_tracker import EpochTracker
from .msgbuffers import NodeBuffers
from .persisted import PersistedLog
from .voteplane import split_votes

_ET_IN_PROGRESS = EpochTargetState.IN_PROGRESS


class MachineState(enum.IntEnum):
    UNINITIALIZED = 0
    LOADING_PERSISTED = 1
    INITIALIZED = 2


class StateMachine:
    """Reference state_machine.go:96-170."""

    __slots__ = (
        "logger",
        "state",
        "my_config",
        "commit_state",
        "client_tracker",
        "client_hash_disseminator",
        "node_buffers",
        "batch_tracker",
        "checkpoint_tracker",
        "epoch_tracker",
        "persisted",
    )

    def __init__(self, logger=None):
        self.logger = logger
        self.state = MachineState.UNINITIALIZED
        self.my_config: Optional[st.EventInitialParameters] = None
        self.commit_state: Optional[CommitState] = None
        self.client_tracker: Optional[ClientTracker] = None
        self.client_hash_disseminator: Optional[ClientHashDisseminator] = None
        self.node_buffers: Optional[NodeBuffers] = None
        self.batch_tracker: Optional[BatchTracker] = None
        self.checkpoint_tracker: Optional[CheckpointTracker] = None
        self.epoch_tracker: Optional[EpochTracker] = None
        self.persisted: Optional[PersistedLog] = None

    # --- lifecycle ---

    def _initialize(self, parameters: st.EventInitialParameters) -> None:
        if self.state != MachineState.UNINITIALIZED:
            raise AssertionError("state machine has already been initialized")
        self.my_config = parameters
        self.state = MachineState.LOADING_PERSISTED
        self.persisted = PersistedLog(self.logger)
        self.node_buffers = NodeBuffers(parameters, self.logger)
        self.checkpoint_tracker = CheckpointTracker(
            self.persisted, self.node_buffers, parameters, self.logger
        )
        self.client_tracker = ClientTracker(parameters, self.logger)
        self.commit_state = CommitState(self.persisted, self.logger)
        self.client_hash_disseminator = ClientHashDisseminator(
            self.node_buffers, parameters, self.client_tracker, self.logger
        )
        self.batch_tracker = BatchTracker(self.persisted)
        self.epoch_tracker = EpochTracker(
            self.persisted,
            self.node_buffers,
            self.commit_state,
            parameters,
            self.batch_tracker,
            self.client_tracker,
            self.client_hash_disseminator,
            self.logger,
        )

    def _apply_persisted(self, index: int, entry) -> None:
        if self.state != MachineState.LOADING_PERSISTED:
            raise AssertionError("not in the loading-persisted phase")
        self.persisted.append_initial_load(index, entry)

    def _complete_initialization(self) -> Actions:
        if self.state != MachineState.LOADING_PERSISTED:
            raise AssertionError("not in the loading-persisted phase")
        self.state = MachineState.INITIALIZED
        return self._reinitialize()

    def _reinitialize(self) -> Actions:
        """Shared by start, state transfer, and reconfiguration
        (reference state_machine.go:272-287)."""
        actions = self._complete_pending_reconfiguration()
        actions.concat(self._recover_log())
        actions.concat(self.commit_state.reinitialize())
        self.client_tracker.reinitialize(self.commit_state.active_state)
        actions.concat(
            self.client_hash_disseminator.reinitialize(
                self.commit_state.low_watermark, self.commit_state.active_state
            )
        )
        self.checkpoint_tracker.reinitialize()
        self.batch_tracker.reinitialize()
        return actions.concat(self.epoch_tracker.reinitialize())

    def _complete_pending_reconfiguration(self) -> Actions:
        """Close the epoch at a reconfiguration boundary.

        When the checkpoint that APPLIES a pending reconfiguration has been
        persisted (its predecessor CEntry still carries the pending list) but
        no FEntry follows it yet, append the FEntry ending the current epoch
        config.  The subsequent log recovery truncates through the new CEntry
        and every tracker reinitializes under the post-reconfiguration
        network state; the next epoch then starts via the graceful
        epoch-change path.

        The reference never implemented this step (its reconfiguration
        "does not entirely work", reference README.md:35, and the in-epoch
        variant dead-ends at epoch_target.go:333's panic); this follows the
        flow reference docs/LogMovement.md describes.  Running it inside
        ``_reinitialize`` makes the normal path and the
        crashed-between-CEntry-and-FEntry recovery path identical.
        """
        prev_c = last_c = None
        last_epoch_config = None
        f_after_last_c = False
        for _, entry in self.persisted.entries:
            if isinstance(entry, CEntry):
                prev_c, last_c = last_c, entry
                f_after_last_c = False
            elif isinstance(entry, FEntry):
                f_after_last_c = True
                last_epoch_config = entry.ends_epoch_config
            elif isinstance(entry, NEntry):
                last_epoch_config = entry.epoch_config
        if (
            last_c is None
            or prev_c is None
            or f_after_last_c
            or not prev_c.network_state.pending_reconfigurations
        ):
            return Actions()
        if last_epoch_config is None:
            raise AssertionError(
                "reconfiguration completed with no epoch config in the log"
            )
        return self.persisted.add_f_entry(
            FEntry(ends_epoch_config=last_epoch_config)
        )

    def _recover_log(self) -> Actions:
        """Truncate the WAL through the last CEntry preceding each FEntry
        (reference state_machine.go:290-308)."""
        actions = Actions()
        last_c: Optional[CEntry] = None
        for _, entry in list(self.persisted.entries):
            if isinstance(entry, CEntry):
                last_c = entry
            elif isinstance(entry, FEntry):
                if last_c is None:
                    raise AssertionError(
                        "FEntry without corresponding CEntry; corrupt log"
                    )
                actions.concat(self.persisted.truncate(last_c.seq_no))
        if last_c is None:
            raise AssertionError("found no checkpoints in the log")
        return actions

    # --- event dispatch (reference state_machine.go:168-270) ---

    def apply_event(self, event: st.Event) -> Actions:
        cls = event.__class__

        if cls is st.EventInitialParameters:
            self._initialize(event)
            return Actions()
        if cls is st.EventLoadPersistedEntry:
            self._apply_persisted(event.index, event.entry)
            return Actions()

        actions = Actions()
        if cls is st.EventLoadCompleted:
            actions = self._complete_initialization()
        elif cls is st.EventActionsReceived:
            # Marker correlating action batches to their events in the
            # recorded stream — and the batch boundary at which deferred
            # ack broadcasts flush (one AckBatch per client per batch).
            if self.state == MachineState.INITIALIZED:
                return self.client_hash_disseminator.flush_acks()
            return actions
        else:
            if self.state != MachineState.INITIALIZED:
                raise AssertionError(
                    "cannot apply events to an uninitialized state machine"
                )
            # Ordered by hot-path frequency: Step dominates, then the
            # hash/persist round-trips, then ticks.
            if cls is st.EventStep:
                actions.concat(self.step(event.source, event.msg))
            elif cls is st.EventRequestPersisted:
                actions.concat(
                    self.client_hash_disseminator.apply_new_request(
                        event.request_ack
                    )
                )
            elif cls is st.EventHashResult:
                actions.concat(self._process_hash_result(event))
            elif cls is st.EventCheckpointResult:
                actions.concat(self._process_checkpoint_result(event))
            elif cls is st.EventTickElapsed:
                actions.concat(self.client_hash_disseminator.tick())
                actions.concat(self.epoch_tracker.tick())
                actions.concat(self.commit_state.tick())
            elif cls is st.EventStateTransferFailed:
                # The reference leaves this edge unresolved
                # (state_machine.go:210-212 ``panic("XXX handle state
                # transfer failure")``); we complete it: the transfer is
                # re-issued after a deterministic tick backoff so the app
                # can retry (against an alternate snapshot source if it has
                # one).  docs/Divergences.md #8.
                actions.concat(
                    self.commit_state.apply_transfer_failed(
                        event.seq_no, event.checkpoint_value
                    )
                )
            elif cls is st.EventStateTransferComplete:
                if not self.commit_state.transferring:
                    raise AssertionError(
                        "state transfer completed but none was requested"
                    )
                actions.concat(
                    self.persisted.add_c_entry(
                        CEntry(
                            seq_no=event.seq_no,
                            checkpoint_value=event.checkpoint_value,
                            network_state=event.network_state,
                        )
                    )
                )
                actions.concat(self._reinitialize())
            else:
                raise AssertionError(f"unknown event type {type(event).__name__}")

        # At most one watermark movement is possible per event (a second
        # would need a fresh checkpoint result from ourselves).
        if self.checkpoint_tracker.state == CheckpointState.GARBAGE_COLLECTABLE:
            new_low = self.checkpoint_tracker.garbage_collect()
            # Deviation from the reference, which drops the Truncate action
            # returned here (state_machine.go:243), leaving the durable WAL
            # to grow until recovery: we emit it so the WAL stays bounded.
            actions.concat(self.persisted.truncate(new_low))
            ci = self.checkpoint_tracker.network_config.checkpoint_interval
            if new_low > ci:
                # Keep one extra checkpoint interval of batches for epoch change.
                self.batch_tracker.truncate(new_low - ci)
            actions.concat(self.epoch_tracker.move_low_watermark(new_low))

        # Mid-epoch catch-up (docs/Divergences.md #13): when a weak quorum
        # attests a checkpoint beyond our tracker windows, transfer to it.
        # The reference strands a replica the cluster outruns within one
        # epoch (state transfer only arms via epoch changes); this
        # completes that path the same way Divergences #8 completed
        # transfer failure.
        target = self.checkpoint_tracker.catch_up_target
        if target is not None:
            seq_no, value = target
            if seq_no <= self.commit_state.highest_commit:
                self.checkpoint_tracker.catch_up_target = None  # stale
            elif not self.commit_state.transferring:
                self.checkpoint_tracker.catch_up_target = None
                actions.concat(self.commit_state.transfer_to(seq_no, value))
            # else: a transfer is in flight — keep the target armed
            # (checkpoint messages are sent once; dropping it here could
            # strand the replica if the cluster quiesces before anything
            # else re-arms it).

        # Fixpoint: drain commits and advance the epoch until quiescent.
        while True:
            actions.concat(self.commit_state.drain())
            loop_actions = self.epoch_tracker.advance_state()
            if not loop_actions:
                break
            actions.concat(loop_actions)

        return actions

    # --- message routing (reference state_machine.go:310-349) ---

    def step(self, source: int, msg: Msg) -> Actions:
        t = msg.__class__
        if t is Prepare or t is Commit:
            # Hot path: three-phase-commit traffic for the current in-progress
            # epoch goes straight to the active epoch, skipping the
            # tracker/target routing hops (same classification outcome).
            target = self.epoch_tracker.current_epoch
            if (
                msg.epoch == target.number
                and target.state is _ET_IN_PROGRESS
            ):
                return target.active_epoch.step(source, msg)
            return self.epoch_tracker.step(source, msg)
        if t is AckBatch or t is AckMsg or t is FetchRequest or t is ForwardRequest:
            return self.client_hash_disseminator.step(source, msg)
        if t is MsgBatch:
            # Transport envelope: one event for the whole envelope (the
            # post-event fixpoint in apply_event runs once), and — when the
            # native vote plane is live — the envelope's Prepare/Commit
            # votes are applied with a single native call on a packed
            # representation shared by every receiver (voteplane.py).
            target = self.epoch_tracker.current_epoch
            if target.state is _ET_IN_PROGRESS:
                plane = target.active_epoch.seq_plane
                if plane is not None:
                    packed, vote_msgs, rest = split_votes(msg)
                    if vote_msgs:
                        actions = target.active_epoch.apply_envelope_votes(
                            packed, vote_msgs, source, self.step
                        )
                        for inner in rest:
                            actions.concat(self.step(source, inner))
                        return actions
            actions = Actions()
            for inner in msg.msgs:
                actions.concat(self.step(source, inner))
            return actions
        if t is CheckpointMsg:
            self.checkpoint_tracker.step(source, msg)
            return Actions()
        if t is FetchBatch or t is ForwardBatch:
            return self.batch_tracker.step(source, msg)
        if isinstance(
            msg,
            (
                Suspect,
                EpochChange,
                EpochChangeAck,
                NewEpoch,
                NewEpochEcho,
                NewEpochReady,
                Preprepare,
            ),
        ):
            return self.epoch_tracker.step(source, msg)
        raise AssertionError(f"unexpected message type {type(msg).__name__}")

    # --- hash results: the TPU return path (reference :351-371) ---

    def _process_hash_result(self, event: st.EventHashResult) -> Actions:
        origin = event.origin
        if isinstance(origin, st.BatchOrigin):
            self.batch_tracker.add_batch(
                origin.seq_no, event.digest, origin.request_acks
            )
            return self.epoch_tracker.apply_batch_hash_result(
                origin.epoch, origin.seq_no, event.digest
            )
        if isinstance(origin, st.EpochChangeOrigin):
            return self.epoch_tracker.apply_epoch_change_digest(
                origin, event.digest
            )
        if isinstance(origin, st.VerifyBatchOrigin):
            actions = Actions()
            self.batch_tracker.apply_verify_batch_hash_result(event.digest, origin)
            if (
                not self.batch_tracker.has_fetch_in_flight()
                and self.epoch_tracker.current_epoch.state
                == EpochTargetState.FETCHING
            ):
                actions.concat(
                    self.epoch_tracker.current_epoch.fetch_new_epoch_state()
                )
            return actions
        raise AssertionError("no hash origin type set")

    # --- checkpoint results (reference :373-401) ---

    def _process_checkpoint_result(self, result: st.EventCheckpointResult) -> Actions:
        actions = Actions()
        if result.seq_no < self.commit_state.low_watermark:
            return actions  # stale result after state transfer

        expected = (
            self.commit_state.low_watermark
            + self.commit_state.active_state.config.checkpoint_interval
        )
        if expected != result.seq_no:
            raise AssertionError(
                "checkpoint results must be exactly one interval after the last"
            )

        completing_reconfiguration = bool(
            self.commit_state.active_state.pending_reconfigurations
        )
        prev_stop = self.commit_state.stop_at_seq_no
        actions.concat(self.commit_state.apply_checkpoint_result(result))
        if completing_reconfiguration and not self.commit_state.transferring:
            # This checkpoint applied a reconfiguration: the epoch ends here.
            # _reinitialize appends the FEntry, truncates the log through the
            # new CEntry, and restarts every tracker under the new network
            # state (see _complete_pending_reconfiguration).
            return actions.concat(self._reinitialize())
        if prev_stop < self.commit_state.stop_at_seq_no:
            self.client_tracker.allocate(result.seq_no, result.network_state)
            actions.concat(
                self.client_hash_disseminator.allocate(
                    result.seq_no, result.network_state
                )
            )
        return actions
