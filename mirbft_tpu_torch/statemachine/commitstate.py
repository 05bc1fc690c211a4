"""Commit ordering, checkpoint windows, and per-client committed bookkeeping.

Rebuild of reference ``pkg/statemachine/commitstate.go``: the two
checkpoint-interval halves of pending QEntries (:24-38), in-order ``drain``
emitting Commit actions plus a Checkpoint action at the interval boundary
(:228-269), checkpoint-result application with reconfiguration-aware
``stop_at_seq_no`` gating (:114-153), state-transfer initiation/resume
(:91-112), and the ``committingClient`` mask bookkeeping (:271-366).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..messages import (
    CEntry,
    CheckpointMsg,
    ClientState,
    NetworkConfig,
    NetworkState,
    QEntry,
    ReconfigNewClient,
    ReconfigNewConfig,
    ReconfigRemoveClient,
    ReconfigTransferClient,
    TEntry,
)
from ..state import EventCheckpointResult
from .actions import EMPTY_ACTIONS, Actions
from .persisted import PersistedLog
from .stateless import Bitmask


class CommittingClient:
    """Tracks which request numbers a client committed since the last
    checkpoint (reference commitstate.go:271-366)."""

    __slots__ = ("last_state", "committed_since_last_checkpoint")

    def __init__(self, seq_no: int, client_state: ClientState):
        committed: List[Optional[int]] = [None] * client_state.width
        mask = Bitmask(client_state.committed_mask)
        for i in range(mask.bits()):
            if mask.is_bit_set(i) and i < len(committed):
                committed[i] = seq_no
        self.last_state = client_state
        self.committed_since_last_checkpoint = committed

    def mark_committed(self, seq_no: int, req_no: int) -> None:
        if req_no < self.last_state.low_watermark:
            return
        offset = req_no - self.last_state.low_watermark
        committed = self.committed_since_last_checkpoint
        if offset >= len(committed):
            # Auto-grow up to the window bound.  The reference's fixed-width
            # slice panics here when a large batch commits a client's entire
            # remaining window within one checkpoint interval
            # (commitstate.go:292-298); the window invariant is the real
            # bound, not the slice length.
            if offset >= self.last_state.width:
                raise AssertionError(
                    f"commit for req_no {req_no} beyond client window "
                    f"[{self.last_state.low_watermark}, "
                    f"{self.last_state.low_watermark + self.last_state.width - 1}]"
                )
            committed.extend([None] * (offset + 1 - len(committed)))
        committed[offset] = seq_no

    def create_checkpoint_state(self) -> ClientState:
        """Roll the client window forward at a checkpoint boundary
        (reference commitstate.go:302-366)."""
        old = self.last_state
        committed = self.committed_since_last_checkpoint
        first_uncommitted: Optional[int] = None
        last_committed: Optional[int] = None
        # Scan the FULL window [lw, lw+width-1]: the tracking list may be
        # shorter than the window (it shrinks as checkpoints consume it, and
        # grows on demand); slots beyond it are uncommitted.  The reference
        # scans only its slice, wrongly concluding "all committed" when a
        # client stops submitting mid-window (commitstate.go:306-315).
        for i in range(old.width):
            seq = committed[i] if i < len(committed) else None
            req_no = old.low_watermark + i
            if seq is not None:
                last_committed = req_no
            elif first_uncommitted is None:
                first_uncommitted = req_no

        if last_committed is None:
            new_state = ClientState(
                id=old.id,
                width=old.width,
                width_consumed_last_checkpoint=0,
                low_watermark=old.low_watermark,
                committed_mask=b"",
            )
            self.last_state = new_state
            return new_state

        if first_uncommitted is None:
            # Whole window committed: the generic roll below handles it with
            # first_uncommitted one past the end.  (The reference special-
            # cases this with an assertion that mis-fires when the last
            # checkpoint's consumed slots commit within a later interval,
            # commitstate.go:306-315.)
            first_uncommitted = last_committed + 1

        width_consumed = first_uncommitted - old.low_watermark
        # Shift out the consumed prefix and cap at the window width — the
        # scan above only ever reads `width` slots, and the reference's
        # uncapped reshaping (old[c:] + width-c fresh slots) grows without
        # bound for a slow client (commitstate.go:334-336).
        self.committed_since_last_checkpoint = (
            self.committed_since_last_checkpoint[width_consumed:]
            + [None] * old.width
        )[: old.width]

        mask_bytes = b""
        if last_committed != first_uncommitted:
            mask = Bitmask(nbits=8 * ((last_committed - first_uncommitted) // 8 + 1))
            for i in range(last_committed - first_uncommitted + 1):
                if self.committed_since_last_checkpoint[i] is None:
                    continue
                if i == 0:
                    raise AssertionError(
                        "the first uncommitted request cannot be committed"
                    )
                mask.set_bit(i)
            mask_bytes = mask.to_bytes()

        new_state = ClientState(
            id=old.id,
            width=old.width,
            width_consumed_last_checkpoint=width_consumed,
            low_watermark=first_uncommitted,
            committed_mask=mask_bytes,
        )
        self.last_state = new_state
        return new_state


def next_network_config(
    starting_state: NetworkState,
    committing_clients: Dict[int, CommittingClient],
) -> Tuple[NetworkConfig, Tuple[ClientState, ...]]:
    """Compute the post-checkpoint network config, applying any pending
    reconfigurations (reference commitstate.go:188-225)."""
    next_config = starting_state.config
    next_clients: List[ClientState] = []
    for old_client in starting_state.clients:
        cc = committing_clients.get(old_client.id)
        if cc is None:
            raise AssertionError(
                f"no committing client instance for client {old_client.id}"
            )
        next_clients.append(cc.create_checkpoint_state())

    for reconfig in starting_state.pending_reconfigurations:
        if isinstance(reconfig, ReconfigNewClient):
            next_clients.append(
                ClientState(
                    id=reconfig.id,
                    width=reconfig.width,
                    width_consumed_last_checkpoint=0,
                    low_watermark=0,
                    committed_mask=b"",
                )
            )
        elif isinstance(reconfig, ReconfigRemoveClient):
            found = False
            for i, client in enumerate(next_clients):
                if client.id == reconfig.id:
                    del next_clients[i]
                    found = True
                    break
            if not found:
                raise AssertionError(
                    f"asked to remove client {reconfig.id} which doesn't exist"
                )
        elif isinstance(reconfig, ReconfigTransferClient):
            next_clients.append(
                ClientState(
                    id=reconfig.id,
                    width=reconfig.width,
                    width_consumed_last_checkpoint=0,
                    low_watermark=reconfig.low_watermark,
                    committed_mask=b"",
                )
            )
        elif isinstance(reconfig, ReconfigNewConfig):
            next_config = reconfig.config

    return next_config, tuple(next_clients)


class CommitState:
    """Reference commitstate.go:24-38.  Network state only changes at
    checkpoint boundaries; ``stop_at_seq_no`` pauses ordering past the next
    checkpoint while a reconfiguration is pending."""

    __slots__ = (
        "persisted",
        "committing_clients",
        "logger",
        "low_watermark",
        "last_applied_commit",
        "highest_commit",
        "stop_at_seq_no",
        "active_state",
        "lower_half_commits",
        "upper_half_commits",
        "checkpoint_pending",
        "transferring",
        "transfer_retry_in",
        "transfer_retry_backoff",
        "transfer_retry_target",
    )

    def __init__(self, persisted: PersistedLog, logger=None):
        self.persisted = persisted
        self.logger = logger
        self.committing_clients: Dict[int, CommittingClient] = {}
        self.low_watermark = 0
        self.last_applied_commit = 0
        self.highest_commit = 0
        self.stop_at_seq_no = 0
        self.active_state: Optional[NetworkState] = None
        self.lower_half_commits: List[Optional[QEntry]] = []
        self.upper_half_commits: List[Optional[QEntry]] = []
        self.checkpoint_pending = False
        self.transferring = False
        # Failed-transfer retry machinery (closes the reference's open edge,
        # state_machine.go:210-212 ``panic("XXX handle state transfer
        # failure")``; docs/Divergences.md #8): a failed attempt re-issues
        # the ActionStateTransfer after a deterministic tick backoff
        # (1, 2, 4, 8, 8, ... ticks), giving the app time to select an
        # alternate snapshot source between attempts.
        self.transfer_retry_in = 0
        self.transfer_retry_backoff = 0
        self.transfer_retry_target: Optional[TEntry] = None

    # --- (re)initialization from the log (reference commitstate.go:52-112) ---

    def reinitialize(self) -> Actions:
        last_c: Optional[CEntry] = None
        last_t: Optional[TEntry] = None
        for _, entry in self.persisted.entries:
            if isinstance(entry, CEntry):
                last_c = entry
            elif isinstance(entry, TEntry):
                last_t = entry

        assert last_c is not None, "log must contain a CEntry"

        # The machine's _complete_pending_reconfiguration guarantees that a
        # CEntry applying a reconfiguration is followed by an FEntry before
        # we get here, and log recovery then truncates its predecessors — so
        # the newest CEntry is always the state to restart from.
        self.active_state = last_c.network_state
        self.low_watermark = last_c.seq_no

        actions = Actions().state_applied(self.low_watermark, self.active_state)

        ci = self.active_state.config.checkpoint_interval
        if not self.active_state.pending_reconfigurations:
            self.stop_at_seq_no = last_c.seq_no + 2 * ci
        else:
            # Mid-reconfiguration: ordering halts at the next checkpoint,
            # which is where the pending reconfiguration will apply.
            self.stop_at_seq_no = self.low_watermark + ci

        self.last_applied_commit = last_c.seq_no
        self.highest_commit = last_c.seq_no
        self.lower_half_commits = [None] * ci
        self.upper_half_commits = [None] * ci
        self.checkpoint_pending = False

        self.committing_clients = {
            cs.id: CommittingClient(self.low_watermark, cs)
            for cs in self.active_state.clients
        }

        self.transfer_retry_in = 0
        self.transfer_retry_backoff = 0
        self.transfer_retry_target = None

        if last_t is None or last_c.seq_no >= last_t.seq_no:
            self.transferring = False
            return actions

        # We crashed mid-state-transfer: re-issue the transfer request.
        self.transferring = True
        return actions.state_transfer(last_t.seq_no, last_t.value)

    def transfer_to(self, seq_no: int, value: bytes) -> Actions:
        """Persist a TEntry and request app state transfer
        (reference commitstate.go:114-123)."""
        if self.transferring:
            raise AssertionError("concurrent state transfers are not supported")
        self.transferring = True
        if self.logger is not None:
            self.logger.info("initiating state transfer", seq_no=seq_no)
        return self.persisted.add_t_entry(
            TEntry(seq_no=seq_no, value=value)
        ).state_transfer(seq_no, value)

    # --- failed-transfer retry (no reference counterpart; the reference
    # panics here, state_machine.go:210-212) ---

    def apply_transfer_failed(self, seq_no: int, value: bytes) -> Actions:
        """Schedule a retry of a failed state transfer.

        The TEntry for the attempt is already persisted (transfer_to), so a
        crash between failure and retry recovers through the normal
        crashed-mid-transfer path.  Retry waits ``transfer_retry_backoff``
        ticks (doubling per consecutive failure, capped at 8) before
        re-emitting the ActionStateTransfer.
        """
        if not self.transferring:
            # Stale failure from before a reinitialization (e.g. a crash
            # recovered the transfer and it already completed) — ignore.
            return EMPTY_ACTIONS
        self.transfer_retry_backoff = (
            1 if self.transfer_retry_backoff == 0
            else min(self.transfer_retry_backoff * 2, 8)
        )
        self.transfer_retry_in = self.transfer_retry_backoff
        self.transfer_retry_target = TEntry(seq_no=seq_no, value=value)
        if self.logger is not None:
            self.logger.warn(
                "state transfer failed; retrying",
                seq_no=seq_no,
                backoff_ticks=self.transfer_retry_backoff,
            )
        return EMPTY_ACTIONS

    def tick(self) -> Actions:
        """Count down a pending transfer retry; re-issue when it expires."""
        if self.transfer_retry_target is None:
            return EMPTY_ACTIONS
        self.transfer_retry_in -= 1
        if self.transfer_retry_in > 0:
            return EMPTY_ACTIONS
        target = self.transfer_retry_target
        self.transfer_retry_target = None
        if self.logger is not None:
            self.logger.info(
                "re-issuing failed state transfer", seq_no=target.seq_no
            )
        return Actions().state_transfer(target.seq_no, target.value)

    # --- checkpoint results (reference commitstate.go:125-165) ---

    def apply_checkpoint_result(self, result: EventCheckpointResult) -> Actions:
        ci = self.active_state.config.checkpoint_interval

        if self.transferring:
            return Actions()

        if result.seq_no != self.low_watermark + ci:
            raise AssertionError(
                f"stale checkpoint result seq={result.seq_no}, expected "
                f"{self.low_watermark + ci}"
            )

        completing_reconfiguration = bool(
            self.active_state.pending_reconfigurations
        )
        if (
            not result.network_state.pending_reconfigurations
            and not completing_reconfiguration
        ):
            self.stop_at_seq_no = result.seq_no + 2 * ci
        # else: a reconfiguration is pending (don't order past the next
        # checkpoint) or this checkpoint just applied one (the epoch ends
        # here; the machine reinitializes under the new config).

        self.active_state = result.network_state
        self.lower_half_commits = self.upper_half_commits
        self.upper_half_commits = [None] * ci
        self.low_watermark = result.seq_no
        self.checkpoint_pending = False

        return (
            self.persisted.add_c_entry(
                CEntry(
                    seq_no=result.seq_no,
                    checkpoint_value=result.value,
                    network_state=result.network_state,
                )
            )
            .send(
                self.active_state.config.nodes,
                CheckpointMsg(seq_no=result.seq_no, value=result.value),
            )
            .state_applied(result.seq_no, result.network_state)
        )

    # --- commits (reference commitstate.go:167-186) ---

    def commit(self, q_entry: QEntry) -> None:
        if self.transferring:
            raise AssertionError("must never commit during state transfer")
        if q_entry.seq_no > self.stop_at_seq_no:
            raise AssertionError(
                f"commit seq {q_entry.seq_no} exceeds stop {self.stop_at_seq_no}"
            )
        if q_entry.seq_no <= self.low_watermark:
            # During epoch change we may re-commit already-committed seqnos.
            return

        if self.highest_commit < q_entry.seq_no:
            if self.highest_commit + 1 != q_entry.seq_no:
                raise AssertionError(
                    f"out-of-order commit: highest={self.highest_commit}, "
                    f"got {q_entry.seq_no}"
                )
            self.highest_commit = q_entry.seq_no

        ci = self.active_state.config.checkpoint_interval
        commits, offset = self._slot(q_entry.seq_no, ci)
        existing = commits[offset]
        if existing is not None:
            if existing.digest != q_entry.digest:
                raise AssertionError(
                    f"conflicting commit digests at seq {q_entry.seq_no}"
                )
        else:
            commits[offset] = q_entry

    def _slot(self, seq_no: int, ci: int):
        """(half-list, offset) holding the pending QEntry slot for seq_no —
        the single source of the two-half window arithmetic
        (reference commitstate.go:24-38)."""
        upper = seq_no - self.low_watermark > ci
        offset = (seq_no - (self.low_watermark + 1)) % ci
        return (
            self.upper_half_commits if upper else self.lower_half_commits,
            offset,
        )

    def drain(self) -> Actions:
        """Emit all in-order Commit actions plus the Checkpoint action at the
        interval boundary (reference commitstate.go:228-269)."""
        ci = self.active_state.config.checkpoint_interval

        # Fast path for the per-event fixpoint loop: nothing commits and no
        # checkpoint is due — the overwhelmingly common case.
        lac = self.last_applied_commit
        if lac < self.low_watermark + 2 * ci and not (
            lac == self.low_watermark + ci and not self.checkpoint_pending
        ):
            next_commit = lac + 1
            commits, offset = self._slot(next_commit, ci)
            if commits[offset] is None:
                return EMPTY_ACTIONS

        actions = Actions()
        while self.last_applied_commit < self.low_watermark + 2 * ci:
            if (
                self.last_applied_commit == self.low_watermark + ci
                and not self.checkpoint_pending
            ):
                network_config, client_configs = next_network_config(
                    self.active_state, self.committing_clients
                )
                actions.checkpoint(
                    self.last_applied_commit, network_config, client_configs
                )
                self.checkpoint_pending = True

            next_commit = self.last_applied_commit + 1
            commits, offset = self._slot(next_commit, ci)
            commit = commits[offset]
            if commit is None:
                break
            if commit.seq_no != next_commit:
                raise AssertionError(
                    f"attempted out-of-order commit: {commit.seq_no} != "
                    f"{next_commit}"
                )
            actions.commit(commit)
            for req in commit.requests:
                self.committing_clients[req.client_id].mark_committed(
                    commit.seq_no, req.req_no
                )
            self.last_applied_commit = next_commit

        return actions
