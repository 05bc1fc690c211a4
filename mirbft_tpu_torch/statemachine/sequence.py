"""Per-sequence-number three-phase-commit state machine.

Rebuild of reference ``pkg/statemachine/sequence.go``: the lifecycle
``UNINITIALIZED → ALLOCATED → PENDING_REQUESTS → READY → PREPREPARED →
PREPARED → COMMITTED`` (sequence.go:18-26), batch-digest hashing on
allocation (:142-177) — the hash request is the unit of work the TPU batcher
aggregates — QEntry-persist-then-send on preprepare (:203-255), and the
intersection-quorum prepare/commit rules (:276-355).

Vote accumulation (the O(N²) Prepare/Commit hot path) runs in the native
sequence-vote plane when available (``voteplane.py`` / ackplane.cpp); the
dict-based path below is the pure-Python semantic reference.  Both paths
share the lifecycle/transition code: quorum checks read counts through
``_counts()``, which consults whichever store is live.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Set

from .. import state as st
from ..messages import (
    Commit,
    NetworkConfig,
    PEntry,
    Preprepare,
    Prepare,
    QEntry,
    RequestAck,
)
from .actions import EMPTY_ACTIONS, Actions
from .persisted import PersistedLog
from .stateless import intersection_quorum


class SeqState(enum.IntEnum):
    UNINITIALIZED = 0
    ALLOCATED = 1
    PENDING_REQUESTS = 2
    READY = 3
    PREPREPARED = 4
    PREPARED = 5
    COMMITTED = 6


class Sequence:
    """One in-flight sequence number within an active epoch."""

    __slots__ = (
        "owner",
        "seq_no",
        "epoch",
        "my_id",
        "network_config",
        "persisted",
        "_state",
        "plane",
        "q_entry",
        "client_requests",
        "batch",
        "outstanding_reqs",
        "digest",
        "prep_mask",
        "commit_mask",
        "my_prepare_digest",
        "prepares",
        "commits",
        "_iq",
    )

    def __init__(
        self,
        owner: int,
        epoch: int,
        seq_no: int,
        persisted: PersistedLog,
        network_config: NetworkConfig,
        my_id: int,
        plane=None,
    ):
        self.owner = owner
        self.seq_no = seq_no
        self.epoch = epoch
        self.my_id = my_id
        self.network_config = network_config
        self.persisted = persisted
        # Bypass the property: the plane window may not cover this seq yet
        # (slots default to UNINITIALIZED natively too).
        self._state = SeqState.UNINITIALIZED
        self.plane = plane
        self.q_entry: Optional[QEntry] = None
        self.client_requests: List = []  # ClientRequest-like (has .ack, .agreements)
        self.batch: List[RequestAck] = []
        self.outstanding_reqs: Optional[Set[RequestAck]] = None
        self.digest: Optional[bytes] = None
        # The digest carried by our own prepare — the only per-node digest
        # the quorum checks ever read back.
        self.my_prepare_digest: Optional[bytes] = None
        self._iq = intersection_quorum(network_config)
        if plane is None:
            # Pure-Python vote store: per-node bitmasks (a node's "seq choice
            # state" in the reference is derivable: prepare recorded ⇔ bit in
            # prep_mask|commit_mask; commit recorded ⇔ bit in commit_mask)
            # plus per-digest counts.
            self.prep_mask = 0
            self.commit_mask = 0
            self.prepares: Dict[bytes, int] = {}
            self.commits: Dict[bytes, int] = {}

    # --- state, mirrored into the native plane ---

    @property
    def state(self) -> SeqState:
        return self._state

    @state.setter
    def state(self, value: SeqState) -> None:
        self._state = value
        if self.plane is not None:
            self.plane.set_phase(self.seq_no, int(value))

    # --- driver ---

    def advance_state(self) -> Actions:
        """Iterate phase transitions to fixpoint (reference sequence.go:101-125)."""
        actions = Actions()
        while True:
            old_state = self._state
            if self._state == SeqState.PENDING_REQUESTS:
                self._check_requests()
            elif self._state == SeqState.READY:
                if self.digest is not None or not self.batch:
                    actions.concat(self._prepare())
            elif self._state == SeqState.PREPREPARED:
                actions.concat(self._check_prepare_quorum())
            elif self._state == SeqState.PREPARED:
                self._check_commit_quorum()
            if self._state == old_state:
                return actions

    # --- allocation ---

    def allocate_as_owner(self, client_requests: List) -> Actions:
        """Owner-side allocation from proposer-selected client requests
        (reference sequence.go:127-137)."""
        self.client_requests = client_requests
        return self.allocate([cr.ack for cr in client_requests], None)

    def allocate(
        self,
        request_acks: List[RequestAck],
        outstanding_reqs: Optional[Set[RequestAck]],
    ) -> Actions:
        """Reserve this sequence for a batch; emits the batch-digest hash
        request (the TPU hot-path action) unless the batch is empty
        (reference sequence.go:139-177)."""
        if self._state != SeqState.UNINITIALIZED:
            raise AssertionError(
                f"seq_no={self.seq_no} must be uninitialized to allocate, "
                f"was {self._state.name}"
            )
        self.state = SeqState.ALLOCATED
        self.batch = request_acks
        self.outstanding_reqs = outstanding_reqs

        if not request_acks:
            # Null batch: no digest to compute.
            self.state = SeqState.READY
            return self.apply_batch_hash_result(None)

        actions = Actions().hash(
            [ack.digest for ack in request_acks],
            st.BatchOrigin(
                source=self.owner,
                epoch=self.epoch,
                seq_no=self.seq_no,
                request_acks=tuple(request_acks),
            ),
        )
        self.state = SeqState.PENDING_REQUESTS
        return actions.concat(self.advance_state())

    def satisfy_outstanding(self, ack: RequestAck) -> Actions:
        """A request this sequence was waiting on became locally available
        (reference sequence.go:179-188)."""
        if self.outstanding_reqs is None or ack not in self.outstanding_reqs:
            raise AssertionError(
                f"told request {ack.digest.hex()} was ready but we weren't "
                "waiting for it"
            )
        self.outstanding_reqs.discard(ack)
        return self.advance_state()

    def _check_requests(self) -> None:
        if self.outstanding_reqs:
            return
        self.state = SeqState.READY

    # --- three-phase commit ---

    def apply_batch_hash_result(self, digest: Optional[bytes]) -> Actions:
        """Record the batch digest (computed on TPU) and treat it as the
        owner's implicit prepare (reference sequence.go:190-194)."""
        self.digest = digest
        if self.plane is not None:
            self.plane.set_expected(
                self.seq_no, digest if digest is not None else b""
            )
        count = self._count_prepare(self.owner, digest)
        if count is None:
            # The owner's Commit counted its vote before this digest
            # arrived (a follower whose hashing lags the network), so the
            # implicit prepare is a duplicate.  The sequence still needs
            # the digest's arrival to leave READY, or it waits for an
            # epoch change.
            state = self._state
            if state is SeqState.READY or state is SeqState.PENDING_REQUESTS:
                return self.advance_state()
            return EMPTY_ACTIONS
        return self._advance_on_prepare(count)

    def _prepare(self) -> Actions:
        """Persist the QEntry, then send Preprepare (owner) or Prepare
        (follower) — WAL-before-send (reference sequence.go:196-255)."""
        self.q_entry = QEntry(
            seq_no=self.seq_no,
            digest=self.digest if self.digest is not None else b"",
            requests=tuple(self.batch),
        )
        self.state = SeqState.PREPREPARED

        actions = self.persisted.add_q_entry(self.q_entry)

        if self.owner == self.my_id:
            # Forward each request to nodes that have not acked it, so
            # followers can satisfy their outstanding-request checks.
            for cr in self.client_requests:
                # refresh(): the live agreement mask may be accumulating in
                # the native ack plane (disseminator.ClientRequest.refresh).
                agreements = cr.refresh()
                missing = [
                    node
                    for node in self.network_config.nodes
                    if not (agreements >> node) & 1
                ]
                if missing:
                    actions.forward_request(missing, cr.ack)
            actions.send(
                self.network_config.nodes,
                Preprepare(
                    seq_no=self.seq_no, epoch=self.epoch, batch=tuple(self.batch)
                ),
            )
        else:
            actions.send(
                self.network_config.nodes,
                Prepare(
                    seq_no=self.seq_no,
                    epoch=self.epoch,
                    digest=self.digest if self.digest is not None else b"",
                ),
            )
        return actions

    def apply_prepare_msg(self, source: int, digest: Optional[bytes]) -> Actions:
        """Reference sequence.go:257-274, with one deviation: duplicate
        prepares are dropped for the owner too.  In the reference, the owner's
        artificial prepare (from the batch hash result) and its own Preprepare
        loopback BOTH increment the prepare count (its dup-check is
        ``source != owner`` only), letting a leader count itself twice toward
        the 2f+1 prepare certificate.  We count each node at most once."""
        count = self._count_prepare(source, digest)
        if count is None:
            return EMPTY_ACTIONS  # duplicate
        return self._advance_on_prepare(count)

    def _count_prepare(self, source: int, digest: Optional[bytes]) -> Optional[int]:
        """Record ``source``'s prepare; the votes now on ``digest``, or None
        for a node that already voted."""
        if self.plane is not None:
            count = self.plane.apply_vote(
                0, self.seq_no, digest if digest is not None else b"", source
            )
            if count is None:
                return None
            if source == self.my_id:
                self.my_prepare_digest = digest
        else:
            bit = 1 << source
            if (self.prep_mask | self.commit_mask) & bit:
                return None
            self.prep_mask |= bit
            if source == self.my_id:
                self.my_prepare_digest = digest
            key = digest if digest is not None else b""
            count = self.prepares.get(key, 0) + 1
            self.prepares[key] = count
        return count

    def _advance_on_prepare(self, count: int) -> Actions:
        # advance_state can only do work here when the prepare quorum on the
        # incremented digest is reachable (PREPREPARED) or when this is the
        # digest-arrival path (READY/PENDING_REQUESTS); every other state's
        # transitions do not read prepare votes, so skip the fixpoint walk.
        state = self._state
        if state is SeqState.PREPREPARED:
            if count >= self._iq:
                return self.advance_state()
            return Actions()
        if state is SeqState.READY or state is SeqState.PENDING_REQUESTS:
            return self.advance_state()
        return EMPTY_ACTIONS

    def _check_prepare_quorum(self) -> Actions:
        """2f+1 prepares (leader's preprepare counts) + own prepare persisted
        → persist PEntry, send Commit (reference sequence.go:276-318)."""
        my_key = self.digest if self.digest is not None else b""
        if self.plane is not None:
            prep_count, _, self_pc, _, my_matches = self.plane.query(self.seq_no)
            if not self_pc:
                # Have not sent our own prepare → QEntry may not be persisted.
                return EMPTY_ACTIONS
            if not my_matches:
                # Network's correct digest differs from ours; do not prepare.
                return EMPTY_ACTIONS
            if prep_count < self._iq:
                return EMPTY_ACTIONS
        else:
            agreements = self.prepares.get(my_key, 0)
            if not ((self.prep_mask | self.commit_mask) >> self.my_id) & 1:
                return EMPTY_ACTIONS
            my_digest = (
                self.my_prepare_digest
                if self.my_prepare_digest is not None
                else b""
            )
            if my_digest != my_key:
                return EMPTY_ACTIONS
            if agreements < self._iq:
                return EMPTY_ACTIONS

        self.state = SeqState.PREPARED
        p_entry = PEntry(seq_no=self.seq_no, digest=my_key)
        return self.persisted.add_p_entry(p_entry).send(
            self.network_config.nodes,
            Commit(seq_no=self.seq_no, epoch=self.epoch, digest=my_key),
        )

    def apply_commit_msg(self, source: int, digest: Optional[bytes]) -> Actions:
        """Reference sequence.go:320-337."""
        if self.plane is not None:
            count = self.plane.apply_vote(
                1, self.seq_no, digest if digest is not None else b"", source
            )
            if count is None:
                return EMPTY_ACTIONS  # duplicate commit
        else:
            bit = 1 << source
            if self.commit_mask & bit:
                return EMPTY_ACTIONS  # duplicate commit
            self.commit_mask |= bit
            key = digest if digest is not None else b""
            count = self.commits.get(key, 0) + 1
            self.commits[key] = count
        # Only a PREPARED sequence with a reachable commit quorum can
        # transition on a commit vote (commit emission itself is action-free).
        if self._state is SeqState.PREPARED and count >= self._iq:
            self._check_commit_quorum()
        return EMPTY_ACTIONS

    def _check_commit_quorum(self) -> None:
        """Reference sequence.go:339-355."""
        if self.plane is not None:
            _, commit_count, _, self_c, _ = self.plane.query(self.seq_no)
            if not self_c:
                return  # our own Commit (and thus PEntry persist) not sent yet
            if commit_count < self._iq:
                return
        else:
            my_key = self.digest if self.digest is not None else b""
            agreements = self.commits.get(my_key, 0)
            if not (self.commit_mask >> self.my_id) & 1:
                return
            if agreements < self._iq:
                return
        self.state = SeqState.COMMITTED
