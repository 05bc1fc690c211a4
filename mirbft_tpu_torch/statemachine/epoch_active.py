"""Active epoch: the normal-case ordering machinery.

Rebuild of reference ``pkg/statemachine/epoch_active.go``: the watermark
window of sequences in checkpoint-interval chunks, bucket→leader assignment
(:61-70), per-bucket in-order preprepare buffers (:88-97), the
past/current/future/invalid message filter (:142-213), the commit cascade
into ``CommitState`` (:296-317), window advancement allocating new intervals
+ NEntries and pulling proposals for owned buckets (:368-423), and the tick
handler driving the progress watchdog (→ Suspect) and heartbeat (null /
partial batches) (:438-490).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..messages import (
    Commit,
    EpochConfig,
    Msg,
    NEntry,
    NetworkConfig,
    Preprepare,
    Prepare,
    RequestAck,
    Suspect,
)
from ..state import EventInitialParameters
from .actions import EMPTY_ACTIONS, Actions
from .client_tracker import ClientTracker
from .commitstate import CommitState
from .msgbuffers import Applyable, MsgBuffer, NodeBuffers
from .outstanding import AllOutstandingReqs
from .persisted import PersistedLog
from .proposer import Proposer
from .sequence import SeqState, Sequence
from .stateless import intersection_quorum, seq_to_bucket
from .voteplane import make_seq_plane


class PreprepareBuffer:
    __slots__ = ("next_seq_no", "buffer")

    def __init__(self, next_seq_no: int, buffer: MsgBuffer):
        self.next_seq_no = next_seq_no
        self.buffer = buffer


def assign_buckets(
    epoch_config: EpochConfig, network_config: NetworkConfig
) -> Dict[int, int]:
    """Bucket→leader assignment, rotating with the epoch number; buckets whose
    natural leader is not in the leader set overflow round-robin onto actual
    leaders (reference epoch_active.go:53-70)."""
    leaders = set(epoch_config.leaders)
    buckets: Dict[int, int] = {}
    overflow_index = 0
    nodes = network_config.nodes
    for i in range(network_config.number_of_buckets):
        natural = nodes[(i + epoch_config.number) % len(nodes)]
        if natural in leaders:
            buckets[i] = natural
        else:
            buckets[i] = epoch_config.leaders[
                overflow_index % len(epoch_config.leaders)
            ]
            overflow_index += 1
    return buckets


class ActiveEpoch:
    """Reference epoch_active.go:22-121."""

    __slots__ = (
        "epoch_config",
        "network_config",
        "my_config",
        "logger",
        "outstanding_reqs",
        "proposer",
        "persisted",
        "commit_state",
        "buckets",
        "sequences",
        "preprepare_buffers",
        "other_buffers",
        "lowest_uncommitted",
        "lowest_unallocated",
        "last_committed_at_tick",
        "ticks_since_progress",
        "_nb",
        "_ci",
        "_owned_buckets",
        "_buffered",
        "_drain_memo",
        "seq_plane",
    )

    def __init__(
        self,
        epoch_config: EpochConfig,
        persisted: PersistedLog,
        node_buffers: NodeBuffers,
        commit_state: CommitState,
        client_tracker: ClientTracker,
        my_config: EventInitialParameters,
        logger=None,
    ):
        network_config = commit_state.active_state.config
        starting_seq_no = commit_state.highest_commit

        self.epoch_config = epoch_config
        self.network_config = network_config
        self.my_config = my_config
        # Per-buffer no-op-scan memo: (filter fingerprint, buffer version)
        # recorded when a drain scan applied nothing, so unchanged buffers
        # are not re-filtered every fixpoint iteration (observably pure —
        # a no-op iterate leaves buffer and state untouched).  Keys:
        # ("pp", bucket) for in-order preprepare buffers, node id for the
        # per-peer other-message buffers.
        self._drain_memo = {}
        self.logger = logger
        self.persisted = persisted
        self.commit_state = commit_state

        self.outstanding_reqs = AllOutstandingReqs(
            client_tracker.available_list, commit_state.active_state, logger
        )
        self.buckets = assign_buckets(epoch_config, network_config)

        num_buckets = len(self.buckets)
        self._nb = num_buckets
        self._ci = network_config.checkpoint_interval
        self._owned_buckets = [
            b for b in range(num_buckets) if self.buckets[b] == my_config.id
        ]
        # Shared live count of messages parked in this epoch's buffers, so the
        # per-event drain scan is O(1) when nothing is parked.
        self._buffered = [0]
        self.lowest_unallocated = [0] * num_buckets
        for i in range(num_buckets):
            first_seq_no = starting_seq_no + i + 1
            self.lowest_unallocated[
                seq_to_bucket(first_seq_no, network_config)
            ] = first_seq_no

        self.lowest_uncommitted = commit_state.highest_commit + 1

        self.proposer = Proposer(
            base_checkpoint=starting_seq_no,
            checkpoint_interval=network_config.checkpoint_interval,
            my_config=my_config,
            ready_list=client_tracker.ready_list,
            buckets=self.buckets,
            network_config=network_config,
        )

        self.preprepare_buffers = [
            PreprepareBuffer(
                next_seq_no=self.lowest_unallocated[i],
                buffer=MsgBuffer(
                    f"epoch-{epoch_config.number}-preprepare",
                    node_buffers.node_buffer(self.buckets[i]),
                    group=self._buffered,
                ),
            )
            for i in range(num_buckets)
        ]
        self.other_buffers = {
            node: MsgBuffer(
                f"epoch-{epoch_config.number}-other",
                node_buffers.node_buffer(node),
                group=self._buffered,
            )
            for node in network_config.nodes
        }

        # checkpoint-interval chunks of Sequence (window)
        self.sequences: List[List[Sequence]] = []
        self.last_committed_at_tick = 0
        self.ticks_since_progress = 0

        # Native vote plane for this epoch's window (None = pure-Python).
        # Mirrors the watermark window exactly; see voteplane.py.
        plane = make_seq_plane(
            len(network_config.nodes),
            my_config.id,
            intersection_quorum(network_config),
        )
        if plane is not None:
            import struct

            plane.reset(
                epoch_config.number,
                epoch_config.planned_expiration,
                struct.pack(
                    f"<{num_buckets}i",
                    *(self.buckets[i] for i in range(num_buckets)),
                ),
            )
        self.seq_plane = plane

    # --- window geometry ---

    def seq_to_bucket(self, seq_no: int) -> int:
        return seq_to_bucket(seq_no, self.network_config)

    def low_watermark(self) -> int:
        return self.sequences[0][0].seq_no

    def high_watermark(self) -> int:
        if not self.sequences:
            return self.commit_state.low_watermark
        return self.sequences[-1][-1].seq_no

    def in_watermarks(self, seq_no: int) -> bool:
        return self.low_watermark() <= seq_no <= self.high_watermark()

    def sequence(self, seq_no: int) -> Sequence:
        ci = self.network_config.checkpoint_interval
        index = (seq_no - self.low_watermark()) // ci
        offset = (seq_no - self.low_watermark()) % ci
        seq = self.sequences[index][offset]
        if seq.seq_no != seq_no:
            raise AssertionError("sequence retrieved had unexpected seq_no")
        return seq

    # --- message filtering (reference epoch_active.go:142-213) ---

    def filter(self, source: int, msg: Msg) -> Applyable:
        # NOTE: the Prepare/Commit arms are duplicated (fused with their
        # apply step) in _step_prepare/_step_commit for the live hot path;
        # any rule change here must be mirrored there.
        if isinstance(msg, Preprepare):
            seq_no = msg.seq_no
            bucket = self.seq_to_bucket(seq_no)
            if self.buckets[bucket] != source:
                return Applyable.INVALID
            if seq_no > self.epoch_config.planned_expiration:
                return Applyable.INVALID
            if seq_no > self.high_watermark():
                return Applyable.FUTURE
            if seq_no < self.low_watermark():
                return Applyable.PAST
            next_preprepare = self.preprepare_buffers[bucket].next_seq_no
            if seq_no < next_preprepare:
                return Applyable.PAST
            if seq_no > next_preprepare:
                return Applyable.FUTURE
            return Applyable.CURRENT
        if isinstance(msg, Prepare):
            seq_no = msg.seq_no
            bucket = self.seq_to_bucket(seq_no)
            if self.buckets[bucket] == source:
                return Applyable.INVALID  # owners never send Prepare
            if seq_no > self.epoch_config.planned_expiration:
                return Applyable.INVALID
            if seq_no < self.low_watermark():
                return Applyable.PAST
            if seq_no > self.high_watermark():
                return Applyable.FUTURE
            return Applyable.CURRENT
        if isinstance(msg, Commit):
            seq_no = msg.seq_no
            if seq_no > self.epoch_config.planned_expiration:
                return Applyable.INVALID
            if seq_no < self.low_watermark():
                return Applyable.PAST
            if seq_no > self.high_watermark():
                return Applyable.FUTURE
            return Applyable.CURRENT
        raise AssertionError(f"unexpected msg type {type(msg).__name__}")

    def apply(self, source: int, msg: Msg) -> Actions:
        """Reference epoch_active.go:215-241."""
        actions = Actions()
        if isinstance(msg, Preprepare):
            bucket = self.seq_to_bucket(msg.seq_no)
            buffer = self.preprepare_buffers[bucket]
            next_msg: Optional[Msg] = msg
            while next_msg is not None:
                own = self.sequence(next_msg.seq_no).owner == self.my_config.id
                before = self.lowest_unallocated[bucket]
                actions.concat(
                    self.apply_preprepare_msg(
                        source, next_msg.seq_no, list(next_msg.batch)
                    )
                )
                if not own and self.lowest_unallocated[bucket] == before:
                    # Rejected (leader demoted, apply_preprepare_msg): the
                    # slot is still unallocated, so the cursor must not move
                    # past it — a later valid Preprepare for this seq_no has
                    # to remain CURRENT, not trip the in-order guard.
                    break
                buffer.next_seq_no += len(self.buckets)
                next_msg = buffer.buffer.next(self.filter)
        elif isinstance(msg, Prepare):
            actions.concat(self.apply_prepare_msg(source, msg.seq_no, msg.digest))
        elif isinstance(msg, Commit):
            actions.concat(self.apply_commit_msg(source, msg.seq_no, msg.digest))
        else:
            raise AssertionError(f"unexpected msg type {type(msg).__name__}")
        return actions

    def step(self, source: int, msg: Msg) -> Actions:
        # Prepare/Commit are the cluster's two hottest message types (O(n)
        # per sequence per replica): fused filter+apply handlers below skip
        # the generic two-pass classification.
        t = msg.__class__
        if t is Prepare:
            return self._step_prepare(source, msg)
        if t is Commit:
            return self._step_commit(source, msg)
        verdict = self.filter(source, msg)
        if verdict == Applyable.CURRENT:
            return self.apply(source, msg)
        if verdict == Applyable.FUTURE:
            if isinstance(msg, Preprepare):
                bucket = self.seq_to_bucket(msg.seq_no)
                self.preprepare_buffers[bucket].buffer.store(msg)
            else:
                self.other_buffers[source].store(msg)
        # PAST / INVALID: drop
        return Actions()

    def _step_prepare(self, source: int, msg: Prepare) -> Actions:
        """filter()+apply() for a Prepare, in one pass (same verdicts)."""
        seq_no = msg.seq_no
        if self.buckets[seq_no % self._nb] == source:
            return Actions()  # INVALID: owners never send Prepare
        if seq_no > self.epoch_config.planned_expiration:
            return Actions()  # INVALID
        seqs = self.sequences
        low = seqs[0][0].seq_no
        if seq_no < low:
            return Actions()  # PAST
        if seq_no > seqs[-1][-1].seq_no:
            self.other_buffers[source].store(msg)  # FUTURE
            return Actions()
        offset = seq_no - low
        seq = seqs[offset // self._ci][offset % self._ci]
        return seq.apply_prepare_msg(source, msg.digest)

    def _step_commit(self, source: int, msg: Commit) -> Actions:
        """filter()+apply() for a Commit, in one pass (same verdicts),
        including the in-order commit cascade into CommitState."""
        seq_no = msg.seq_no
        if seq_no > self.epoch_config.planned_expiration:
            return Actions()  # INVALID
        seqs = self.sequences
        low = seqs[0][0].seq_no
        if seq_no < low:
            return Actions()  # PAST
        high = seqs[-1][-1].seq_no
        if seq_no > high:
            self.other_buffers[source].store(msg)  # FUTURE
            return Actions()
        offset = seq_no - low
        seq = seqs[offset // self._ci][offset % self._ci]
        seq.apply_commit_msg(source, msg.digest)
        if seq.state is not SeqState.COMMITTED or seq_no != self.lowest_uncommitted:
            return Actions()
        self._commit_cascade()
        return Actions()

    def apply_envelope_votes(
        self, packed: bytes, vote_msgs: List[Msg], source: int, step
    ) -> Actions:
        """Apply one transport envelope's Prepare/Commit votes through the
        native plane in a single call, then run the returned records in vote
        order: fallbacks re-enter the generic ``step`` with the original
        message (future buffering, other epochs), hints run the transition
        checks the per-message path would have run — which re-validate every
        quorum condition against the plane's live counts, so hints are safe
        to be liberal."""
        actions = Actions()
        records = self.seq_plane.apply_votes(packed, source)
        for rec in records:
            if len(rec) == 1:
                actions.concat(step(source, vote_msgs[rec[0]]))
                continue
            kind, seq_no = rec
            seq = self.sequence(seq_no)
            if kind == 0:
                # Mirrors apply_prepare_msg's state arms.
                s = seq.state
                if (
                    s is SeqState.PREPREPARED
                    or s is SeqState.READY
                    or s is SeqState.PENDING_REQUESTS
                ):
                    actions.concat(seq.advance_state())
            else:
                seq._check_commit_quorum()
            if (
                seq.state is SeqState.COMMITTED
                and seq.seq_no == self.lowest_uncommitted
            ):
                self._commit_cascade()
        return actions

    def _commit_cascade(self) -> None:
        """Feed consecutive committed sequences into CommitState, in order."""
        seqs = self.sequences
        low = seqs[0][0].seq_no
        high = seqs[-1][-1].seq_no
        ci = self._ci
        lowest = self.lowest_uncommitted
        commit = self.commit_state.commit
        while lowest <= high:
            offset = lowest - low
            seq = seqs[offset // ci][offset % ci]
            if seq.state is not SeqState.COMMITTED:
                break
            commit(seq.q_entry)
            lowest += 1
        self.lowest_uncommitted = lowest

    # --- three-phase message application ---

    def apply_preprepare_msg(
        self, source: int, seq_no: int, batch: List[RequestAck]
    ) -> Actions:
        """Reference epoch_active.go:247-271."""
        seq = self.sequence(seq_no)

        if seq.owner == self.my_config.id:
            # Already allocated at proposal time; the loopback Preprepare is
            # our own prepare-equivalent.
            return seq.apply_prepare_msg(source, seq.digest)

        bucket = self.seq_to_bucket(seq_no)
        if seq_no != self.lowest_unallocated[bucket]:
            raise AssertionError(
                "step should defer all but the next expected preprepare"
            )

        # Validates in-order request consumption and allocates the sequence.
        # ValueError means a protocol-invalid batch (unknown client,
        # out-of-order req_no) from the bucket's leader: the reference
        # panics here with a "TODO to suspect instead" — this emits the
        # Suspect.  apply_acks is validate-then-apply, so the rejected
        # batch left no partial state; the sequence stays unallocated and
        # the view change demotes the leader instead of the crash demoting
        # this node.
        try:
            actions = self.outstanding_reqs.apply_acks(bucket, seq, batch)
        except ValueError as err:
            suspect = Suspect(epoch=self.epoch_config.number)
            actions = Actions()
            actions.send(self.network_config.nodes, suspect)
            actions.concat(self.persisted.add_suspect(suspect))
            if self.logger is not None:
                self.logger.warn(
                    "suspecting epoch: protocol-invalid preprepare from leader",
                    epoch=self.epoch_config.number,
                    leader=source,
                    seq_no=seq_no,
                    error=str(err),
                )
            return actions
        self.lowest_unallocated[bucket] += len(self.buckets)
        return actions

    def apply_prepare_msg(self, source: int, seq_no: int, digest: bytes) -> Actions:
        return self.sequence(seq_no).apply_prepare_msg(source, digest)

    def apply_commit_msg(self, source: int, seq_no: int, digest: bytes) -> Actions:
        """Commit plus in-order cascade into CommitState
        (reference epoch_active.go:296-317)."""
        seq = self.sequence(seq_no)
        seq.apply_commit_msg(source, digest)
        if seq.state != SeqState.COMMITTED or seq_no != self.lowest_uncommitted:
            return Actions()
        self._commit_cascade()
        return Actions()

    def apply_batch_hash_result(self, seq_no: int, digest: bytes) -> Actions:
        """Route a TPU-computed batch digest to its sequence
        (reference epoch_active.go:425-436)."""
        if not self.in_watermarks(seq_no):
            return Actions()  # benign during/after state transfer
        return self.sequence(seq_no).apply_batch_hash_result(digest)

    # --- watermark movement / window advance ---

    def move_low_watermark(self, seq_no: int) -> Tuple[Actions, bool]:
        """Returns (actions, epoch_done) (reference epoch_active.go:319-337)."""
        if seq_no == self.epoch_config.planned_expiration:
            return Actions(), True
        if seq_no == self.commit_state.stop_at_seq_no:
            return Actions(), True

        actions = self.advance()
        while seq_no > self.low_watermark():
            self.sequences = self.sequences[1:]
        if self.seq_plane is not None and self.sequences:
            self.seq_plane.set_window(self.low_watermark(), self.high_watermark())
        return actions, False

    def _drain_fp(self):
        """Everything ``filter`` verdicts depend on (watermarks + per-bucket
        in-order cursors; bucket map and expiration are epoch-static)."""
        return (
            self.low_watermark(),
            self.high_watermark(),
            tuple(b.next_seq_no for b in self.preprepare_buffers),
        )

    def drain_buffers(self) -> Actions:
        """Reference epoch_active.go:339-366."""
        actions = Actions()
        if not self._buffered[0]:
            return actions  # nothing parked anywhere in this epoch
        memo = self._drain_memo
        fp = self._drain_fp()
        for bucket in range(len(self.buckets)):
            buffer = self.preprepare_buffers[bucket]
            if not buffer.buffer:
                continue
            key = ("pp", bucket)
            if memo.get(key) == (fp, buffer.buffer.version):
                continue  # provably the same all-FUTURE scan as last time
            source = self.buckets[bucket]
            next_msg = buffer.buffer.next(self.filter)
            if next_msg is None:
                memo[key] = (fp, buffer.buffer.version)
                continue
            # apply() loops over consecutive preprepares internally
            actions.concat(self.apply(source, next_msg))
            fp = self._drain_fp()  # cursors/watermarks may have moved

        for node in self.network_config.nodes:
            other = self.other_buffers[node]
            if not other.buffer:
                continue
            if memo.get(node) == (fp, other.version):
                continue
            hit = [False]

            def apply_msg(nid, msg, _hit=hit):
                _hit[0] = True
                actions.concat(self.apply(nid, msg))

            other.iterate(self.filter, apply_msg)
            if hit[0]:
                fp = self._drain_fp()
            else:
                memo[node] = (fp, other.version)
        return actions

    def needs_advance(self) -> bool:
        """Cheap predicate for the per-event fixpoint: advance() is a no-op
        unless the window can extend, buffered messages may drain, or new
        ready proposals can be pulled/allocated.  Mirrors exactly the
        conditions under which advance() emits actions or mutates state."""
        hw = self.high_watermark()
        if (
            hw < self.epoch_config.planned_expiration
            and hw < self.commit_state.stop_at_seq_no
        ):
            return True  # window extension pending
        if self._buffered[0]:
            return True  # buffered consensus msgs may now apply
        proposer = self.proposer
        if proposer.ready_iterator.has_next():
            return True  # new strong-cert requests to pull
        for bucket in self._owned_buckets:
            seq_no = self.lowest_unallocated[bucket]
            if seq_no <= hw and proposer.proposal_bucket(bucket).has_pending(
                seq_no
            ):
                return True
        return False

    def advance(self) -> Actions:
        """Extend the window with new checkpoint intervals (persisting an
        NEntry per chunk), drain buffers, pull proposals into owned buckets
        (reference epoch_active.go:368-423)."""
        actions = Actions()
        if self.high_watermark() > self.epoch_config.planned_expiration:
            raise AssertionError("window extends beyond planned expiration")
        if self.high_watermark() > self.commit_state.stop_at_seq_no:
            raise AssertionError("window extends beyond the stop sequence")

        ci = self.network_config.checkpoint_interval
        while (
            self.high_watermark() < self.epoch_config.planned_expiration
            and self.high_watermark() < self.commit_state.stop_at_seq_no
        ):
            base = self.high_watermark() + 1
            actions.concat(
                self.persisted.add_n_entry(
                    NEntry(seq_no=base, epoch_config=self.epoch_config)
                )
            )
            chunk = [
                Sequence(
                    owner=self.buckets[self.seq_to_bucket(base + i)],
                    epoch=self.epoch_config.number,
                    seq_no=base + i,
                    persisted=self.persisted,
                    network_config=self.network_config,
                    my_id=self.my_config.id,
                    plane=self.seq_plane,
                )
                for i in range(ci)
            ]
            self.sequences.append(chunk)

        if self.seq_plane is not None and self.sequences:
            self.seq_plane.set_window(self.low_watermark(), self.high_watermark())

        actions.concat(self.drain_buffers())

        self.proposer.advance(self.lowest_uncommitted)

        for bucket in self._owned_buckets:
            prb = self.proposer.proposal_bucket(bucket)
            while True:
                seq_no = self.lowest_unallocated[bucket]
                if seq_no > self.high_watermark():
                    break
                if not prb.has_pending(seq_no):
                    break
                seq = self.sequence(seq_no)
                actions.concat(seq.allocate_as_owner(prb.next()))
                self.lowest_unallocated[bucket] += len(self.buckets)
        return actions

    # --- ticks (reference epoch_active.go:438-490) ---

    def tick(self) -> Actions:
        if self.last_committed_at_tick < self.commit_state.highest_commit:
            self.last_committed_at_tick = self.commit_state.highest_commit
            self.ticks_since_progress = 0
            return Actions()

        self.ticks_since_progress += 1
        actions = Actions()

        if self.ticks_since_progress > self.my_config.suspect_ticks:
            suspect = Suspect(epoch=self.epoch_config.number)
            actions.send(self.network_config.nodes, suspect)
            actions.concat(self.persisted.add_suspect(suspect))
            if self.logger is not None:
                self.logger.warn(
                    "suspecting epoch: no progress",
                    epoch=self.epoch_config.number,
                    ticks_since_progress=self.ticks_since_progress,
                )

        if (
            self.my_config.heartbeat_ticks == 0
            or self.ticks_since_progress % self.my_config.heartbeat_ticks != 0
        ):
            return actions

        # Heartbeat: cut a partial (possibly null) batch in every owned bucket.
        for bucket in self._owned_buckets:
            unallocated_seq_no = self.lowest_unallocated[bucket]
            if unallocated_seq_no > self.high_watermark():
                continue
            seq = self.sequence(unallocated_seq_no)
            prb = self.proposer.proposal_bucket(bucket)
            client_reqs = []
            if prb.has_outstanding(unallocated_seq_no):
                client_reqs = prb.next()
            actions.concat(seq.allocate_as_owner(client_reqs))
            self.lowest_unallocated[bucket] += len(self.buckets)
        return actions
