"""Epoch lifecycle: the 11-state target machine driving view change.

Rebuild of reference ``pkg/statemachine/epoch_target.go``: collects epoch
changes + ACKs into strong certs, the primary constructs the NewEpoch,
validation reconstructs the config and compares (:168-212), the fetch phase
retrieves missing batches/requests referenced by the new epoch (:214-397),
and a Bracha reliable broadcast carries the config — Echo doubles as the PBFT
Prepare for carried-over sequences, Ready doubles as Commit (:632-775).
Epoch-change digests and fetched-batch verification hashes are computed by
the TPU batcher.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Set, Tuple

from .. import state as st
from ..messages import (
    ECEntry,
    EpochChange,
    EpochChangeAck,
    Msg,
    NEntry,
    NetworkConfig,
    NewEpoch,
    NewEpochConfig,
    NewEpochEcho,
    NewEpochReady,
    PEntry,
    QEntry,
    RemoteEpochChange,
    Suspect,
)
from ..state import EventInitialParameters
from .actions import EMPTY_ACTIONS, Actions
from .batch_tracker import BatchTracker
from .client_tracker import ClientTracker
from .commitstate import CommitState
from .disseminator import ClientHashDisseminator
from .epoch_active import ActiveEpoch
from .epoch_change import EpochChangeVotes, ParsedEpochChange
from .msgbuffers import Applyable, MsgBuffer, NodeBuffers
from .persisted import PersistedLog
from .stateless import (
    construct_new_epoch_config,
    epoch_change_hash_data,
    intersection_quorum,
    some_correct_quorum,
)


class EpochTargetState(enum.IntEnum):
    PREPENDING = 0   # sent an epoch-change; waiting for a quorum
    PENDING = 1      # quorum of epoch-changes; waiting on new-epoch
    VERIFYING = 2    # have a NewEpoch but cannot verify its references yet
    FETCHING = 3     # verified NewEpoch; fetching missing state
    ECHOING = 4      # echoed; waiting for echo quorum
    READYING = 5     # echo quorum; waiting for ready quorum
    RESUMING = 6     # crashed during this epoch; waiting to resume
    READY = 7        # new epoch ready to begin
    IN_PROGRESS = 8  # no pending change
    ENDING = 9       # committed all it can; stable checkpoint reached
    DONE = 10        # epoch over for us (epoch change sent)


class EpochTarget:
    """Reference epoch_target.go:39-118."""

    __slots__ = (
        "state",
        "commit_state",
        "state_ticks",
        "number",
        "starting_seq_no",
        "changes",
        "strong_changes",
        "echos",
        "readies",
        "active_epoch",
        "suspicions",
        "my_new_epoch",
        "my_epoch_change",
        "my_leader_choice",
        "leader_new_epoch",
        "network_new_epoch",
        "resume_epoch_config",
        "is_primary",
        "prestart_buffers",
        "persisted",
        "node_buffers",
        "client_tracker",
        "client_hash_disseminator",
        "batch_tracker",
        "network_config",
        "my_config",
        "logger",
        "_ec_digests",
        "_ec_keys",
        "_ne_construct_key",
        "_ne_verify_key",
    )

    def __init__(
        self,
        number: int,
        persisted: PersistedLog,
        node_buffers: NodeBuffers,
        commit_state: CommitState,
        client_tracker: ClientTracker,
        client_hash_disseminator: ClientHashDisseminator,
        batch_tracker: BatchTracker,
        network_config: NetworkConfig,
        my_config: EventInitialParameters,
        logger=None,
    ):
        self.state = EpochTargetState.PREPENDING
        self.number = number
        self.commit_state = commit_state
        self.state_ticks = 0
        self.starting_seq_no = 0
        self.changes: Dict[int, EpochChangeVotes] = {}
        self.strong_changes: Dict[int, ParsedEpochChange] = {}
        self.echos: Dict[NewEpochConfig, Set[int]] = {}
        self.readies: Dict[NewEpochConfig, Set[int]] = {}
        self.active_epoch: Optional[ActiveEpoch] = None
        self.suspicions: Set[int] = set()
        self.my_new_epoch: Optional[NewEpoch] = None
        self.my_epoch_change: Optional[ParsedEpochChange] = None
        self.my_leader_choice: Optional[Tuple[int, ...]] = None
        self.leader_new_epoch: Optional[NewEpoch] = None
        self.network_new_epoch: Optional[NewEpochConfig] = None
        # Set on the crash-recovery resume path (no Bracha broadcast ran):
        # the epoch config from the last NEntry, used to rebuild the active
        # epoch at READY.  (The reference nil-derefs in this situation when
        # no state transfer is needed, epoch_target.go:813.)
        self.resume_epoch_config = None
        self.is_primary = number % len(network_config.nodes) == my_config.id
        self.prestart_buffers = {
            node: MsgBuffer(
                f"epoch-{number}-prestart", node_buffers.node_buffer(node)
            )
            for node in network_config.nodes
        }
        self.persisted = persisted
        self.node_buffers = node_buffers
        self.client_tracker = client_tracker
        self.client_hash_disseminator = client_hash_disseminator
        self.batch_tracker = batch_tracker
        self.network_config = network_config
        self.my_config = my_config
        self.logger = logger
        # Digest memo for epoch-change ack hashing: every ack carrying the
        # same EpochChange content hashes to the same digest, so only the
        # first ack per distinct content pays the hash-action round-trip
        # (the reference hashes every ack, epoch_target.go:514-528 — O(N³)
        # cluster-wide per epoch change).  The memo is keyed by CONTENT
        # (the flattened hash-data tuple) so behavior is a deterministic
        # function of the event stream — a serialized replay reproduces the
        # exact same state even though it sees fresh message objects.
        # content_key -> (digest, waiters): digest None while the hash
        # action is in flight, with (source, origin) pairs queued to apply
        # when the result lands.
        self._ec_digests: Dict[tuple, list] = {}
        # In-process transports hand all N acks the same message OBJECT, so
        # an identity side-table skips re-flattening per ack (values pin the
        # msg so ids stay stable); replay simply misses here and re-flattens.
        self._ec_keys: Dict[int, tuple] = {}
        # NewEpoch-construction/validation memos.  construct_new_epoch_config
        # is the expensive derivation of the view change (~1.3M cycles/msg at
        # 128 nodes per the profiler), and both its call sites re-run with
        # unchanged inputs on almost every event while the epoch change is
        # in flight: check_epoch_quorum per advance_state pass once quorum
        # is reached, verify_new_epoch_state per rebroadcast NewEpoch (the
        # primary re-sends every 2 ticks).  Each memo records the input
        # fingerprint of the last attempt that did NOT advance (None config
        # / failed validation) and skips re-derivation until the cert set —
        # monotone: entries are added once and never replaced — or the
        # leader's message changes.  Pure functions of the event stream,
        # like _ec_digests, so replay is unaffected.
        self._ne_construct_key: Optional[tuple] = None
        self._ne_verify_key: Optional[tuple] = None

    # --- three-phase traffic routing (reference :120-131) ---

    def step(self, source: int, msg: Msg) -> Actions:
        if self.state < EpochTargetState.IN_PROGRESS:
            self.prestart_buffers[source].store(msg)
            return Actions()
        if self.state == EpochTargetState.DONE:
            return Actions()
        return self.active_epoch.step(source, msg)

    # --- NewEpoch construction / verification ---

    def construct_new_epoch(
        self, new_leaders: Tuple[int, ...], nc: NetworkConfig
    ) -> Optional[NewEpoch]:
        """Reference :138-168."""
        if len(self.strong_changes) < intersection_quorum(nc):
            raise AssertionError(
                f"need {intersection_quorum(nc)} acked epoch changes, have "
                f"{len(self.strong_changes)}"
            )
        new_config = construct_new_epoch_config(nc, new_leaders, self.strong_changes)
        if new_config is None:
            return None

        remote_changes = tuple(
            RemoteEpochChange(
                node_id=node, digest=self.changes[node].strong_cert
            )
            for node in self.network_config.nodes  # deterministic order
            if node in self.strong_changes
        )
        return NewEpoch(new_config=new_config, epoch_changes=remote_changes)

    def verify_new_epoch_state(self) -> None:
        """Validate the primary's NewEpoch against locally-acked epoch
        changes and the deterministic reconstruction (reference :173-225).

        Memoized: validation is a pure function of (the leader's NewEpoch,
        which referenced certs are locally acked past the weak quorum), so
        a failed attempt is only retried when one of those inputs changes —
        not per rebroadcast/advance_state pass (see _ne_verify_key)."""
        key = (self.leader_new_epoch, self._verify_fingerprint())
        if key == self._ne_verify_key:
            return  # identical inputs already failed validation
        if self._validate_leader_new_epoch():
            self._ne_verify_key = None
            self.state = EpochTargetState.FETCHING
        else:
            self._ne_verify_key = key

    def _verify_fingerprint(self) -> tuple:
        """The cert-set inputs validation depends on, per referenced cert:
        is a parse for (node, digest) locally known and weakly acked?  The
        parsed *content* for a digest is fixed (it hashes to the digest),
        so the boolean crossing is the only thing that can change."""
        quorum = some_correct_quorum(self.network_config)
        fingerprint = []
        for remote in self.leader_new_epoch.epoch_changes:
            votes = self.changes.get(remote.node_id)
            parsed = (
                None if votes is None
                else votes.parsed_by_digest.get(remote.digest)
            )
            fingerprint.append(
                (
                    remote.node_id,
                    remote.digest,
                    parsed is not None and len(parsed.acks) >= quorum,
                )
            )
        return tuple(fingerprint)

    def _validate_leader_new_epoch(self) -> bool:
        epoch_changes: Dict[int, ParsedEpochChange] = {}
        for remote in self.leader_new_epoch.epoch_changes:
            if remote.node_id in epoch_changes:
                return False  # duplicate reference: malformed
            votes = self.changes.get(remote.node_id)
            if votes is None:
                return False  # primary lying, or we lack information
            parsed = votes.parsed_by_digest.get(remote.digest)
            if parsed is None or len(parsed.acks) < some_correct_quorum(
                self.network_config
            ):
                return False
            epoch_changes[remote.node_id] = parsed

        reconstructed = construct_new_epoch_config(
            self.network_config,
            self.leader_new_epoch.new_config.config.leaders,
            epoch_changes,
        )
        return reconstructed == self.leader_new_epoch.new_config

    def fetch_new_epoch_state(self) -> Actions:
        """Retrieve batches/requests the new epoch references that we lack
        (reference :228-397)."""
        new_epoch_config = self.leader_new_epoch.new_config

        if self.commit_state.transferring:
            return Actions()  # wait for state transfer first

        if new_epoch_config.starting_checkpoint.seq_no > self.commit_state.highest_commit:
            return self.commit_state.transfer_to(
                new_epoch_config.starting_checkpoint.seq_no,
                new_epoch_config.starting_checkpoint.value,
            )

        actions = Actions()
        fetch_pending = False

        for i, digest in enumerate(new_epoch_config.final_preprepares):
            if not digest:
                continue  # null request
            seq_no = i + new_epoch_config.starting_checkpoint.seq_no + 1
            if seq_no <= self.commit_state.highest_commit:
                continue  # already committed

            # Nodes whose Q-sets attest to this batch digest.
            sources = []
            for remote in self.leader_new_epoch.epoch_changes:
                parsed = self.changes[remote.node_id].parsed_by_digest[remote.digest]
                if digest in parsed.q_set.get(seq_no, {}).values():
                    sources.append(remote.node_id)
            if len(sources) < some_correct_quorum(self.network_config):
                raise AssertionError(
                    f"only {len(sources)} sources for seq {seq_no}; the "
                    "verified new-epoch config guarantees a weak quorum"
                )

            batch = self.batch_tracker.get_batch(digest)
            if batch is None:
                actions.concat(
                    self.batch_tracker.fetch_batch(seq_no, digest, tuple(sources))
                )
                fetch_pending = True
                continue

            batch.observed_for.add(seq_no)

            # Make sure every request in the batch is locally available,
            # crediting the attesting sources as acks for it.
            for request_ack in batch.request_acks:
                cr = None
                for node in sources:
                    i_actions, cr = self.client_hash_disseminator.ack(
                        node, request_ack, force=True
                    )
                    actions.concat(i_actions)
                if cr.stored:
                    continue
                fetch_pending = True
                actions.concat(cr.fetch())
                self.client_hash_disseminator.note_fetching(request_ack)

        if fetch_pending:
            return actions

        if new_epoch_config.starting_checkpoint.seq_no > self.commit_state.low_watermark:
            # Committed through this checkpoint but its result is still being
            # computed; wait before echoing.
            return actions

        self.state = EpochTargetState.ECHOING

        if (
            new_epoch_config.starting_checkpoint.seq_no == self.commit_state.stop_at_seq_no
            and new_epoch_config.final_preprepares
        ):
            # A verified NewEpoch carrying batches past a halted boundary is
            # unreachable for this machine; the reference leaves the spot
            # unresolved (panic "deal with this", epoch_target.go:333), but
            # the condition is provably vacuous among correct nodes:
            #
            # 1. Window extension is capped at stop_at_seq_no
            #    (epoch_active.advance), so no correct node ever persists a
            #    P/QEntry for a sequence past a halted checkpoint — halting
            #    only happens at a reconfiguration's applying checkpoint.
            # 2. construct_new_epoch_config emits a non-empty
            #    final_preprepares only if some digest past the starting
            #    checkpoint satisfies condition A2 — a weak quorum (f+1) of
            #    epoch changes carrying that Q-entry.  By (1) at most the f
            #    byzantine nodes can attest such entries: A2 cannot pass.
            # 3. A byzantine primary cannot fabricate the carryover either:
            #    verify_new_epoch_state re-runs construct_new_epoch_config
            #    over our locally-acked epoch changes, so a NewEpoch that
            #    violates (2) never reaches FETCHING.
            #
            # Reaching this point therefore means local state corruption —
            # fail loudly rather than order past a reconfiguration boundary
            # under the old configuration.  docs/Divergences.md #12.
            raise AssertionError(
                "verified NewEpoch carries batches past a reconfiguration "
                "boundary: impossible for <= f byzantine nodes (see proof "
                "in epoch_target.fetch_new_epoch_state)"
            )

        actions.concat(
            self.persisted.add_n_entry(
                NEntry(
                    seq_no=new_epoch_config.starting_checkpoint.seq_no + 1,
                    epoch_config=new_epoch_config.config,
                )
            )
        )

        for i, digest in enumerate(new_epoch_config.final_preprepares):
            seq_no = i + new_epoch_config.starting_checkpoint.seq_no + 1
            if not digest:
                actions.concat(
                    self.persisted.add_q_entry(
                        QEntry(seq_no=seq_no, digest=b"", requests=())
                    )
                )
                continue
            batch = self.batch_tracker.get_batch(digest)
            if batch is None:
                if seq_no <= self.commit_state.highest_commit:
                    # Already committed, so the fetch loop above skipped it
                    # — and a checkpoint reached meanwhile (commits or
                    # state transfer racing a slow epoch change) may have
                    # truncated it from the tracker.  Its QEntry is
                    # already in the log from the original commit; nothing
                    # to re-persist.
                    continue
                raise AssertionError("batch verified above is now missing")
            actions.concat(
                self.persisted.add_q_entry(
                    QEntry(
                        seq_no=seq_no,
                        digest=digest,
                        requests=tuple(batch.request_acks),
                    )
                )
            )
            if (
                seq_no % self.network_config.checkpoint_interval == 0
                and seq_no < self.commit_state.stop_at_seq_no
            ):
                actions.concat(
                    self.persisted.add_n_entry(
                        NEntry(
                            seq_no=seq_no + 1,
                            epoch_config=new_epoch_config.config,
                        )
                    )
                )

        self.starting_seq_no = (
            new_epoch_config.starting_checkpoint.seq_no
            + len(new_epoch_config.final_preprepares)
            + 1
        )

        # Bracha echo — which is simultaneously the PBFT Prepare for all the
        # carried-over sequences.
        return actions.send(
            self.network_config.nodes,
            NewEpochEcho(config=self.leader_new_epoch.new_config),
        )

    # --- ticks (reference :399-481) ---

    def tick(self) -> Actions:
        self.state_ticks += 1
        if self.state == EpochTargetState.PREPENDING:
            return self._tick_prepending()
        if self.state <= EpochTargetState.RESUMING:
            return self._tick_pending()
        if self.state <= EpochTargetState.IN_PROGRESS:
            return self.active_epoch.tick()
        return Actions()

    def repeat_epoch_change_broadcast(self) -> Actions:
        return Actions().send(
            self.network_config.nodes, self.my_epoch_change.underlying
        )

    def _tick_prepending(self) -> Actions:
        if self.my_new_epoch is None:
            half = self.my_config.new_epoch_timeout_ticks // 2
            if half and self.state_ticks % half == 0 and self.my_epoch_change is not None:
                return self.repeat_epoch_change_broadcast()
            return Actions()
        if self.is_primary:
            return Actions().send(self.network_config.nodes, self.my_new_epoch)
        return Actions()

    def _tick_pending(self) -> Actions:
        if self.my_new_epoch is None or self.my_epoch_change is None:
            # Crash-recovery RESUMING path: we never produced an epoch change
            # or new-epoch for this target; there is nothing to rebroadcast.
            # (The reference nil-derefs here, epoch_target.go:449-481.)
            return Actions()
        pending_ticks = self.state_ticks % self.my_config.new_epoch_timeout_ticks
        if self.is_primary:
            if pending_ticks % 2 == 0:
                return Actions().send(self.network_config.nodes, self.my_new_epoch)
        else:
            if pending_ticks == 0:
                # New-epoch timeout: suspect the target epoch itself.
                suspect = Suspect(epoch=self.my_new_epoch.new_config.config.number)
                return (
                    Actions()
                    .send(self.network_config.nodes, suspect)
                    .concat(self.persisted.add_suspect(suspect))
                )
            if pending_ticks % 2 == 0:
                return self.repeat_epoch_change_broadcast()
        return Actions()

    # --- epoch change / ack flow (reference :484-560) ---

    def apply_epoch_change_msg(self, source: int, msg: EpochChange) -> Actions:
        actions = Actions()
        if source != self.my_config.id:
            # Don't echo our own (we already broadcast/rebroadcast it).
            actions.send(
                self.network_config.nodes,
                EpochChangeAck(originator=source, epoch_change=msg),
            )
        return actions.concat(self.apply_epoch_change_ack_msg(source, source, msg))

    def apply_epoch_change_ack_msg(
        self, source: int, origin: int, msg: EpochChange
    ) -> Actions:
        """Hash the acked epoch change (on the TPU batcher); processing
        resumes in apply_epoch_change_digest (reference :514-528).

        Digest memo: the reference hashes every ack separately — O(N²) per
        node, O(N³) cluster-wide per epoch change.  Acks referencing epoch-
        change content this node has already hashed (or has in flight) skip
        the round-trip: a known digest applies synchronously, an in-flight
        one queues the (source, origin) pair for when the result lands."""
        key = self._ec_key(msg)
        entry = self._ec_digests.get(key)
        if entry is not None:
            if entry[0] is not None:
                return self._apply_ec_digest(source, origin, msg, entry[0])
            entry[1].append((source, origin))
            return Actions()
        self._ec_digests[key] = [None, []]
        return Actions().hash(
            list(key),
            st.EpochChangeOrigin(source=source, origin=origin, epoch_change=msg),
        )

    def _ec_key(self, msg: EpochChange) -> tuple:
        """Content key for the digest memo.  The identity side-table entry
        stores the msg itself, pinning the id for the table's lifetime."""
        # mirlint: allow(id-ordering) — identity side-table lookup; the
        # entry pins msg and is is-checked, never ordered or hashed.
        entry = self._ec_keys.get(id(msg))
        if entry is not None and entry[0] is msg:
            return entry[1]
        key = tuple(epoch_change_hash_data(msg))
        # mirlint: allow(id-ordering) — same identity side-table insert.
        self._ec_keys[id(msg)] = (msg, key)
        return key

    def apply_epoch_change_digest(
        self, origin: st.EpochChangeOrigin, digest: bytes
    ) -> Actions:
        """Reference :534-560, plus draining the digest-memo waiters."""
        msg = origin.epoch_change
        key = self._ec_key(msg)
        entry = self._ec_digests.get(key)
        waiters: list = []
        if entry is not None and entry[0] is None:
            waiters = entry[1]
        self._ec_digests[key] = [digest, []]
        actions = self._apply_ec_digest(origin.source, origin.origin, msg, digest)
        for source, origin_node in waiters:
            actions.concat(
                self._apply_ec_digest(source, origin_node, msg, digest)
            )
        return actions

    def _apply_ec_digest(
        self, source_node: int, origin_node: int, msg: EpochChange, digest: bytes
    ) -> Actions:
        """One ack's digest application (reference :534-560)."""
        votes = self.changes.get(origin_node)
        if votes is None:
            votes = EpochChangeVotes(self.network_config)
            self.changes[origin_node] = votes
        votes.add_ack(source_node, msg, digest)
        if votes.strong_cert is not None and origin_node not in self.strong_changes:
            self.strong_changes[origin_node] = votes.parsed_by_digest[
                votes.strong_cert
            ]
            return self.advance_state()
        return Actions()

    def check_epoch_quorum(self) -> Actions:
        """Reference :564-593.

        Memoized on (leader choice, strong-cert set): entries are added to
        ``strong_changes`` at most once per node (``:561``) and never
        replaced, so the sorted key tuple fingerprints the whole input of
        ``construct_new_epoch`` — a failed construction is not re-derived
        until another strong cert lands (see _ne_construct_key)."""
        if (
            len(self.strong_changes) < intersection_quorum(self.network_config)
            or self.my_epoch_change is None
        ):
            return Actions()
        key = (self.my_leader_choice, tuple(sorted(self.strong_changes)))
        if key == self._ne_construct_key:
            return Actions()
        self.my_new_epoch = self.construct_new_epoch(
            self.my_leader_choice, self.network_config
        )
        if self.my_new_epoch is None:
            self._ne_construct_key = key
            return Actions()
        self.state_ticks = 0
        self.state = EpochTargetState.PENDING
        if self.is_primary:
            return Actions().send(self.network_config.nodes, self.my_new_epoch)
        return Actions()

    def apply_new_epoch_msg(self, msg: NewEpoch) -> Actions:
        self.leader_new_epoch = msg
        return self.advance_state()

    # --- Bracha echo / ready (reference :601-775) ---

    def apply_new_epoch_echo_msg(self, source: int, config: NewEpochConfig) -> Actions:
        self.echos.setdefault(config, set()).add(source)
        return self.advance_state()

    def check_new_epoch_echo_quorum(self) -> Actions:
        """Echo quorum → persist PEntries (the implicit Prepares) + send
        Ready (reference :632-671)."""
        actions = Actions()
        for config, echo_sources in self.echos.items():
            if len(echo_sources) < intersection_quorum(self.network_config):
                continue
            self.state = EpochTargetState.READYING
            for i, digest in enumerate(config.final_preprepares):
                seq_no = i + config.starting_checkpoint.seq_no + 1
                actions.concat(
                    self.persisted.add_p_entry(
                        PEntry(seq_no=seq_no, digest=digest)
                    )
                )
            return actions.send(
                self.network_config.nodes, NewEpochReady(config=config)
            )
        return actions

    def apply_new_epoch_ready_msg(self, source: int, config: NewEpochConfig) -> Actions:
        """Reference :676-738."""
        if self.state > EpochTargetState.READYING:
            return Actions()  # already accepted the config

        readies = self.readies.setdefault(config, set())
        readies.add(source)

        if len(readies) < some_correct_quorum(self.network_config):
            return Actions()

        if self.state < EpochTargetState.ECHOING:
            return self.advance_state()

        if self.state < EpochTargetState.READYING:
            # Weak quorum of readies before a strong quorum of echos
            # (standard Bracha amplification).
            self.state = EpochTargetState.READYING
            return Actions().send(
                self.network_config.nodes, NewEpochReady(config=config)
            )

        return self.advance_state()

    def check_new_epoch_ready_quorum(self) -> None:
        """Ready quorum → accept the config; replay own-epoch-change-window
        QEntries into the commit state (reference :743-775)."""
        for config, readies in self.readies.items():
            if len(readies) < intersection_quorum(self.network_config):
                continue
            self.state = EpochTargetState.RESUMING
            self.network_new_epoch = config

            current_epoch = False
            for _, entry in self.persisted.entries:
                if isinstance(entry, QEntry):
                    if current_epoch:
                        self.commit_state.commit(entry)
                elif isinstance(entry, ECEntry):
                    if entry.epoch_number < config.config.number:
                        continue
                    if config.config.number < entry.epoch_number:
                        raise AssertionError(
                            "epoch change entries cannot exceed the target epoch"
                        )
                    current_epoch = True

    def check_epoch_resumed(self) -> None:
        """Reference :777-792."""
        if self.commit_state.stop_at_seq_no < self.starting_seq_no:
            return  # waiting for the outstanding checkpoint to commit
        if self.commit_state.low_watermark + 1 != self.starting_seq_no:
            return  # waiting for state transfer to initiate/complete
        self.state = EpochTargetState.READY

    # --- driver (reference :797-851) ---

    def advance_state(self) -> Actions:
        # Fast path for the per-event fixpoint: a steady-state epoch with no
        # pending available requests and no window work allocates nothing.
        if self.state == EpochTargetState.IN_PROGRESS:
            ae = self.active_epoch
            if (
                not ae.outstanding_reqs.available_iterator.has_next()
                and not ae.needs_advance()
            ):
                return EMPTY_ACTIONS
        actions = Actions()
        while True:
            old_state = self.state
            if self.state == EpochTargetState.PREPENDING:
                actions.concat(self.check_epoch_quorum())
            elif self.state == EpochTargetState.PENDING:
                if self.leader_new_epoch is None:
                    return actions
                self.state = EpochTargetState.VERIFYING
            elif self.state == EpochTargetState.VERIFYING:
                self.verify_new_epoch_state()
            elif self.state == EpochTargetState.FETCHING:
                actions.concat(self.fetch_new_epoch_state())
            elif self.state == EpochTargetState.ECHOING:
                actions.concat(self.check_new_epoch_echo_quorum())
            elif self.state == EpochTargetState.READYING:
                self.check_new_epoch_ready_quorum()
            elif self.state == EpochTargetState.RESUMING:
                self.check_epoch_resumed()
            elif self.state == EpochTargetState.READY:
                epoch_config = (
                    self.network_new_epoch.config
                    if self.network_new_epoch is not None
                    else self.resume_epoch_config
                )
                if (
                    self.commit_state.low_watermark
                    >= epoch_config.planned_expiration
                ):
                    # The epoch expired while we were down or state
                    # transferring past it: there is no window left to
                    # resume (activating would assert in advance()).  End
                    # it so the tracker rolls to an epoch change — which
                    # targets max_correct_epoch, rejoining the cluster's
                    # current epoch instead of replaying the dead one.
                    self.state = EpochTargetState.DONE
                    continue
                self.active_epoch = ActiveEpoch(
                    epoch_config,
                    self.persisted,
                    self.node_buffers,
                    self.commit_state,
                    self.client_tracker,
                    self.my_config,
                    self.logger,
                )
                actions.concat(self.active_epoch.advance())
                self.state = EpochTargetState.IN_PROGRESS
                for node in self.network_config.nodes:
                    self.prestart_buffers[node].iterate(
                        lambda _nid, _msg: Applyable.CURRENT,  # drain all
                        lambda nid, msg: actions.concat(
                            self.active_epoch.step(nid, msg)
                        ),
                    )
                actions.concat(self.active_epoch.drain_buffers())
            elif self.state == EpochTargetState.IN_PROGRESS:
                # This arm runs in the per-event fixpoint; both calls are
                # no-ops almost always, so gate them on cheap predicates.
                ae = self.active_epoch
                if ae.outstanding_reqs.available_iterator.has_next():
                    actions.concat(ae.outstanding_reqs.advance_requests())
                if ae.needs_advance():
                    actions.concat(ae.advance())
            # ENDING / DONE: nothing to do here
            if self.state == old_state:
                return actions

    def move_low_watermark(self, seq_no: int) -> Actions:
        """Reference :853-865."""
        if self.state != EpochTargetState.IN_PROGRESS:
            return Actions()
        actions, done = self.active_epoch.move_low_watermark(seq_no)
        if done:
            self.state = EpochTargetState.DONE
        return actions

    def apply_suspect_msg(self, source: int) -> None:
        """Suspicion quorum ends the epoch (reference :867-874)."""
        self.suspicions.add(source)
        if len(self.suspicions) >= intersection_quorum(self.network_config):
            self.state = EpochTargetState.DONE
