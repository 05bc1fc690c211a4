"""Client request ACK/dissemination protocol (consensus side).

Rebuild of reference ``pkg/statemachine/client_hash_disseminator.go`` — the
library's request-dissemination departure from the Mir paper
(``docs/Clients.md`` "Client ACKs"): per client × req_no, accumulate
``RequestAck``s; a weak quorum (f+1) marks a request *correct*
(→ CorrectRequest action), a strong quorum (2f+1) marks it *ready to
propose*; conflicting correct requests from a byzantine client are resolved
by promoting the null request; un-replicated correct requests are proactively
fetched with timeouts; own acks are rebroadcast with linear backoff
(reference :507-629).

Hardening vs the reference: a replica's first non-null ack per req_no is
binding — later non-null acks for different digests from the same replica are
ignored (the reference documents this rule at :106-112 but does not enforce it
on the hot ack path, see its ``filter`` TODO at :194).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from .. import _native
from ..messages import (
    AckBatch,
    AckMsg,
    ClientState,
    FetchRequest,
    Msg,
    NetworkConfig,
    NetworkState,
    RequestAck,
)
from ..state import EventInitialParameters
from .actions import EMPTY_ACTIONS, Actions
from .client_tracker import ClientTracker
from .msgbuffers import Applyable, MsgBuffer, NodeBuffers
from .stateless import intersection_quorum, is_committed, some_correct_quorum

CORRECT_FETCH_TICKS = 4
FETCH_TIMEOUT_TICKS = 4
ACK_RESEND_TICKS = 20

# Packed-ack cache for the native ack plane: one AckBatch is delivered to
# every replica (N times in an in-process testengine run), but its packed
# (client_id, digest_id, req_no) representation is identical everywhere, so
# it is computed once per batch object.  Keyed by id() with an identity check
# (the stored strong reference keeps a live entry's id stable; an evicted
# entry whose id gets reused fails the identity check and is recomputed).
_PACK_CACHE: "OrderedDict[int, Tuple[object, bytes]]" = OrderedDict()
_PACK_CAP = 8192


def _packed_acks(batch) -> bytes:
    # mirlint: allow(id-ordering) — identity memo key; the cache entry
    # pins the object and is is-checked before use, never ordered.
    key = id(batch)
    entry = _PACK_CACHE.get(key)
    if entry is not None and entry[0] is batch:
        return entry[1]
    packed = _native.core.pack_acks(batch.acks)
    _PACK_CACHE[key] = (batch, packed)
    if len(_PACK_CACHE) > _PACK_CAP:
        _PACK_CACHE.popitem(last=False)
    return packed


def mask_to_nodes(mask: int) -> Tuple[int, ...]:
    """Replica-id bitmask -> ascending id tuple."""
    return tuple(i for i in range(mask.bit_length()) if (mask >> i) & 1)


class ClientRequest:
    """One (client, req_no, digest) candidate (reference :631-668)."""

    __slots__ = (
        "ack",
        "agreements",
        "stored",
        "fetching",
        "ticks_fetching",
        "ticks_correct",
        "refresh_ref",
    )

    def __init__(self, ack: RequestAck):
        self.ack = ack
        self.agreements = 0  # bitmask of replica ids that acked this digest
        self.stored = False  # persisted locally
        self.fetching = False
        self.ticks_fetching = 0
        self.ticks_correct = 0
        # (plane, client_id, req_no) when the native ack plane is
        # accumulating votes for this (canonical-digest) request; consulted
        # by refresh() at the few sites that read a live agreement mask.
        self.refresh_ref = None

    def refresh(self) -> int:
        """Merge any native-plane votes into ``agreements`` and return it."""
        ref = self.refresh_ref
        if ref is not None:
            plane, client_id, req_no = ref
            state = plane.peek(client_id, req_no)
            if state is None:
                self.refresh_ref = None  # ejected or out of window
            else:
                self.agreements |= int.from_bytes(state[1], "little")
        return self.agreements

    def fetch(self) -> Actions:
        if self.fetching:
            return Actions()
        self.fetching = True
        self.ticks_fetching = 0
        return Actions().send(
            mask_to_nodes(self.refresh()), FetchRequest(ack=self.ack)
        )


class ClientReqNo:
    """Ack accumulation for one (client, req_no) (reference :339-629)."""

    __slots__ = (
        "my_config",
        "network_config",
        "client_id",
        "req_no",
        "valid_after_seq_no",
        "non_null_voters",
        "requests",
        "weak_requests",
        "strong_requests",
        "my_requests",
        "committed",
        "acks_sent",
        "acked_digest",
        "resend_nonce",
    )

    def __init__(
        self,
        my_config: EventInitialParameters,
        client_id: int,
        req_no: int,
        network_config: NetworkConfig,
        valid_after_seq_no: int,
    ):
        self.my_config = my_config
        self.client_id = client_id
        self.req_no = req_no
        self.network_config = network_config
        self.valid_after_seq_no = valid_after_seq_no
        self.non_null_voters = 0  # bitmask of replicas that voted non-null
        self.requests: Dict[bytes, ClientRequest] = {}  # all observed
        self.weak_requests: Dict[bytes, ClientRequest] = {}  # correct
        self.strong_requests: Dict[bytes, ClientRequest] = {}  # proposable
        self.my_requests: Dict[bytes, ClientRequest] = {}  # locally persisted
        self.committed = False
        self.acks_sent = 0
        self.acked_digest: Optional[bytes] = None  # digest our ack endorsed
        self.resend_nonce = 0  # invalidates stale resend-schedule entries

    def reinitialize(
        self, network_config: NetworkConfig, same_config: Optional[bool] = None
    ) -> None:
        """Re-derive quorum sets under a (possibly changed) config
        (reference :371-408).  ``same_config`` lets the caller hoist the
        config comparison out of the per-slot loop."""
        if same_config is None:
            same_config = network_config == self.network_config
        if same_config:
            # Graceful epoch rotation under an unchanged config: the same
            # node set and quorum thresholds re-derive the same agreement
            # masks and weak/strong/my sets, so the rebuild below is an
            # identity on them.  Only the per-candidate fetch state resets
            # (the rebuild drops it by constructing fresh ClientRequests).
            for req in self.requests.values():
                req.fetching = False
                req.ticks_fetching = 0
                req.ticks_correct = 0
            return
        self.network_config = network_config
        old_requests = self.requests
        self.non_null_voters = 0
        self.requests = {}
        self.weak_requests = {}
        self.strong_requests = {}
        self.my_requests = {}

        for digest in sorted(old_requests):
            old_req = old_requests[digest]
            for node in network_config.nodes:
                if (old_req.agreements >> node) & 1:
                    self._apply_request_ack(node, old_req.ack)
            if old_req.stored:
                new_req = self.client_req(old_req.ack)
                new_req.stored = True
                self.my_requests[digest] = new_req

    def client_req(self, ack: RequestAck) -> ClientRequest:
        digest_key = ack.digest  # null request → b""
        req = self.requests.get(digest_key)
        if req is None:
            req = ClientRequest(ack)
            self.requests[digest_key] = req
        return req

    def apply_new_request(self, ack: RequestAck) -> None:
        """A request body was persisted locally (reference :431-443)."""
        if ack.digest in self.my_requests:
            return  # race between a forward and a local proposal
        req = self.client_req(ack)
        req.stored = True
        self.my_requests[ack.digest] = req

    def generate_ack(self) -> Optional[Msg]:
        """Reference :445-479."""
        if not self.my_requests:
            return None
        if len(self.my_requests) == 1:
            self.acks_sent = 1
            (req,) = self.my_requests.values()
            self.acked_digest = req.ack.digest
            return AckMsg(ack=req.ack)

        # Multiple locally-known requests: ack the null request.
        null_ack = RequestAck(client_id=self.client_id, req_no=self.req_no, digest=b"")
        null_req = self.client_req(null_ack)
        null_req.stored = True
        self.my_requests[b""] = null_req
        self.acks_sent = 1
        self.acked_digest = b""
        return AckMsg(ack=null_ack)

    def _apply_request_ack(self, source: int, ack: RequestAck) -> None:
        """Quorum bookkeeping used during reinitialize (reference :481-505)."""
        if ack.digest:
            self.non_null_voters |= 1 << source
        req = self.client_req(ack)
        req.agreements |= 1 << source
        count = req.agreements.bit_count()
        if count < some_correct_quorum(self.network_config):
            return
        self.weak_requests[ack.digest] = req
        if count < intersection_quorum(self.network_config):
            return
        self.strong_requests[ack.digest] = req

    def needs_attention(self) -> bool:
        """Whether the per-tick scan (attention_tick) has work or counters to
        advance for this req-no.  Mirrors exactly the conditions under which
        the reference's per-req-no tick body (reference :507-629) mutates
        state: a pending null promotion, a proactive-fetch countdown, or an
        in-flight fetch timing out.  Ack-rebroadcast backoff is NOT included —
        it is handled by the client's resend schedule."""
        wr = self.weak_requests
        if not wr:
            return False
        if len(wr) == 1:
            (req,) = wr.values()
            if req.fetching:
                return True  # fetch-timeout counting
            return not req.stored  # counting down to a proactive fetch
        if b"" not in self.my_requests:
            return True  # null promotion pending
        for req in wr.values():
            if req.fetching:
                return True  # fetch-timeout counting
        return False

    def attention_tick(self, actions: Actions) -> bool:
        """Null-promotion, proactive fetch, and fetch retry — the per-tick
        body of reference :507-614, minus ack rebroadcast (scheduled by the
        owning Client).  Returns True when a null promotion fired (the client
        must then schedule the promoted ack's first rebroadcast)."""
        promoted = False

        # 1. Conflicting correct requests and no null yet -> promote null.
        if b"" not in self.my_requests and len(self.weak_requests) > 1:
            null_ack = RequestAck(
                client_id=self.client_id, req_no=self.req_no, digest=b""
            )
            null_req = self.client_req(null_ack)
            null_req.stored = True
            self.my_requests[b""] = null_req
            self.acks_sent = 1
            self.acked_digest = b""
            promoted = True
            actions.send(self.network_config.nodes, AckMsg(ack=null_ack)).correct_request(
                null_ack
            )

        # 2. Exactly one correct request we don't hold -> proactively fetch.
        if len(self.weak_requests) == 1:
            (req,) = self.weak_requests.values()
            if not req.stored and not req.fetching:
                if req.ticks_correct <= CORRECT_FETCH_TICKS:
                    req.ticks_correct += 1
                else:
                    actions.concat(req.fetch())

        # 3. Fetches that timed out -> retry (deterministic digest order).
        to_fetch: Optional[List[ClientRequest]] = None
        for req in self.weak_requests.values():
            if not req.fetching:
                continue
            if req.ticks_fetching <= FETCH_TIMEOUT_TICKS:
                req.ticks_fetching += 1
                continue
            req.fetching = False
            if to_fetch is None:
                to_fetch = []
            to_fetch.append(req)
        if to_fetch is not None:
            to_fetch.sort(key=lambda r: r.ack.digest, reverse=True)
            for req in to_fetch:
                actions.concat(req.fetch())

        return promoted


class Client:
    """Watermark window of ClientReqNos for one client (reference :670-904)."""

    __slots__ = (
        "my_config",
        "logger",
        "network_config",
        "client_state",
        "client_tracker",
        "high_watermark",
        "next_ready_mark",
        "next_ack_mark",
        "req_nos",
        "tick_count",
        "attention",
        "resend_schedule",
        "resend_seq",
        "weak_quorum",
        "strong_quorum",
    )

    def __init__(self, my_config: EventInitialParameters, tracker: ClientTracker, logger=None):
        self.my_config = my_config
        self.logger = logger
        self.client_tracker = tracker
        self.network_config: Optional[NetworkConfig] = None
        self.client_state: Optional[ClientState] = None
        self.high_watermark = 0
        self.next_ready_mark = 0
        self.next_ack_mark = 0
        self.req_nos: Dict[int, ClientReqNo] = {}  # insertion-ordered window
        # Tick machinery: instead of scanning every in-window req-no each
        # tick (O(window) per tick per client, reference :507-629), req-nos
        # that have per-tick work register in `attention`, and ack
        # rebroadcasts are scheduled by absolute tick number with a per-crn
        # nonce guarding stale entries.  Observable behavior (which tick a
        # given action fires on) is identical to the reference's counters.
        self.tick_count = 0
        self.attention: Set[int] = set()
        self.resend_schedule: Dict[int, List[Tuple[int, int]]] = {}
        # Nonces are unique across the client's lifetime so a schedule entry
        # left by a dropped ClientReqNo can never match a later incarnation
        # of the same req_no.
        self.resend_seq = 0
        self.weak_quorum = 0  # f+1, cached at (re)initialization
        self.strong_quorum = 0  # (n+f+2)//2, cached at (re)initialization

    def reinitialize(
        self,
        seq_no: int,
        network_config: NetworkConfig,
        client_state: ClientState,
        reconfiguring: bool,
    ) -> Actions:
        """Reference :692-743."""
        actions = Actions()
        self.weak_quorum = some_correct_quorum(network_config)
        self.strong_quorum = intersection_quorum(network_config)
        old_req_nos = self.req_nos
        old_config = self.network_config

        # Window is exactly `width` slots, [lw, lw+width-1]; the portion
        # usable before the next checkpoint excludes what the previous
        # checkpoint consumed.  (The reference exposes one extra slot here —
        # see stateless.is_committed docstring.)
        intermediate_high = (
            client_state.low_watermark
            + client_state.width
            - client_state.width_consumed_last_checkpoint
            - 1
        )
        self.network_config = network_config
        self.client_state = client_state
        self.high_watermark = (
            client_state.low_watermark + client_state.width - 1
            if not reconfiguring
            else intermediate_high
        )
        self.next_ready_mark = client_state.low_watermark
        if self.next_ack_mark < client_state.low_watermark:
            self.next_ack_mark = client_state.low_watermark
        self.req_nos = {}

        same_config = network_config == old_config
        for req_no in range(client_state.low_watermark, self.high_watermark + 1):
            crn = old_req_nos.get(req_no)
            if crn is None:
                valid_after = (
                    seq_no + network_config.checkpoint_interval
                    if req_no > intermediate_high
                    else seq_no
                )
                crn = ClientReqNo(
                    self.my_config,
                    client_state.id,
                    req_no,
                    network_config,
                    valid_after,
                )
                actions.allocate_request(client_state.id, req_no)
            crn.committed = is_committed(req_no, client_state)
            crn.reinitialize(network_config, same_config)
            self.req_nos[req_no] = crn

        self.attention = {
            rn
            for rn, crn in self.req_nos.items()
            if not crn.committed and crn.needs_attention()
        }
        self.advance_ready()
        return actions

    def allocate(
        self, seq_no: int, state: ClientState, reconfiguring: bool
    ) -> Actions:
        """Roll the window forward after a checkpoint (reference :745-804)."""
        actions = Actions()
        intermediate_high = (
            state.low_watermark
            + state.width
            - state.width_consumed_last_checkpoint
            - 1
        )
        if intermediate_high != self.high_watermark:
            raise AssertionError(
                "new intermediate high watermark must equal the old high "
                f"watermark for client {state.id}"
            )
        new_high = (
            state.low_watermark + state.width - 1
            if not reconfiguring
            else intermediate_high
        )

        if state.low_watermark > self.next_ready_mark:
            # A request we never saw as ready may have committed as correct.
            self.next_ready_mark = state.low_watermark
        if state.low_watermark > self.next_ack_mark:
            self.next_ack_mark = state.low_watermark

        for req_no in list(self.req_nos):
            if req_no == state.low_watermark:
                break
            del self.req_nos[req_no]

        for req_no in range(state.low_watermark, self.high_watermark + 1):
            if is_committed(req_no, state):
                self.req_nos[req_no].committed = True

        self.client_state = state

        valid_after = seq_no + self.network_config.checkpoint_interval
        for req_no in range(intermediate_high + 1, new_high + 1):
            actions.allocate_request(state.id, req_no)
            self.req_nos[req_no] = ClientReqNo(
                self.my_config, state.id, req_no, self.network_config, valid_after
            )

        self.high_watermark = new_high
        self.advance_ready()
        return actions

    def ack(self, source: int, ack: RequestAck, force: bool = False) -> Tuple[Actions, ClientRequest]:
        actions = Actions()
        cr = self.ack_into(actions, source, ack, force=force)
        return actions, cr

    def ack_into(
        self, actions: Actions, source: int, ack: RequestAck, force: bool = False
    ) -> ClientRequest:
        """Record a replica's ack; drive correct/available/ready transitions
        (reference :806-840).  Appends into the caller's accumulator — this
        is the per-ack hot loop (O(N^2) calls per request across the
        cluster), so per-call allocations are kept off it."""
        crn = self.req_nos.get(ack.req_no)
        if crn is None:
            raise AssertionError(
                f"client {ack.client_id} ack for req_no {ack.req_no} outside "
                f"watermarks [{self.client_state.low_watermark}, "
                f"{self.high_watermark}]"
            )

        # First-non-null-ack-is-binding rule (see module docstring): a replica
        # that already voted for a different non-null digest is ignored unless
        # the digest is known-correct (force).
        bit = 1 << source
        if ack.digest and not force:
            existing = crn.requests.get(ack.digest)
            already_voted_this = existing is not None and existing.agreements & bit
            if crn.non_null_voters & bit and not already_voted_this:
                return crn.client_req(ack)

        if ack.digest:
            crn.non_null_voters |= bit

        cr = crn.client_req(ack)
        cr.agreements |= bit
        agreement_count = cr.agreements.bit_count()

        newly_correct = agreement_count == self.weak_quorum
        if newly_correct:
            crn.weak_requests[ack.digest] = cr
            if not cr.stored:
                actions.correct_request(ack)
            # Attention membership only changes when the weak set changes
            # (stored/fetching/my_requests are not touched on this path).
            self._update_attention(crn)

        if cr.stored and (
            newly_correct
            or (agreement_count >= self.weak_quorum and source == self.my_config.id)
        ):
            self.client_tracker.add_available(ack)

        if agreement_count == self.strong_quorum:
            crn.strong_requests[ack.digest] = cr
            self.advance_ready()

        return cr

    def ack_run(
        self, actions: Actions, source: int, acks: List[RequestAck], start: int
    ) -> int:
        """Apply a run of in-window acks from one source for this client,
        beginning at ``acks[start]``; returns the index after the run.

        Semantically a loop of ack_into; the common case (non-null digest,
        source not previously bound elsewhere, no quorum crossing) is inlined
        with hoisted locals because at N replicas this loop runs O(N²) times
        per request cluster-wide."""
        req_nos = self.req_nos
        bit = 1 << source
        weak_q = self.weak_quorum
        strong_q = self.strong_quorum
        low = self.client_state.low_watermark
        high = self.high_watermark
        client_id = acks[start].client_id
        n = len(acks)
        i = start
        while i < n:
            ack = acks[i]
            if ack.client_id != client_id:
                break
            req_no = ack.req_no
            if req_no < low or req_no > high:
                break
            i += 1
            digest = ack.digest
            crn = req_nos.get(req_no)
            if digest and crn.non_null_voters & bit:
                existing = crn.requests.get(digest)
                if existing is None:
                    # Bound to a different digest: vote ignored, but the
                    # candidate is still registered (as in ack_into).
                    crn.requests[digest] = ClientRequest(ack)
                    continue
                if not existing.agreements & bit:
                    continue  # bound to a different digest: ignored
                cr = existing
            else:
                if digest:
                    crn.non_null_voters |= bit
                cr = crn.requests.get(digest)
                if cr is None:
                    cr = ClientRequest(ack)
                    crn.requests[digest] = cr
            votes = cr.agreements | bit
            cr.agreements = votes
            count = votes.bit_count()
            if count < weak_q:
                continue
            # Quorum-relevant tail: rare, shared with ack_into's logic.
            newly_correct = count == weak_q
            if newly_correct:
                crn.weak_requests[digest] = cr
                if not cr.stored:
                    actions.correct_request(ack)
                self._update_attention(crn)
            if cr.stored and (newly_correct or source == self.my_config.id):
                self.client_tracker.add_available(ack)
            if count == strong_q:
                crn.strong_requests[digest] = cr
                self.advance_ready()
        return i

    def in_watermarks(self, req_no: int) -> bool:
        return self.client_state.low_watermark <= req_no <= self.high_watermark

    def req_no(self, req_no: int) -> ClientReqNo:
        crn = self.req_nos.get(req_no)
        if crn is None:
            raise AssertionError(
                f"client {self.client_state.id} should have req_no {req_no}"
            )
        return crn

    def advance_ready(self) -> None:
        """Reference :852-876."""
        for i in range(self.next_ready_mark, self.high_watermark + 1):
            if i != self.next_ready_mark:
                return  # previous iteration failed to advance
            crn = self.req_no(i)
            if crn.committed:
                self.next_ready_mark = i + 1
                continue
            for digest in crn.strong_requests:
                if digest not in crn.my_requests:
                    continue
                self.client_tracker.add_ready(crn)
                self.next_ready_mark = i + 1
                break

    def advance_acks(self) -> List[RequestAck]:
        """Reference :878-895 — returns the freshly generated acks instead
        of broadcasting them: the disseminator's flush_acks merges acks
        across ALL dirty clients into one AckBatch per event batch (the
        reference broadcasts one AckMsg per ack; one batch per client was
        the first aggregation step, cross-client coalescing the second)."""
        acks: List[RequestAck] = []
        for i in range(self.next_ack_mark, self.high_watermark + 1):
            crn = self.req_no(i)
            ack_msg = crn.generate_ack()
            if ack_msg is None:
                break
            acks.append(ack_msg.ack)
            # First rebroadcast is due after ACK_RESEND_TICKS full ticks have
            # elapsed, firing on the tick after (reference backoff counter
            # semantics, :614-629).
            self._schedule_resend(crn, self.tick_count + ACK_RESEND_TICKS + 1)
            self._update_attention(crn)
            self.next_ack_mark = i + 1
        return acks

    def _update_attention(self, crn: ClientReqNo) -> None:
        if not crn.committed and crn.needs_attention():
            self.attention.add(crn.req_no)
        else:
            self.attention.discard(crn.req_no)

    def _schedule_resend(self, crn: ClientReqNo, due_tick: int) -> None:
        self.resend_seq += 1
        crn.resend_nonce = self.resend_seq
        self.resend_schedule.setdefault(due_tick, []).append(
            (crn.req_no, crn.resend_nonce)
        )

    def apply_new_request(self, ack: RequestAck) -> None:
        crn = self.req_no(ack.req_no)
        crn.apply_new_request(ack)
        self._update_attention(crn)

    def note_fetching(self, ack: RequestAck) -> None:
        """A fetch was initiated outside the tick path (epoch-change request
        recovery): make sure its timeout counting is attended to."""
        crn = self.req_nos.get(ack.req_no)
        if crn is not None:
            self._update_attention(crn)

    def tick(self, actions: Actions) -> None:
        self.tick_count += 1

        if self.attention:
            for rn in sorted(self.attention):
                crn = self.req_nos.get(rn)
                if crn is None or crn.committed:
                    self.attention.discard(rn)
                    continue
                if crn.attention_tick(actions):
                    # Null promotion counts its first backoff window from
                    # this very tick (the reference increments the fresh
                    # counter in the same tick body, :614-617).
                    self._schedule_resend(
                        crn, self.tick_count + ACK_RESEND_TICKS
                    )
                self._update_attention(crn)

        resend: List[RequestAck] = []
        due = self.resend_schedule.pop(self.tick_count, None)
        if due:
            for rn, nonce in due:
                crn = self.req_nos.get(rn)
                if crn is None or crn.committed or crn.resend_nonce != nonce:
                    continue
                req = crn.my_requests.get(crn.acked_digest)
                if req is None:
                    raise AssertionError(
                        "sent an ack for a request we do not have"
                    )
                ack = req.ack
                crn.acks_sent += 1
                resend.append(ack)
                self._schedule_resend(
                    crn,
                    self.tick_count + crn.acks_sent * ACK_RESEND_TICKS + 1,
                )
        if len(resend) == 1:
            actions.send(self.network_config.nodes, AckMsg(ack=resend[0]))
        elif resend:
            actions.send(self.network_config.nodes, AckBatch(acks=tuple(resend)))


class ClientHashDisseminator:
    """Reference :121-321."""

    __slots__ = (
        "logger",
        "my_config",
        "node_buffers",
        "allocated_through",
        "network_config",
        "client_states",
        "msg_buffers",
        "clients",
        "client_tracker",
        "plane",
        "_mask_bytes",
        "_ack_dirty",
        "coalesce_acks",
    )

    def __init__(
        self,
        node_buffers: NodeBuffers,
        my_config: EventInitialParameters,
        client_tracker: ClientTracker,
        logger=None,
    ):
        self.logger = logger
        self.my_config = my_config
        self.node_buffers = node_buffers
        self.client_tracker = client_tracker
        self.allocated_through = 0
        self.network_config: Optional[NetworkConfig] = None
        self.client_states: Tuple[ClientState, ...] = ()
        self.msg_buffers: Dict[int, MsgBuffer] = {}
        self.clients: Dict[int, Client] = {}
        # Native ack-vote plane (mirbft_tpu_torch/_native): owns green-path vote
        # accumulation; None when the extension is unavailable/disabled.
        self.plane = None
        self._mask_bytes = 0
        # Clients with persisted-but-not-yet-acked requests; drained by
        # flush_acks() at each event-batch boundary (EventActionsReceived),
        # which coalesces every dirty client's acks into one AckBatch per
        # processing batch instead of one broadcast per persisted request
        # (or per client).  False restores the per-client shape for the
        # differential test.
        self._ack_dirty: Set[int] = set()
        self.coalesce_acks = True

    def reinitialize(self, seq_no: int, network_state: NetworkState) -> Actions:
        """Reference :143-180."""
        actions = Actions()
        reconfiguring = bool(network_state.pending_reconfigurations)

        # Unchanged config + client set (the graceful epoch-rotation case):
        # the per-req-no rebuild is an identity on vote state, so the native
        # plane keeps ownership and only the windows are re-based.  Otherwise
        # fold the native votes back into Python before the rebuild
        # re-derives quorum sets from them, and build a fresh plane after.
        keep_plane = (
            self.plane is not None
            and self.network_config == network_state.config
            and tuple(cs.id for cs in self.client_states)
            == tuple(cs.id for cs in network_state.clients)
        )
        if not keep_plane:
            # Fold any native-plane vote state back into the Python objects
            # before the Python-side rebuild re-derives quorum sets from them.
            self._sync_all_from_plane()

        self.allocated_through = seq_no
        self.network_config = network_state.config

        old_clients = self.clients
        self.clients = {}
        self.client_states = network_state.clients
        for client_state in self.client_states:
            client = old_clients.get(client_state.id)
            if client is None:
                client = Client(self.my_config, self.client_tracker, self.logger)
            self.clients[client_state.id] = client
            actions.concat(
                client.reinitialize(
                    seq_no, network_state.config, client_state, reconfiguring
                )
            )

        old_msg_buffers = self.msg_buffers
        self.msg_buffers = {}
        for node in network_state.config.nodes:
            buffer = old_msg_buffers.get(node)
            if buffer is None:
                buffer = MsgBuffer("clients", self.node_buffers.node_buffer(node))
            self.msg_buffers[node] = buffer

        if keep_plane:
            plane = self.plane
            for client_state in self.client_states:
                client = self.clients[client_state.id]
                plane.set_client(
                    client_state.id,
                    client.client_state.low_watermark,
                    client.high_watermark,
                )
        else:
            self._rebuild_plane()
        return actions

    # --- native ack plane lifecycle -------------------------------------

    def _sync_all_from_plane(self) -> None:
        """Merge every live native slot's votes into the Python objects
        (without marking anything ejected — used before a full rebuild,
        which discards the plane anyway)."""
        plane = self.plane
        if plane is None:
            return
        for client_id, client in self.clients.items():
            for req_no, digest_id, mask_b, _count in plane.export_client(
                client_id
            ):
                crn = client.req_nos.get(req_no)
                if crn is None:
                    continue
                self._merge_state(client_id, crn, digest_id, mask_b, None)
        self.plane = None

    def _merge_state(
        self, client_id: int, crn: ClientReqNo, digest_id: int, mask_b: bytes,
        refresh_ref,
    ) -> "ClientRequest":
        digest = _native.core.digest_bytes(digest_id)
        ack = RequestAck(client_id=client_id, req_no=crn.req_no, digest=digest)
        cr = crn.client_req(ack)
        mask = int.from_bytes(mask_b, "little")
        cr.agreements |= mask
        cr.refresh_ref = refresh_ref
        crn.non_null_voters |= mask
        return cr

    def _rebuild_plane(self) -> None:
        """Create a fresh plane for the (possibly changed) config and
        re-import every green-path slot (single non-null digest candidate,
        no null candidate); everything else is marked ejected and handled
        by the pure-Python path."""
        if not _native.available:
            self.plane = None
            return
        config = self.network_config
        n_nodes = max(config.nodes) + 1
        plane = _native.core.AckPlane(
            n_nodes,
            self.my_config.id,
            some_correct_quorum(config),
            intersection_quorum(config),
        )
        self._mask_bytes = ((n_nodes + 63) // 64) * 8
        for client_state in self.client_states:
            client_id = client_state.id
            client = self.clients[client_id]
            plane.set_client(
                client_id, client.client_state.low_watermark, client.high_watermark
            )
            for req_no, crn in client.req_nos.items():
                if b"" in crn.requests:
                    plane.mark_ejected(client_id, req_no)
                    continue
                non_null = [(d, r) for d, r in crn.requests.items() if d]
                if len(non_null) > 1:
                    plane.mark_ejected(client_id, req_no)
                    continue
                if not non_null:
                    continue  # untouched slot: native starts fresh
                digest, cr = non_null[0]
                if plane.import_slot(
                    client_id,
                    req_no,
                    digest,
                    cr.agreements.to_bytes(self._mask_bytes, "little"),
                    cr.agreements.bit_count(),
                ):
                    cr.refresh_ref = (plane, client_id, req_no)
                else:  # digest not internable (table at capacity)
                    plane.mark_ejected(client_id, req_no)
        self.plane = plane

    def _eject_reqno(self, client: "Client", req_no: int) -> None:
        """Hand a (client, req_no) back to the pure-Python path: merge the
        native votes into the Python objects and mark the slot ejected so
        every later ack for it falls through to Python."""
        state = self.plane.eject(client.client_state.id, req_no)
        if state is None:
            return
        digest_id, mask_b, _count = state
        crn = client.req_nos.get(req_no)
        if crn is not None and digest_id >= 0:
            cr = self._merge_state(
                client.client_state.id, crn, digest_id, mask_b, None
            )
            cr.refresh_ref = None

    def _peek_merge(self, client: "Client", crn: ClientReqNo) -> None:
        """Snapshot-merge native votes into Python (read-only sites:
        fetch replies, status introspection); the plane stays the owner."""
        plane = self.plane
        if plane is None:
            return
        client_id = client.client_state.id
        state = plane.peek(client_id, crn.req_no)
        if state is None:
            return
        digest_id, mask_b, _count = state
        self._merge_state(
            client_id, crn, digest_id, mask_b, (plane, client_id, crn.req_no)
        )

    def sync_for_introspection(self) -> None:
        """Make Python-side vote state current for status()/debugging."""
        if self.plane is None:
            return
        for client in self.clients.values():
            for crn in client.req_nos.values():
                self._peek_merge(client, crn)

    def _pyfall_ack(self, actions: Actions, source: int, ack: RequestAck) -> None:
        """Classification + application for an ack the native plane refused
        (unknown client, out of window, null digest, conflicting digest, or
        ejected slot) — mirrors the legacy AckBatch classification."""
        client = self.clients.get(ack.client_id)
        if client is None:
            self.msg_buffers[source].store(AckMsg(ack=ack))  # FUTURE
            return
        if client.client_state.low_watermark > ack.req_no:
            return  # PAST
        if client.high_watermark < ack.req_no:
            self.msg_buffers[source].store(AckMsg(ack=ack))  # FUTURE
            return
        self._eject_reqno(client, ack.req_no)
        client.ack_into(actions, source, ack)

    def _native_crossing(
        self,
        actions: Actions,
        source: int,
        client: "Client",
        req_no: int,
        digest_id: int,
        count: int,
        mask_b: bytes,
    ) -> None:
        """Replay of the quorum tail of Client.ack_into/ack_run for a
        crossing detected natively.  The conditions and action order are
        exactly the Python path's; the native plane guarantees records are
        emitted precisely when count == weak_q, count == strong_q, or
        source == my_id with count >= weak_q (duplicates included — a
        duplicate vote arriving while the count sits at a threshold re-runs
        the tail in the reference semantics too)."""
        crn = client.req_nos[req_no]
        digest = _native.core.digest_bytes(digest_id)
        cr = crn.requests.get(digest)
        if cr is None:
            cr = ClientRequest(
                RequestAck(
                    client_id=client.client_state.id,
                    req_no=req_no,
                    digest=digest,
                )
            )
            crn.requests[digest] = cr
        mask = int.from_bytes(mask_b, "little")
        cr.agreements |= mask
        crn.non_null_voters |= mask
        if cr.refresh_ref is None:
            cr.refresh_ref = (self.plane, client.client_state.id, req_no)
        # cr.ack is value-identical to the received ack (same client/req_no,
        # and cr is keyed by the canonical digest).
        ack = cr.ack
        newly_correct = count == client.weak_quorum
        if newly_correct:
            crn.weak_requests[digest] = cr
            if not cr.stored:
                actions.correct_request(ack)
            # Inlined _update_attention: with exactly one weak candidate and
            # no null candidate (guaranteed on a native-owned slot),
            # needs_attention reduces to (not stored) or fetching.
            if not crn.committed and (not cr.stored or cr.fetching):
                client.attention.add(req_no)
            else:
                client.attention.discard(req_no)
        if cr.stored and (newly_correct or source == self.my_config.id):
            client.client_tracker.add_available(ack)
        if count == client.strong_quorum:
            crn.strong_requests[digest] = cr
            client.advance_ready()

    def tick(self) -> Actions:
        actions = Actions()
        for client_state in self.client_states:
            self.clients[client_state.id].tick(actions)
        return actions

    def filter(self, _source: int, msg: Msg) -> Applyable:
        """Reference :191-213."""
        if isinstance(msg, AckMsg):
            ack = msg.ack
            client = self.clients.get(ack.client_id)
            if client is None:
                return Applyable.FUTURE
            if client.client_state.low_watermark > ack.req_no:
                return Applyable.PAST
            if client.high_watermark < ack.req_no:
                return Applyable.FUTURE
            return Applyable.CURRENT
        if isinstance(msg, FetchRequest):
            return Applyable.CURRENT
        raise AssertionError(f"unexpected client message type {type(msg).__name__}")

    def step(self, source: int, msg: Msg) -> Actions:
        if isinstance(msg, AckBatch):
            plane = self.plane
            if plane is not None:
                # Native fast path: the whole batch is applied in C against
                # packed vote bitmasks; only quorum crossings and acks the
                # plane refuses come back, in original ack order, and are
                # replayed through the exact Python semantics.
                actions = Actions()
                acks = msg.acks
                for rec in plane.apply_batch(_packed_acks(msg), source):
                    if len(rec) == 1:
                        self._pyfall_ack(actions, source, acks[rec[0]])
                    else:
                        _idx, cid, req_no, did, count, mask_b = rec
                        self._native_crossing(
                            actions, source, self.clients[cid], req_no,
                            did, count, mask_b,
                        )
                return actions
            # Per-ack classification: a batch may straddle a window boundary.
            # PAST acks are dropped, FUTURE acks are buffered individually
            # (so later buffer iteration applies them one by one, exactly as
            # if they had arrived as single AckMsgs), CURRENT acks apply now.
            # Classification is inlined (same logic as filter's AckMsg arm):
            # this is the cluster's hottest message path.
            actions = Actions()
            clients = self.clients
            acks = msg.acks
            n = len(acks)
            i = 0
            while i < n:
                ack = acks[i]
                client = clients.get(ack.client_id)
                if client is None:
                    self.msg_buffers[source].store(AckMsg(ack=ack))  # FUTURE
                    i += 1
                    continue
                req_no = ack.req_no
                if client.client_state.low_watermark > req_no:
                    i += 1
                    continue  # PAST
                if client.high_watermark < req_no:
                    self.msg_buffers[source].store(AckMsg(ack=ack))  # FUTURE
                    i += 1
                    continue
                # In-window: hand the whole same-client in-window run to the
                # client's inlined loop.
                i = client.ack_run(actions, source, acks, i)
            return actions
        if isinstance(msg, AckMsg) and self.plane is not None:
            ack = msg.ack
            result = self.plane.apply_one(
                ack.client_id, ack.req_no, ack.digest, source
            )
            actions = Actions()
            if type(result) is tuple:
                count, did, mask_b = result
                self._native_crossing(
                    actions, source, self.clients[ack.client_id], ack.req_no,
                    did, count, mask_b,
                )
            elif result == 1:  # plane refused: classify + apply in Python
                self._pyfall_ack(actions, source, ack)
            # result 0 (applied, no crossing) / 2 (past, dropped): no actions
            return actions
        verdict = self.filter(source, msg)
        if verdict == Applyable.PAST:
            return Actions()
        if verdict == Applyable.FUTURE:
            self.msg_buffers[source].store(msg)
            return Actions()
        return self.apply_msg(source, msg)

    def apply_msg(self, source: int, msg: Msg) -> Actions:
        if isinstance(msg, AckMsg):
            actions, _ = self.ack(source, msg.ack)
            return actions
        if isinstance(msg, FetchRequest):
            ack = msg.ack
            return self.reply_fetch_request(
                source, ack.client_id, ack.req_no, ack.digest
            )
        raise AssertionError(f"unexpected client message type {type(msg).__name__}")

    def apply_new_request(self, ack: RequestAck) -> Actions:
        """EventRequestPersisted: our processor persisted a request body
        (reference :242-257).  Ack generation is deferred to flush_acks()
        at the event-batch boundary so acks for all requests persisted in
        one batch broadcast as one AckBatch per client."""
        client = self.clients.get(ack.client_id)
        if client is None:
            return Actions()  # client removed since the request was processed
        if not client.in_watermarks(ack.req_no):
            return Actions()  # already committed
        client.apply_new_request(ack)
        self._ack_dirty.add(ack.client_id)
        return Actions()

    def flush_acks(self) -> Actions:
        """Generate deferred ack broadcasts (deterministic client order).

        All dirty clients' fresh acks coalesce into ONE AckBatch per flush
        — one broadcast per event batch instead of one per client.  The
        receive side classifies per ack (step's AckBatch arm), so
        cross-client batches need no special handling there.  Setting
        ``coalesce_acks=False`` restores the one-batch-per-client shape
        (the differential test pins the two to identical client state)."""
        if not self._ack_dirty:
            return Actions()
        actions = Actions()
        merged: List[RequestAck] = []
        for client_id in sorted(self._ack_dirty):
            client = self.clients.get(client_id)
            if client is None:
                continue
            acks = client.advance_acks()
            if self.coalesce_acks:
                merged.extend(acks)
            elif acks:
                self._send_acks(actions, acks)
        self._ack_dirty.clear()
        if merged:
            self._send_acks(actions, merged)
        return actions

    def _send_acks(self, actions: Actions, acks: List[RequestAck]) -> None:
        if len(acks) == 1:
            actions.send(self.network_config.nodes, AckMsg(ack=acks[0]))
        else:
            actions.send(self.network_config.nodes, AckBatch(acks=tuple(acks)))

    def allocate(self, seq_no: int, network_state: NetworkState) -> Actions:
        """Advance client windows after a checkpoint (reference :260-278)."""
        if seq_no != network_state.config.checkpoint_interval + self.allocated_through:
            raise AssertionError(
                "unexpected skip in allocate; expected next allocation at "
                "next checkpoint"
            )
        actions = Actions()
        self.allocated_through = seq_no
        reconfiguring = bool(network_state.pending_reconfigurations)
        plane = self.plane
        for client_state in network_state.clients:
            client = self.clients[client_state.id]
            actions.concat(client.allocate(seq_no, client_state, reconfiguring))
            if plane is not None:
                # Roll the native window with the Python one: the overlap
                # keeps its votes, dropped slots are GC'd, new slots empty.
                plane.set_client(
                    client_state.id,
                    client_state.low_watermark,
                    client.high_watermark,
                )
        for node in self.network_config.nodes:
            self.msg_buffers[node].iterate(
                self.filter,
                lambda source, msg: actions.concat(self.apply_msg(source, msg)),
            )
        return actions

    def reply_fetch_request(
        self, source: int, client_id: int, req_no: int, digest: bytes
    ) -> Actions:
        """Reference :280-308."""
        client = self.clients.get(client_id)
        if client is None or not client.in_watermarks(req_no):
            return Actions()
        crn = client.req_no(req_no)
        self._peek_merge(client, crn)
        data = crn.requests.get(digest)
        if data is None or not (data.agreements >> self.my_config.id) & 1:
            return Actions()
        return Actions().forward_request(
            (source,),
            RequestAck(client_id=client_id, req_no=req_no, digest=digest),
        )

    def ack(self, source: int, ack: RequestAck, force: bool = False) -> Tuple[Actions, ClientRequest]:
        client = self.clients.get(ack.client_id)
        if client is None:
            raise AssertionError(
                "step filtering should delay reqs for non-existent clients"
            )
        if self.plane is not None:
            # Direct/forced acks (buffer replay, epoch-change request
            # recovery) use the full Python semantics: hand the slot back.
            self._eject_reqno(client, ack.req_no)
        return client.ack(source, ack, force=force)

    def note_fetching(self, ack: RequestAck) -> None:
        """See Client.note_fetching."""
        client = self.clients.get(ack.client_id)
        if client is not None:
            client.note_fetching(ack)

    def client(self, client_id: int) -> Optional[Client]:
        return self.clients.get(client_id)
