"""Client-side request-store logic and the Propose API.

Rebuild of reference ``pkg/processor/clients.go``: allocation lookups,
known-correct digest tracking, byzantine-self protection (one digest per
req_no), and request persistence ordering (PutRequest + PutAllocation before
the RequestPersisted event reaches the state machine).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import state as st
from ..messages import ClientState, RequestAck
from ..statemachine.actions import Actions, Events
from .interfaces import Hasher, RequestStore

# Shared-state declaration for mirlint's lock-discipline pass: Propose
# runs on client threads while state_applied/allocate run on the
# processor loop, so per-client request state only moves under the
# client's lock (docs/STATIC_ANALYSIS.md).
MIRLINT_SHARED_STATE = {
    "Client.next_req_no": "_lock",
    "Client.requests": "_lock",
    "_ClientRequest.local_allocation_digest": "_lock",
    "_ClientRequest.remote_correct_digests": "_lock",
    "Clients._clients": "_lock",
}


class ClientNotExistError(KeyError):
    pass


class _ClientRequest:
    __slots__ = ("req_no", "local_allocation_digest", "remote_correct_digests")

    def __init__(self, req_no: int):
        self.req_no = req_no
        self.local_allocation_digest: Optional[bytes] = None
        self.remote_correct_digests: List[bytes] = []


class Client:
    """Reference clients.go:85-276."""

    __slots__ = (
        "_lock",
        "hasher",
        "client_id",
        "next_req_no",
        "request_store",
        "requests",
    )

    def __init__(self, client_id: int, hasher: Hasher, request_store: RequestStore):
        self._lock = threading.Lock()
        self.hasher = hasher
        self.client_id = client_id
        self.next_req_no = 0
        self.request_store = request_store
        self.requests: Dict[int, _ClientRequest] = {}  # insertion-ordered

    def state_applied(self, state: ClientState) -> None:
        """GC requests below the committed low watermark
        (reference clients.go:109-121)."""
        with self._lock:
            for req_no in list(self.requests):
                if req_no < state.low_watermark:
                    del self.requests[req_no]
            if self.next_req_no < state.low_watermark:
                self.next_req_no = state.low_watermark

    def allocate(self, req_no: int) -> Optional[bytes]:
        """The state machine allocated this slot; report the local digest if
        the request is already persisted (reference clients.go:123-146)."""
        with self._lock:
            cr = self.requests.get(req_no)
            if cr is not None:
                return cr.local_allocation_digest
            cr = _ClientRequest(req_no)
            self.requests[req_no] = cr
            digest = self.request_store.get_allocation(self.client_id, req_no)
            cr.local_allocation_digest = digest
            return digest

    def add_correct_digest(self, req_no: int, digest: bytes) -> None:
        """Reference clients.go:148-172."""
        with self._lock:
            if not self.requests:
                raise ClientNotExistError(self.client_id)
            cr = self.requests.get(req_no)
            if cr is None:
                first = next(iter(self.requests.values()))
                if req_no < first.req_no:
                    return  # already GC'd
                raise AssertionError(
                    f"unallocated client request req_no={req_no} marked correct"
                )
            if digest not in cr.remote_correct_digests:
                cr.remote_correct_digests.append(digest)

    def next_req_no_value(self) -> int:
        with self._lock:
            if not self.requests:
                raise ClientNotExistError(self.client_id)
            return self.next_req_no

    def propose(self, req_no: int, data: bytes) -> Events:
        """Reference clients.go:189-276.  Hash the request, enforce
        one-digest-per-req_no, persist body + allocation, and emit
        RequestPersisted iff the state machine already allocated the slot."""
        (digest,) = self.hasher.hash_batches([[data]])

        with self._lock:
            if not self.requests:
                raise ClientNotExistError(self.client_id)
            if req_no < self.next_req_no:
                return Events()

            if req_no == self.next_req_no:
                while True:
                    self.next_req_no += 1
                    nxt = self.requests.get(self.next_req_no)
                    if nxt is None or nxt.local_allocation_digest is None:
                        break

            cr = self.requests.get(req_no)
            previously_allocated = cr is not None
            if cr is None:
                cr = _ClientRequest(req_no)
                self.requests[req_no] = cr

            if cr.local_allocation_digest is not None:
                if cr.local_allocation_digest == digest:
                    return Events()
                raise ValueError(
                    f"cannot store request with digest {digest.hex()}: already "
                    f"stored different digest "
                    f"{cr.local_allocation_digest.hex()} for req_no {req_no}"
                )

            if cr.remote_correct_digests and digest not in cr.remote_correct_digests:
                raise ValueError(
                    "other known-correct digests exist for this req_no"
                )

            ack = RequestAck(client_id=self.client_id, req_no=req_no, digest=digest)
            self.request_store.put_request(ack, data)
            self.request_store.put_allocation(self.client_id, req_no, digest)
            cr.local_allocation_digest = digest

            if previously_allocated:
                return Events().request_persisted(ack)
            return Events()

    def store_forwarded(self, ack: RequestAck, data: bytes) -> Events:
        """Persist a peer-forwarded request body (the answer to our
        FetchRequest).  Only digests the state machine marked correct
        (ActionCorrectRequest — an f+1-backed quorum observation) are
        accepted, so an unsolicited forward with self-consistent garbage
        cannot plant data; anything else is silently dropped and the fetch
        retry loop re-asks.  Caller must have verified
        ``hash(data) == ack.digest``."""
        with self._lock:
            cr = self.requests.get(ack.req_no)
            if cr is None:
                return Events()  # never allocated here, or already GC'd
            if ack.digest not in cr.remote_correct_digests:
                return Events()  # not a known-correct digest: refuse
            if cr.local_allocation_digest == ack.digest:
                return Events()  # already stored (duplicate forward)
            self.request_store.put_request(ack, data)
            if cr.local_allocation_digest is None:
                # First body for this req_no: record the allocation so a
                # restart replays it.  A conflicting local digest (byzantine
                # client equivocation) keeps its allocation — the store
                # holds both bodies, keyed by full ack.
                self.request_store.put_allocation(
                    self.client_id, ack.req_no, ack.digest
                )
                cr.local_allocation_digest = ack.digest
            return Events().request_persisted(ack)


class Clients:
    """Reference clients.go:23-45."""

    __slots__ = ("hasher", "request_store", "_lock", "_clients")

    def __init__(self, hasher: Hasher, request_store: RequestStore):
        self.hasher = hasher
        self.request_store = request_store
        self._lock = threading.Lock()
        self._clients: Dict[int, Client] = {}

    def client(self, client_id: int) -> Client:
        with self._lock:
            c = self._clients.get(client_id)
            if c is None:
                c = Client(client_id, self.hasher, self.request_store)
                self._clients[client_id] = c
            return c

    def ingest_forwarded(self, msg) -> Optional[Events]:
        """Verify and store an inbound ForwardRequest.  Returns None when
        the body does not hash to the claimed digest (peer-controlled
        input: the caller attributes an ``invalid_digest`` fault to the
        sender); otherwise the RequestPersisted events to route through
        the request-store durability barrier (possibly empty)."""
        ack = msg.request_ack
        (digest,) = self.hasher.hash_batches([[msg.request_data]])
        if digest != ack.digest:
            return None
        return self.client(ack.client_id).store_forwarded(
            ack, msg.request_data
        )

    def process_client_actions(self, actions: Actions) -> Events:
        """Reference clients.go:46-83.  AllocatedRequest dominates (a whole
        client window per checkpoint) and arrives in same-client runs, so
        the client handle is cached across consecutive actions."""
        events = Events()
        last_id = None
        client = None
        for action in actions:
            if isinstance(action, st.ActionAllocatedRequest):
                if action.client_id != last_id:
                    last_id = action.client_id
                    client = self.client(last_id)
                digest = client.allocate(action.req_no)
                if digest is None:
                    continue
                events.request_persisted(
                    RequestAck(
                        client_id=action.client_id,
                        req_no=action.req_no,
                        digest=digest,
                    )
                )
            elif isinstance(action, st.ActionCorrectRequest):
                # Distinct local: must not clobber the cached allocation
                # handle above while its last_id remains set.
                correct_client = self.client(action.ack.client_id)
                correct_client.add_correct_digest(
                    action.ack.req_no, action.ack.digest
                )
            elif isinstance(action, st.ActionStateApplied):
                for client_state in action.network_state.clients:
                    self.client(client_state.id).state_applied(client_state)
            else:
                raise AssertionError(
                    f"unexpected client action type {type(action).__name__}"
                )
        return events
