"""Outstanding-request bookkeeping for leader Preprepare validation.

Rebuild of reference ``pkg/statemachine/outstanding.go``: enforces per-bucket,
per-client in-order request-number consumption when validating a leader's
batch (``apply_acks``, reference :120-151), and matches arriving "available"
requests (stored + correct) to sequences waiting on them
(``advance_requests``, reference :101-117).

``RequestAck`` is frozen/hashable, so it serves directly as the reference's
``ackKey``.
"""

from __future__ import annotations

from typing import Dict, List, Set, TYPE_CHECKING

from ..messages import ClientState, NetworkState, RequestAck
from .actions import Actions
from .stateless import client_req_to_bucket, is_committed

if TYPE_CHECKING:
    from .client_tracker import AvailableList
    from .sequence import Sequence


class ClientOutstandingReqs:
    """Next expected req_no for one client within one bucket
    (reference outstanding.go:88-104)."""

    __slots__ = ("next_req_no", "num_buckets", "client")

    def __init__(self, next_req_no: int, num_buckets: int, client: ClientState):
        self.next_req_no = next_req_no
        self.num_buckets = num_buckets
        self.client = client

    def skip_previously_committed(self) -> None:
        while is_committed(self.next_req_no, self.client):
            self.next_req_no += self.num_buckets


class AllOutstandingReqs:
    """Reference outstanding.go:28-86."""

    __slots__ = (
        "buckets",
        "available_iterator",
        "correct_requests",
        "outstanding_requests",
    )

    def __init__(
        self,
        available_list: "AvailableList",
        network_state: NetworkState,
        logger=None,
    ):
        available_list.reset_iterator()
        self.available_iterator = available_list
        self.correct_requests: Dict[RequestAck, RequestAck] = {}
        self.outstanding_requests: Dict[RequestAck, "Sequence"] = {}
        self.buckets: Dict[int, Dict[int, ClientOutstandingReqs]] = {}

        num_buckets = network_state.config.number_of_buckets
        for bucket in range(num_buckets):
            clients: Dict[int, ClientOutstandingReqs] = {}
            self.buckets[bucket] = clients
            for client in network_state.clients:
                # First req_no ≥ low_watermark mapping into this bucket:
                # solve (client_id + req_no) ≡ bucket (mod num_buckets).
                lw = client.low_watermark
                first_uncommitted = lw + (bucket - client.id - lw) % num_buckets
                cors = ClientOutstandingReqs(
                    next_req_no=first_uncommitted,
                    num_buckets=num_buckets,
                    client=client,
                )
                cors.skip_previously_committed()
                clients[client.id] = cors

        self.advance_requests()  # no sequences allocated yet → no actions

    def advance_requests(self) -> Actions:
        """Drain newly-available requests: satisfy waiting sequences, or
        record them as correct-and-present (reference outstanding.go:101-117)."""
        actions = Actions()
        while self.available_iterator.has_next():
            ack = self.available_iterator.next()
            seq = self.outstanding_requests.pop(ack, None)
            if seq is not None:
                actions.concat(seq.satisfy_outstanding(ack))
                continue
            self.correct_requests[ack] = ack
        return actions

    def apply_acks(
        self, bucket: int, seq: "Sequence", batch: List[RequestAck]
    ) -> Actions:
        """Validate a leader's batch against in-order per-client consumption
        and allocate the sequence (reference outstanding.go:120-151).

        Raises ValueError for protocol-invalid batches (unknown client,
        out-of-order req_no) — the caller treats that as a byzantine leader
        and emits a Suspect (epoch_active.apply_preprepare_msg).  Validation
        runs as a separate pass over simulated cursors so a rejected batch
        leaves the bookkeeping untouched: the node keeps running on exactly
        the state it had before the bad Preprepare arrived.
        """
        clients = self.buckets.get(bucket)
        if clients is None:
            raise AssertionError(f"no such bucket {bucket}")

        # Validate pass: no mutation.  Simulated per-client cursors advance
        # the same way the apply pass does (+num_buckets, then skip
        # already-committed req_nos).
        cursors: Dict[int, int] = {}
        for req in batch:
            co = clients.get(req.client_id)
            if co is None:
                raise ValueError(f"no such client {req.client_id}")
            expected = cursors.get(req.client_id, co.next_req_no)
            if expected != req.req_no:
                raise ValueError(
                    f"expected client {req.client_id} next request for bucket "
                    f"{bucket} to have req_no {expected} but got "
                    f"{req.req_no}"
                )
            nxt = expected + co.num_buckets
            while is_committed(nxt, co.client):
                nxt += co.num_buckets
            cursors[req.client_id] = nxt

        # Apply pass: cannot fail.
        outstanding: Set[RequestAck] = set()
        for req in batch:
            co = clients[req.client_id]
            if req in self.correct_requests:
                del self.correct_requests[req]
            else:
                self.outstanding_requests[req] = seq
                outstanding.add(req)
            co.next_req_no += co.num_buckets
            co.skip_previously_committed()

        return seq.allocate(batch, outstanding)
