"""Batch proposer: pulls ready requests into owned buckets and cuts batches.

Rebuild of reference ``pkg/statemachine/proposer.go``: per-owned-bucket
proposal queues with next-checkpoint gating (``valid_after_seq_no``), full
batches via ``has_pending`` and partial heartbeat batches via
``has_outstanding`` (reference :77-161).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, TYPE_CHECKING

from ..messages import NetworkConfig
from ..state import EventInitialParameters
from .stateless import client_req_to_bucket

if TYPE_CHECKING:
    from .client_tracker import ReadyList
    from .disseminator import ClientRequest


class ProposalBucket:
    """Reference proposer.go:30-52."""

    __slots__ = (
        "request_count",
        "pending",
        "bucket_id",
        "checkpoint_interval",
        "current_checkpoint",
        "ready_list",
        "next_ready_list",
    )

    def __init__(
        self,
        bucket_id: int,
        base_checkpoint: int,
        checkpoint_interval: int,
        request_count: int,
    ):
        self.bucket_id = bucket_id
        self.current_checkpoint = base_checkpoint
        self.checkpoint_interval = checkpoint_interval
        self.request_count = request_count
        self.pending: List["ClientRequest"] = []
        # requests valid at/before the current checkpoint window
        self.ready_list: Deque["ClientRequest"] = deque()
        # requests valid only after the next checkpoint
        self.next_ready_list: Deque["ClientRequest"] = deque()

    def queue_request(self, valid_after_seq_no: int, cr: "ClientRequest") -> None:
        if self.current_checkpoint >= valid_after_seq_no:
            self.ready_list.append(cr)
        else:
            if valid_after_seq_no != self.current_checkpoint + self.checkpoint_interval:
                raise AssertionError(
                    "requests should never become ready beyond the next "
                    "checkpoint interval"
                )
            self.next_ready_list.append(cr)

    def advance(self, to_seq_no: int) -> None:
        if to_seq_no >= self.current_checkpoint + self.checkpoint_interval:
            self.current_checkpoint += self.checkpoint_interval
            self.ready_list.extend(self.next_ready_list)
            self.next_ready_list = deque()
        while len(self.pending) < self.request_count and self.ready_list:
            self.pending.append(self.ready_list.popleft())

    def has_outstanding(self, for_seq_no: int) -> bool:
        """Anything at all to propose (heartbeat / partial batch)."""
        self.advance(for_seq_no)
        return len(self.pending) > 0

    def has_pending(self, for_seq_no: int) -> bool:
        """A full batch to propose."""
        self.advance(for_seq_no)
        return 0 < len(self.pending) == self.request_count

    def next(self) -> List["ClientRequest"]:
        result = self.pending
        self.pending = []
        return result


class Proposer:
    """Reference proposer.go:54-113."""

    __slots__ = (
        "my_config",
        "network_config",
        "proposal_buckets",
        "ready_iterator",
    )

    def __init__(
        self,
        base_checkpoint: int,
        checkpoint_interval: int,
        my_config: EventInitialParameters,
        ready_list: "ReadyList",
        buckets: Dict[int, int],  # bucket_id -> leader node_id
        network_config: NetworkConfig,
    ):
        self.my_config = my_config
        self.network_config = network_config
        self.proposal_buckets: Dict[int, ProposalBucket] = {
            bucket_id: ProposalBucket(
                bucket_id=bucket_id,
                base_checkpoint=base_checkpoint,
                checkpoint_interval=checkpoint_interval,
                request_count=my_config.batch_size,
            )
            for bucket_id, leader in buckets.items()
            if leader == my_config.id
        }
        ready_list.reset_iterator()
        self.ready_iterator = ready_list

    def advance(self, to_seq_no: int) -> None:
        """Pull newly-ready requests into owned proposal buckets
        (reference proposer.go:85-123)."""
        while self.ready_iterator.has_next():
            crn = self.ready_iterator.next()
            if crn.committed:
                # Possible if committed in a previous view but not yet GC'd.
                continue

            bucket_id = client_req_to_bucket(
                crn.client_id, crn.req_no, self.network_config
            )
            bucket = self.proposal_buckets.get(bucket_id)
            if bucket is None:
                continue  # not ours

            bucket.advance(to_seq_no)

            if len(crn.strong_requests) > 1:
                # Conflicting strong certs: one must be the null request;
                # prefer it (byzantine-client handling).
                null_req = crn.strong_requests.get(b"")
                if null_req is None:
                    raise AssertionError(
                        "if multiple requests have quorum, one must be null"
                    )
                bucket.queue_request(crn.valid_after_seq_no, null_req)
            else:
                if len(crn.strong_requests) != 1:
                    raise AssertionError("exactly one strong request must exist")
                bucket.queue_request(
                    crn.valid_after_seq_no,
                    next(iter(crn.strong_requests.values())),
                )

    def proposal_bucket(self, bucket_id: int) -> ProposalBucket:
        return self.proposal_buckets.get(bucket_id)
