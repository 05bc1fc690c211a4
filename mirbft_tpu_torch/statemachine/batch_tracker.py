"""Batch observation index and epoch-change-time batch fetching.

Rebuild of reference ``pkg/statemachine/batch_tracker.go``: indexes observed
batches by digest (from Preprepares and QEntry replay), and implements the
``FetchBatch`` → ``ForwardBatch`` → hash-verify (``VerifyBatchOrigin``) flow
used when a new-epoch config references batches we never saw (:109-218).
The verify hash runs on the TPU batcher alongside normal batch digests.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .. import state as st
from ..messages import FetchBatch, ForwardBatch, Msg, QEntry, RequestAck
from .actions import Actions
from .persisted import PersistedLog


class Batch:
    __slots__ = ("observed_for", "request_acks")

    def __init__(self, request_acks: Tuple[RequestAck, ...]):
        self.observed_for: Set[int] = set()
        self.request_acks = request_acks


class BatchTracker:
    """Reference batch_tracker.go:18-46."""

    __slots__ = ("batches_by_digest", "fetch_in_flight", "persisted")

    def __init__(self, persisted: PersistedLog):
        self.batches_by_digest: Dict[bytes, Batch] = {}
        # digest -> seq_nos being fetched (a list: identical digests may be
        # fetched for multiple seq_nos, e.g. empty batches)
        self.fetch_in_flight: Dict[bytes, List[int]] = {}
        self.persisted = persisted

    def reinitialize(self) -> None:
        self.batches_by_digest = {}
        self.fetch_in_flight = {}
        for _, entry in self.persisted.entries:
            if isinstance(entry, QEntry):
                self.add_batch(entry.seq_no, entry.digest, entry.requests)

    def step(self, source: int, msg: Msg) -> Actions:
        if isinstance(msg, FetchBatch):
            return self.reply_fetch_batch(source, msg.seq_no, msg.digest)
        if isinstance(msg, ForwardBatch):
            return self.apply_forward_batch_msg(
                source, msg.seq_no, msg.digest, msg.request_acks
            )
        raise AssertionError(f"unexpected batch message type {type(msg).__name__}")

    def truncate(self, seq_no: int) -> None:
        """Drop observations below seq_no (reference batch_tracker.go:69-80)."""
        for digest in list(self.batches_by_digest):
            batch = self.batches_by_digest[digest]
            batch.observed_for = {s for s in batch.observed_for if s >= seq_no}
            if not batch.observed_for:
                del self.batches_by_digest[digest]

    def add_batch(
        self, seq_no: int, digest: bytes, request_acks: Tuple[RequestAck, ...]
    ) -> None:
        """Reference batch_tracker.go:83-108."""
        b = self.batches_by_digest.get(digest)
        if b is None:
            b = Batch(request_acks)
            self.batches_by_digest[digest] = b
        b.observed_for.add(seq_no)

        in_flight = self.fetch_in_flight.pop(digest, None)
        if in_flight is not None:
            b.observed_for.update(in_flight)

    def fetch_batch(self, seq_no: int, digest: bytes, sources: Tuple[int, ...]) -> Actions:
        """Reference batch_tracker.go:110-140."""
        in_flight = self.fetch_in_flight.get(digest)
        if in_flight is not None and seq_no in in_flight:
            return Actions()
        self.fetch_in_flight.setdefault(digest, []).append(seq_no)
        return Actions().send(sources, FetchBatch(seq_no=seq_no, digest=digest))

    def reply_fetch_batch(self, source: int, seq_no: int, digest: bytes) -> Actions:
        batch = self.batches_by_digest.get(digest)
        if batch is None:
            return Actions()  # not necessarily byzantine; just don't have it
        return Actions().send(
            (source,),
            ForwardBatch(
                seq_no=seq_no, request_acks=batch.request_acks, digest=digest
            ),
        )

    def apply_forward_batch_msg(
        self,
        source: int,
        seq_no: int,
        digest: bytes,
        request_acks: Tuple[RequestAck, ...],
    ) -> Actions:
        """An unrequested forward is untrusted and discarded; a requested one
        is re-hashed (on TPU) to verify against the expected digest
        (reference batch_tracker.go:159-180)."""
        if digest not in self.fetch_in_flight:
            return Actions()
        return Actions().hash(
            [ack.digest for ack in request_acks],
            st.VerifyBatchOrigin(
                source=source,
                seq_no=seq_no,
                request_acks=tuple(request_acks),
                expected_digest=digest,
            ),
        )

    def apply_verify_batch_hash_result(
        self, digest: bytes, origin: st.VerifyBatchOrigin
    ) -> None:
        """Reference batch_tracker.go:182-210."""
        if origin.expected_digest != digest:
            raise AssertionError(
                "forwarded batch hash mismatch (byzantine forwarder)"
            )
        in_flight = self.fetch_in_flight.pop(digest, None)
        if in_flight is None:
            return  # duplicate response; already handled one
        b = self.batches_by_digest.get(digest)
        if b is None:
            b = Batch(origin.request_acks)
            self.batches_by_digest[digest] = b
        b.observed_for.update(in_flight)

    def has_fetch_in_flight(self) -> bool:
        return bool(self.fetch_in_flight)

    def get_batch(self, digest: bytes) -> Optional[Batch]:
        return self.batches_by_digest.get(digest)
