"""Signed-client-request authentication (extended BASELINE configs 2-5).

The reference keeps signatures off the consensus hot path entirely and
delegates request authentication to the embedder (reference
``docs/Design.md`` "Network Ingress", ``README.md:7-9``).  This component is
that embedder-side layer, built TPU-first: replicas verify client signatures
over (domain || client_id || req_no || payload) in batched device dispatches
(``ops.ed25519``) before a request may be persisted and acknowledged, so a
forged proposal can never enter dissemination.

Envelope format (transport-level, not part of the consensused schema): the
request body carried through the system is ``payload || 64-byte signature``;
the consensus layers treat it as opaque bytes — digests, batching, ordering
and the application all see the envelope unchanged, preserving the
reference's digest-only consensus property.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing

DOMAIN = b"mirbft-tpu/req/v1\x00"
SIGNATURE_LEN = 64


def signing_payload(client_id: int, req_no: int, payload: bytes) -> bytes:
    """The byte string a client signs: domain-separated and position-bound,
    so a signature cannot be replayed for another client or request number."""
    return (
        DOMAIN
        + client_id.to_bytes(8, "big")
        + req_no.to_bytes(8, "big")
        + payload
    )


def seal(payload: bytes, signature: bytes) -> bytes:
    if len(signature) != SIGNATURE_LEN:
        raise ValueError("ed25519 signatures are 64 bytes")
    return payload + signature


def unseal(envelope: bytes) -> Optional[Tuple[bytes, bytes]]:
    """Split an envelope into (payload, signature); None if too short."""
    if len(envelope) < SIGNATURE_LEN:
        return None
    return envelope[:-SIGNATURE_LEN], envelope[-SIGNATURE_LEN:]


class RequestAuthenticator:
    """Batched signature checking against a registered client-key set.

    One instance per replica.  ``authenticate_batch`` verifies a whole
    iteration's proposals in one device dispatch (or the CPU path for tiny
    batches) and records per-dispatch wall times for the verify-latency
    percentile the benchmark reports.
    """

    _MEMO_CAP = 1 << 16

    def __init__(self, verifier=None):
        if verifier is None:
            from ..ops.ed25519 import Ed25519BatchVerifier

            verifier = Ed25519BatchVerifier()
        self.verifier = verifier
        self.keys: Dict[int, bytes] = {}
        self.dispatch_seconds: List[float] = []
        self.verified_count = 0
        # Verdict memo keyed by (client, req_no, envelope identity), entry
        # pins the envelope so the id stays stable.  A proposal retried at
        # the ingress gate (window not yet allocated) must not pay a fresh
        # verification per retry.
        self._memo: Dict[Tuple[int, int, int], Tuple[bytes, bool]] = {}

    def register(self, client_id: int, public_key: bytes) -> None:
        if len(public_key) != 32:
            raise ValueError("ed25519 public keys are 32 bytes")
        # Key rotation invalidates every cached verdict for the client:
        # a verdict memoized under the old key (either way) must not be
        # served once the key changes.
        if self.keys.get(client_id) != public_key:
            self._purge_memo(client_id)
        self.keys[client_id] = public_key

    def remove(self, client_id: int) -> None:
        self.keys.pop(client_id, None)
        self._purge_memo(client_id)

    def _purge_memo(self, client_id: int) -> None:
        for key in [k for k in self._memo if k[0] == client_id]:
            del self._memo[key]

    def authenticate_batch(
        self,
        items: Sequence[Tuple[int, int, bytes]],
        memoize: bool = False,
    ) -> np.ndarray:
        """items: (client_id, req_no, envelope) triples -> bool per item.

        ``memoize=True`` records each verdict in the per-envelope memo, so
        an embedder can verify a whole ingress window in ONE device
        dispatch and have the scalar ``authenticate`` gate (the propose
        path) serve from it — the bulk-verify-then-propose pattern of the
        async crypto plane.  The memo pins the envelope objects; verdicts
        apply only to the exact objects passed here."""
        if not items:
            return np.zeros(0, dtype=bool)
        ok = np.zeros(len(items), dtype=bool)
        pubs: List[bytes] = []
        msgs: List[bytes] = []
        sigs: List[bytes] = []
        rows: List[int] = []
        for i, (client_id, req_no, envelope) in enumerate(items):
            pub = self.keys.get(client_id)
            parts = unseal(envelope)
            if pub is None or parts is None:
                continue
            payload, signature = parts
            pubs.append(pub)
            msgs.append(signing_payload(client_id, req_no, payload))
            sigs.append(signature)
            rows.append(i)
        if rows:
            start = time.perf_counter()
            with tracing.default_tracer.span(
                "auth_batch", tid=2, args={"signatures": len(rows)}
            ):
                verdicts = self.verifier.verify_batch(pubs, msgs, sigs)
            self.dispatch_seconds.append(time.perf_counter() - start)
            self.verified_count += len(rows)
            for row, verdict in zip(rows, verdicts):
                ok[row] = bool(verdict)
        if memoize:
            for i, (client_id, req_no, envelope) in enumerate(items):
                if len(self._memo) >= self._MEMO_CAP:
                    self._memo.clear()
                # mirlint: allow(id-ordering) — identity memo key; hits are
                # is-checked against the pinned envelope, never ordered.
                self._memo[(client_id, req_no, id(envelope))] = (
                    envelope, bool(ok[i])
                )
        return ok

    def authenticate(self, client_id: int, req_no: int, envelope: bytes) -> bool:
        # mirlint: allow(id-ordering) — identity memo lookup (see above).
        key = (client_id, req_no, id(envelope))
        entry = self._memo.get(key)
        if entry is not None and entry[0] is envelope:
            return entry[1]
        verdict = bool(
            self.authenticate_batch([(client_id, req_no, envelope)])[0]
        )
        if len(self._memo) >= self._MEMO_CAP:
            self._memo.clear()
        self._memo[key] = (envelope, verdict)
        return verdict

    def p99_dispatch_seconds(self) -> float:
        if not self.dispatch_seconds:
            return 0.0
        return float(np.percentile(np.array(self.dispatch_seconds), 99))
