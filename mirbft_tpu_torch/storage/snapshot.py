"""Checkpoint snapshot store + state transfer over the socket plane (L4).

The testengine's c5 suite proves checkpoint state transfer in simulation:
a lagging node asks ``App.transfer_to(seq, value)`` for the snapshot body
matching a checkpoint attestation.  This module makes that real for
mirnet processes:

* :class:`SnapshotStore` keeps snapshot bodies on disk as
  ``snap-<sha256>.bin``, written tmp-then-rename with a directory fsync
  so a crash can never leave a half-written body under a valid name.
  Content addressing doubles as integrity: ``load`` re-hashes the file
  and refuses a body that does not match its digest.
* The **transfer protocol** rides the transport's new ``KIND_SNAPSHOT``
  frame kind (``net/framing.py``).  A fetcher dials a peer's listener,
  sends one request frame naming the digest, and reads back either a
  ``missing`` frame or the body as a sequence of chunked frames (1 MiB
  chunks, so a large app state never trips ``MAX_FRAME_PAYLOAD``).  The
  serving side is ``TcpTransport._serve_snapshot``; both ends use the
  pack/unpack helpers here.

Every *verified* received body increments
``snapshot_transfer_bytes_total`` (requester side — the drill's proof
that catch-up went over the wire, docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import hashlib
import os
import socket
import struct
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from .. import metrics
from ..net.framing import FrameDecoder, KIND_SNAPSHOT, encode_frame
from .segments import fsync_dir

DIGEST_LEN = hashlib.sha256().digest_size

# Subframe types inside a KIND_SNAPSHOT payload.
SNAP_REQUEST = 0
SNAP_CHUNK = 1
SNAP_MISSING = 2

CHUNK_BYTES = 1024 * 1024

# subtype, chunk seq, chunk total (seq/total zero for request/missing).
_SNAP_HEADER = struct.Struct(">BII")


class SnapshotStore:
    """Content-addressed on-disk snapshot bodies.  Lock-free: writers
    publish via atomic rename, readers verify by re-hashing, so a torn
    concurrent view is impossible by construction."""

    def __init__(self, path: str):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, digest: bytes) -> Path:
        return self.dir / f"snap-{digest.hex()}.bin"

    def save(self, blob: bytes) -> bytes:
        """Persist ``blob``; returns its sha256 digest (the snapshot id)."""
        digest = hashlib.sha256(blob).digest()
        final = self._path(digest)
        if final.exists():
            return digest
        tmp = final.with_suffix(".tmp")
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
        fsync_dir(self.dir)
        return digest

    def load(self, digest: bytes) -> Optional[bytes]:
        path = self._path(digest)
        try:
            blob = path.read_bytes()
        except OSError:
            return None
        if hashlib.sha256(blob).digest() != digest:
            return None  # corrupt body: treat as missing, refetch
        return blob

    def has(self, digest: bytes) -> bool:
        return self._path(digest).exists()


# --- wire helpers (both ends of the transfer) ---------------------------


def encode_request(digest: bytes) -> bytes:
    return _SNAP_HEADER.pack(SNAP_REQUEST, 0, 0) + digest


def encode_missing(digest: bytes) -> bytes:
    return _SNAP_HEADER.pack(SNAP_MISSING, 0, 0) + digest


def unpack(payload: bytes) -> Tuple[int, int, int, bytes]:
    """``(subtype, seq, total, body)`` of one KIND_SNAPSHOT payload."""
    if len(payload) < _SNAP_HEADER.size:
        raise ValueError("short snapshot frame")
    subtype, seq, total = _SNAP_HEADER.unpack_from(payload)
    return subtype, seq, total, payload[_SNAP_HEADER.size :]


def chunk_payloads(blob: bytes) -> List[bytes]:
    """Split a snapshot body into ordered SNAP_CHUNK payloads (at least
    one, so an empty body still yields a complete reply)."""
    total = max(1, (len(blob) + CHUNK_BYTES - 1) // CHUNK_BYTES)
    return [
        _SNAP_HEADER.pack(SNAP_CHUNK, seq, total)
        + blob[seq * CHUNK_BYTES : (seq + 1) * CHUNK_BYTES]
        for seq in range(total)
    ]


def serve_request(payload: bytes, load) -> List[bytes]:
    """Server side: turn a request payload into reply payloads using
    ``load(digest) -> Optional[bytes]``."""
    subtype, _, _, digest = unpack(payload)
    if subtype != SNAP_REQUEST or len(digest) != DIGEST_LEN:
        raise ValueError(f"bad snapshot request (subtype {subtype})")
    blob = load(digest)
    if blob is None:
        return [encode_missing(digest)]
    return chunk_payloads(blob)


# --- fetch side ---------------------------------------------------------


def fetch_snapshot(
    addr: Tuple[str, int], digest: bytes, timeout_s: float = 5.0
) -> Optional[bytes]:
    """Fetch the snapshot body for ``digest`` from one peer's transport
    listener.  Returns the verified body, or None if the peer lacks it,
    the connection fails, or verification fails."""
    try:
        with socket.create_connection(addr, timeout=timeout_s) as sock:
            sock.settimeout(timeout_s)
            sock.sendall(encode_frame(KIND_SNAPSHOT, encode_request(digest)))
            decoder = FrameDecoder()
            chunks: dict = {}
            total: Optional[int] = None
            while total is None or len(chunks) < total:
                data = sock.recv(65536)
                if not data:
                    return None
                for kind, payload in decoder.feed(data):
                    if kind != KIND_SNAPSHOT:
                        return None
                    subtype, seq, count, body = unpack(payload)
                    if subtype == SNAP_MISSING:
                        return None
                    if subtype != SNAP_CHUNK or count == 0:
                        return None
                    total = count
                    chunks[seq] = body
    except (OSError, ValueError):
        return None
    blob = b"".join(chunks.get(i, b"") for i in range(total))
    if len(chunks) != total or hashlib.sha256(blob).digest() != digest:
        return None
    metrics.counter("snapshot_transfer_bytes_total").inc(len(blob))
    return blob


def fetch_snapshot_from_peers(
    addrs: Iterable[Tuple[str, int]],
    digest: bytes,
    timeout_s: float = 5.0,
) -> Optional[bytes]:
    """Try each peer in turn until one serves a verified body."""
    for addr in addrs:
        blob = fetch_snapshot(addr, digest, timeout_s=timeout_s)
        if blob is not None:
            return blob
    return None
