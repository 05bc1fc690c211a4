"""Durable request store (L4).

Rebuild of reference ``pkg/reqstore`` (badger-backed): persists request
payloads keyed by (client, req_no, digest) and allocation digests keyed by
(client, req_no), with an explicit ``sync`` durability barrier.  Backed by
sqlite3 (stdlib) in WAL journal mode; ``path=None`` gives the reference's
in-memory mode.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Optional

from .messages import RequestAck

# Shared-state declaration for mirlint's lock-discipline pass: one
# sqlite3 connection shared across node worker threads
# (check_same_thread=False), so every statement runs under the store
# lock (docs/STATIC_ANALYSIS.md).
MIRLINT_SHARED_STATE = {
    "Store._db": "_lock",
}


class Store:
    """File-backed (or in-memory) ``processor.RequestStore``."""

    def __init__(self, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._db = sqlite3.connect(
            path if path is not None else ":memory:",
            check_same_thread=False,
            isolation_level=None,  # autocommit; sync() checkpoints
        )
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS requests ("
            " client_id INTEGER, req_no INTEGER, digest BLOB, data BLOB,"
            " PRIMARY KEY (client_id, req_no, digest))"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS allocations ("
            " client_id INTEGER, req_no INTEGER, digest BLOB,"
            " PRIMARY KEY (client_id, req_no))"
        )

    def put_request(self, ack: RequestAck, data: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO requests VALUES (?, ?, ?, ?)",
                (ack.client_id, ack.req_no, ack.digest, data),
            )

    def get_request(self, ack: RequestAck) -> Optional[bytes]:
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM requests WHERE client_id=? AND req_no=? AND digest=?",
                (ack.client_id, ack.req_no, ack.digest),
            ).fetchone()
        return row[0] if row else None

    def put_allocation(self, client_id: int, req_no: int, digest: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO allocations VALUES (?, ?, ?)",
                (client_id, req_no, digest),
            )

    def get_allocation(self, client_id: int, req_no: int) -> Optional[bytes]:
        with self._lock:
            row = self._db.execute(
                "SELECT digest FROM allocations WHERE client_id=? AND req_no=?",
                (client_id, req_no),
            ).fetchone()
        return row[0] if row else None

    def sync(self) -> None:
        """Durability barrier: requests acked after this call must survive
        power loss (the reqstore-sync-before-ack invariant).  A FULL
        checkpoint flushes and fsyncs every WAL frame; PASSIVE could
        silently checkpoint nothing when busy."""
        with self._lock:
            row = self._db.execute("PRAGMA wal_checkpoint(FULL)").fetchone()
            if row is not None and row[0] != 0:
                raise RuntimeError("request store checkpoint was blocked")

    def close(self) -> None:
        with self._lock:
            self._db.close()
