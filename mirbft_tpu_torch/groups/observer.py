"""Non-voting observer/learner: snapshot bootstrap + commit-log tailing.

An :class:`Observer` follows one consensus group without ever touching a
quorum path.  It connects to any group member, sends SHIP_SUBSCRIBE from
its last applied sequence, and then:

* on ``SHIP_RESET`` — its start predates the feed's retained backlog —
  it fetches the checkpoint body over the **existing KIND_SNAPSHOT
  plane** (:func:`~mirbft_tpu_torch.storage.fetch_snapshot_from_peers`, which
  verifies the sha256 digest and counts
  ``snapshot_transfer_bytes_total``), records the checkpoint, and jumps
  its applied head to the checkpoint sequence;
* on ``SHIP_BATCH`` it appends the committed-batch journal line to its
  own ``commits.log`` — byte-identical to what the group members wrote,
  so the harness's seq-keyed agreement check covers observers unchanged;
* on ``SHIP_CHECKPOINT`` it obtains and verifies the snapshot body
  (local store first, peers otherwise) and appends ``<seq> <digest>`` to
  ``checkpoints.log`` — the bit-identical stable-checkpoint evidence.

A dropped connection rotates to the next member with capped backoff and
resubscribes from the applied head, so duplicates are filtered by
sequence number and gaps are impossible (the feed replays or RESETs).

All mutable state is single-writer (the run thread); readers (metrics
snapshots, tests) tolerate a stale view, so the observer needs no locks.
"""

from __future__ import annotations

import json
import socket
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from .. import metrics as metrics_mod
from .. import tracing
from ..eventlog import journal as journal_mod
from ..net.framing import KIND_GROUP, FrameDecoder, encode_frame
from . import ship


class Observer:
    """Tail one group into ``out_dir`` (see module docstring)."""

    def __init__(
        self,
        group_id: int,
        members: List[Tuple[str, int]],
        out_dir,
        registry=None,
    ):
        if not members:
            raise ValueError("observer needs at least one group member")
        self.group_id = group_id
        self.members = [(str(h), int(p)) for h, p in members]
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)

        from ..storage import SnapshotStore

        self.snapstore = SnapshotStore(str(self.out_dir / "snaps"))
        self._checkpoints_path = self.out_dir / "checkpoints.log"
        self._commits = open(self.out_dir / "commits.log", "a", buffering=1)

        # Flight recorder (docs/OBSERVABILITY.md): observers journal the
        # applied-batch stream too — TAG_APPLY lines plus checkpoint
        # markers in the same segmented, checkpoint-retained format as the
        # members', so `mircat --audit` covers the learner plane.  The
        # sink is single-writer by the observer's own contract (run
        # thread), so appending here is safe without locks.
        self._journal = journal_mod.SegmentSink(
            self.out_dir / "journal",
            group_id,
            registry=registry,
        )

        # Resume point after a restart: the highest sequence this
        # observer already applied (journal lines or recorded checkpoints).
        self.applied_seq = 0
        self.head_seq = 0
        self.stable_checkpoint: Optional[Tuple[int, bytes]] = None
        # Last RESHARD_CUTOVER heard on the feed: (marker seq, map bytes).
        self.reshard_cutover: Optional[Tuple[int, bytes]] = None
        for line in self._read_lines(self.out_dir / "commits.log"):
            self.applied_seq = max(self.applied_seq, int(line.split(" ", 1)[0]))
        for line in self._read_lines(self._checkpoints_path):
            seq, digest_hex = line.split(" ", 1)
            self.stable_checkpoint = (int(seq), bytes.fromhex(digest_hex))
            self.applied_seq = max(self.applied_seq, int(seq))
        self.head_seq = self.applied_seq

        reg = registry if registry is not None else metrics_mod.default_registry
        labels = {"group": str(group_id)}
        self._lag = reg.gauge("observer_lag_batches", labels=labels)
        self._applied = reg.counter(
            "observer_applied_batches_total", labels=labels
        )
        self._checkpoints = reg.counter(
            "observer_checkpoints_total", labels=labels
        )

    @staticmethod
    def _read_lines(path: Path) -> List[str]:
        if not path.exists():
            return []
        return [ln for ln in path.read_text().splitlines() if ln]

    # -- protocol handlers -------------------------------------------------

    def _snapshot_body(self, digest: bytes) -> bytes:
        """Checkpoint body by digest: local store first, then the group
        members over KIND_SNAPSHOT (verified + byte-counted there)."""
        blob = self.snapstore.load(digest)
        if blob is None:
            from ..storage import fetch_snapshot_from_peers

            blob = fetch_snapshot_from_peers(self.members, digest)
            if blob is None:
                raise OSError(
                    f"snapshot {digest.hex()[:12]} unavailable from "
                    f"{len(self.members)} members"
                )
            self.snapstore.save(blob)
        return blob

    def _record_checkpoint(self, seq: int, digest: bytes) -> None:
        if self.stable_checkpoint is not None and self.stable_checkpoint[0] >= seq:
            return
        self._snapshot_body(digest)  # bit-identity proof: body on disk
        with open(self._checkpoints_path, "a") as f:
            f.write(f"{seq} {digest.hex()}\n")
        self.stable_checkpoint = (seq, digest)
        self._checkpoints.inc()
        # Checkpoint marker doubles as the journal's retention anchor.
        self._journal.note_checkpoint(seq)

    def _on_reset(self, seq: int, digest: bytes) -> None:
        self._record_checkpoint(seq, digest)
        self.applied_seq = max(self.applied_seq, seq)
        self.head_seq = max(self.head_seq, seq)
        self._lag.set(max(0, self.head_seq - self.applied_seq))

    def _on_batch(self, seq: int, line: bytes) -> None:
        self.head_seq = max(self.head_seq, seq)
        # A NUL separates the journal line from the optional trace-id
        # trailer (ship.ShipFeed.note_commit); only the line part lands in
        # commits.log so it stays byte-identical to the members'.
        line, _, trailer = line.partition(b"\x00")
        if seq > self.applied_seq:
            start = tracing.default_tracer.now()
            self._commits.write(line.decode() + "\n")
            self._journal.append(
                journal_mod.TAG_APPLY,
                journal_mod._uvarint(seq) + line,
            )
            self.applied_seq = seq
            self._applied.inc()
            if tracing.default_tracer.enabled:
                args = {"seq_no": seq}
                if trailer:
                    try:
                        traces = json.loads(trailer.decode())
                    except ValueError:
                        traces = {}
                    if traces:
                        args["traces"] = traces
                        if len(traces) == 1:
                            args["trace"] = next(iter(traces.values()))
                tracing.default_tracer.complete(
                    "observer_apply",
                    start,
                    pid=self.group_id,
                    tid=0,
                    args=args,
                )
        self._lag.set(max(0, self.head_seq - self.applied_seq))

    def _on_checkpoint(self, seq: int, digest: bytes) -> None:
        self.head_seq = max(self.head_seq, seq)
        self._record_checkpoint(seq, digest)
        self._lag.set(max(0, self.head_seq - self.applied_seq))

    # -- tail loop ---------------------------------------------------------

    def _tail_once(self, addr: Tuple[str, int], stop: threading.Event) -> None:
        sock = socket.create_connection(addr, timeout=5.0)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(0.2)
            sock.sendall(
                encode_frame(
                    KIND_GROUP,
                    ship.encode_subscribe(self.group_id, self.applied_seq),
                )
            )
            decoder = FrameDecoder()
            while not stop.is_set():
                try:
                    data = sock.recv(65536)
                except socket.timeout:
                    continue
                if not data:
                    raise OSError("feed closed the connection")
                for kind, payload in decoder.feed(data):
                    if kind != KIND_GROUP:
                        continue
                    subtype, group, seq, body = ship.decode(payload)
                    if group != self.group_id:
                        continue
                    if subtype == ship.SHIP_RESET:
                        self._on_reset(seq, body)
                    elif subtype == ship.SHIP_BATCH:
                        self._on_batch(seq, body)
                    elif subtype == ship.SHIP_CHECKPOINT:
                        self._on_checkpoint(seq, body)
                    elif subtype == ship.RESHARD_CUTOVER:
                        # The group committed its cutover marker at seq;
                        # body is the post-cutover map.  Recorded so a
                        # learner being promoted (docs/SHARDING.md
                        # "Elastic resharding") knows the epoch it joins.
                        self.reshard_cutover = (seq, bytes(body))
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def run(self, stop: threading.Event) -> None:
        """Tail until ``stop`` is set, rotating members with capped
        backoff on any connection or fetch failure."""
        backoff = 0.05
        member = 0
        while not stop.is_set():
            addr = self.members[member % len(self.members)]
            member += 1
            try:
                self._tail_once(addr, stop)
                backoff = 0.05
            except (OSError, ValueError):
                stop.wait(backoff)
                backoff = min(1.0, backoff * 2)

    def close(self) -> None:
        self._commits.close()
        try:
            self._journal.close()
        except OSError:
            pass

    def state(self) -> dict:
        return {
            "group": self.group_id,
            "applied_seq": self.applied_seq,
            "head_seq": self.head_seq,
            "stable_checkpoint": self.stable_checkpoint,
            "reshard_cutover": self.reshard_cutover,
        }
