"""Log-structured request store with checkpoint-keyed GC (L4).

``reqstore.Store`` (sqlite) never reclaims space: every request payload a
client ever submitted stays in the database forever.  This engine stores
the same keyspace — request payloads by ``(client_id, req_no, digest)``
and allocation digests by ``(client_id, req_no)`` — as append-only
CRC-framed segment files (``storage/segments.py``) with an **in-memory
index**, and garbage-collects **keyed to the stable-checkpoint
watermark**:

* ``note_checkpoint(index, watermarks)`` records the per-client low
  watermarks carried by a checkpoint ``CEntry`` the moment it is
  persisted (``processor/serial.py``).
* ``gc(index)`` runs when the state machine emits ``ActionTruncate`` for
  that entry — i.e. only once the checkpoint is *stable* (signed by a
  quorum; ``statemachine/persisted.py``).  Entries whose ``req_no`` is
  below their client's watermark are dead: compaction rewrites the live
  entries of mostly-dead sealed segments into the active segment and
  unlinks the old files atomically (fsync data, fsync directory, then
  unlink, then fsync directory again — see docs/STORAGE.md).

Durability matches the sqlite store's contract: ``sync()`` is the
barrier, and concurrent callers coalesce — the lock holder fsyncs once
and every waiter that queued behind it finds its writes already durable.

Metrics (docs/OBSERVABILITY.md): ``store_gc_reclaimed_bytes_total``.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .. import metrics, wire
from ..messages import RequestAck
from .segments import cut_torn_tail, encode_record, fsync_dir, iter_records

TAG_REQUEST = 1
TAG_ALLOCATION = 2
# GC marker: the per-client low watermarks a compaction applied.  Replay
# re-applies the newest one, or entries GC dropped from the index (but
# whose records sit in surviving, not-compacted segments) would resurrect
# on restart.
TAG_WATERMARK = 3

# Shared-state declaration for mirlint's lock-discipline pass: the index,
# segment table, and active file handle are shared across node worker
# threads, so every touch happens under the store lock
# (docs/STATIC_ANALYSIS.md).
MIRLINT_SHARED_STATE = {
    "LogStore._requests": "_lock",
    "LogStore._allocations": "_lock",
    "LogStore._segs": "_lock",
    "LogStore._active_id": "_lock",
    "LogStore._active_fh": "_lock",
    "LogStore._active_size": "_lock",
    "LogStore._seq": "_lock",
    "LogStore._durable_seq": "_lock",
    "LogStore._watermarks": "_lock",
    "LogStore._gc_low": "_lock",
    "LogStore._closed": "_lock",
}


def _encode_request(ack: RequestAck, data: bytes) -> Tuple[bytes, int]:
    """Returns ``(payload, data_offset_within_payload)``."""
    buf = bytearray()
    wire.write_uvarint(buf, ack.client_id)
    wire.write_uvarint(buf, ack.req_no)
    wire.write_uvarint(buf, len(ack.digest))
    buf += ack.digest
    wire.write_uvarint(buf, len(data))
    data_off = len(buf)
    buf += data
    return bytes(buf), data_off


def _decode_request(payload: bytes) -> Tuple[int, int, bytes, int, int]:
    """Returns ``(client_id, req_no, digest, data_off, data_len)``."""
    client_id, pos = wire.read_uvarint(payload, 0)
    req_no, pos = wire.read_uvarint(payload, pos)
    dlen, pos = wire.read_uvarint(payload, pos)
    digest = bytes(payload[pos : pos + dlen])
    pos += dlen
    data_len, pos = wire.read_uvarint(payload, pos)
    return client_id, req_no, digest, pos, data_len


def _encode_allocation(client_id: int, req_no: int, digest: bytes) -> bytes:
    buf = bytearray()
    wire.write_uvarint(buf, client_id)
    wire.write_uvarint(buf, req_no)
    wire.write_uvarint(buf, len(digest))
    buf += digest
    return bytes(buf)


def _decode_allocation(payload: bytes) -> Tuple[int, int, bytes]:
    client_id, pos = wire.read_uvarint(payload, 0)
    req_no, pos = wire.read_uvarint(payload, pos)
    dlen, pos = wire.read_uvarint(payload, pos)
    return client_id, req_no, bytes(payload[pos : pos + dlen])


def _encode_watermark(watermarks: Dict[int, int]) -> bytes:
    buf = bytearray()
    wire.write_uvarint(buf, len(watermarks))
    for client_id in sorted(watermarks):
        wire.write_uvarint(buf, client_id)
        wire.write_uvarint(buf, watermarks[client_id])
    return bytes(buf)


def _decode_watermark(payload: bytes) -> Dict[int, int]:
    count, pos = wire.read_uvarint(payload, 0)
    out: Dict[int, int] = {}
    for _ in range(count):
        client_id, pos = wire.read_uvarint(payload, pos)
        low, pos = wire.read_uvarint(payload, pos)
        out[client_id] = low
    return out


class LogStore:
    """File-backed ``processor.RequestStore`` over append-only segments."""

    def __init__(self, path: str, segment_max_bytes: int = 4 * 1024 * 1024):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_max_bytes = segment_max_bytes
        # RLock: the private append/rotate/read helpers re-acquire it
        # so their shared-state accesses are lexically guarded too.
        self._lock = threading.RLock()

        # (client_id, req_no, digest) -> (seg_id, file_data_off, data_len, rec_len)
        self._requests: Dict[Tuple[int, int, bytes], Tuple[int, int, int, int]] = {}
        # (client_id, req_no) -> (digest, seg_id, rec_len)
        self._allocations: Dict[Tuple[int, int], Tuple[bytes, int, int]] = {}
        self._segs: Dict[int, Path] = {}
        self._watermarks: Dict[int, Dict[int, int]] = {}
        self._gc_low: Dict[int, int] = {}
        self._seq = 0
        self._durable_seq = 0
        self._closed = False

        self._reclaimed = metrics.counter("store_gc_reclaimed_bytes_total")

        seg_ids = sorted(
            int(p.name[6:-4])
            for p in self.dir.iterdir()
            if p.name.startswith("store-") and p.name.endswith(".seg")
        )
        for seg_id in seg_ids:
            self._segs[seg_id] = self.dir / f"store-{seg_id}.seg"
        if seg_ids:
            # Only the highest-id segment can have a torn tail (it was the
            # append target at crash time); cut it before replay.
            cut_torn_tail(self._segs[seg_ids[-1]])
        for seg_id in seg_ids:
            self._replay_segment(seg_id)
        if self._gc_low:
            # Re-apply the newest persisted GC watermark: dead entries in
            # surviving segments must stay dead across a restart.
            low = self._gc_low
            self._requests = {
                k: v
                for k, v in self._requests.items()
                if k[1] >= low.get(k[0], 0)
            }
            self._allocations = {
                k: v
                for k, v in self._allocations.items()
                if k[1] >= low.get(k[0], 0)
            }

        self._active_id = (seg_ids[-1] if seg_ids else 0) + 1
        active_path = self.dir / f"store-{self._active_id}.seg"
        self._segs[self._active_id] = active_path
        self._active_fh = open(active_path, "ab")
        self._active_size = 0
        fsync_dir(self.dir)

    def _replay_segment(self, seg_id: int) -> None:
        # __init__ only; later records override earlier ones (same
        # last-write-wins the sqlite store gets from INSERT OR REPLACE).
        with self._lock:
            data = self._segs[seg_id].read_bytes()
            for tag, payload, start, end in iter_records(data):
                head = end - start - len(payload)
                if tag == TAG_REQUEST:
                    cid, req_no, digest, data_off, data_len = _decode_request(payload)
                    self._requests[(cid, req_no, digest)] = (
                        seg_id, start + head + data_off, data_len, end - start,
                    )
                elif tag == TAG_ALLOCATION:
                    cid, req_no, digest = _decode_allocation(payload)
                    self._allocations[(cid, req_no)] = (digest, seg_id, end - start)
                elif tag == TAG_WATERMARK:
                    self._gc_low = _decode_watermark(payload)

    # --- append path (callers hold self._lock; RLock re-entry is free) ---

    def _append(self, tag: int, payload: bytes) -> Tuple[int, int, int]:
        """Append one record to the active segment; returns
        ``(seg_id, payload_file_off, rec_len)``."""
        with self._lock:
            if self._active_size >= self.segment_max_bytes:
                self._rotate()
            frame = encode_record(tag, payload)
            seg_id = self._active_id
            payload_off = self._active_size + (len(frame) - len(payload))
            self._active_fh.write(frame)
            self._active_size += len(frame)
            self._seq += 1
            return seg_id, payload_off, len(frame)

    def _rotate(self) -> None:
        with self._lock:
            self._active_fh.flush()
            os.fsync(self._active_fh.fileno())
            self._active_fh.close()
            self._active_id += 1
            path = self.dir / f"store-{self._active_id}.seg"
            self._segs[self._active_id] = path
            self._active_fh = open(path, "ab")
            self._active_size = 0
            fsync_dir(self.dir)

    def _read(self, seg_id: int, off: int, length: int) -> bytes:
        with self._lock:
            if seg_id == self._active_id:
                self._active_fh.flush()
            with open(self._segs[seg_id], "rb") as fh:
                fh.seek(off)
                return fh.read(length)

    # --- RequestStore protocol ---

    def put_request(self, ack: RequestAck, data: bytes) -> None:
        payload, data_off = _encode_request(ack, data)
        with self._lock:
            seg_id, payload_off, rec_len = self._append(TAG_REQUEST, payload)
            self._requests[(ack.client_id, ack.req_no, ack.digest)] = (
                seg_id, payload_off + data_off, len(data), rec_len,
            )

    def get_request(self, ack: RequestAck) -> Optional[bytes]:
        with self._lock:
            loc = self._requests.get((ack.client_id, ack.req_no, ack.digest))
            if loc is None:
                return None
            seg_id, data_off, data_len, _ = loc
            return self._read(seg_id, data_off, data_len)

    def put_allocation(self, client_id: int, req_no: int, digest: bytes) -> None:
        payload = _encode_allocation(client_id, req_no, digest)
        with self._lock:
            seg_id, _, rec_len = self._append(TAG_ALLOCATION, payload)
            self._allocations[(client_id, req_no)] = (digest, seg_id, rec_len)

    def get_allocation(self, client_id: int, req_no: int) -> Optional[bytes]:
        with self._lock:
            loc = self._allocations.get((client_id, req_no))
            return loc[0] if loc is not None else None

    def sync(self) -> None:
        """Durability barrier with group fsync: the lock holder fsyncs for
        everything appended so far, so callers that queued behind it find
        ``_durable_seq`` already past their writes and return without
        touching the device."""
        with self._lock:
            if self._closed:
                raise ValueError("request store is closed")
            if self._durable_seq >= self._seq:
                return
            target = self._seq
            self._active_fh.flush()
            os.fsync(self._active_fh.fileno())
            self._durable_seq = target

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._active_fh.flush()
            os.fsync(self._active_fh.fileno())
            self._active_fh.close()

    # --- checkpoint-keyed GC ---

    def note_checkpoint(self, index: int, watermarks: Dict[int, int]) -> None:
        """Record per-client low watermarks carried by the checkpoint entry
        persisted at WAL ``index`` (not yet authoritative — the checkpoint
        may never become stable)."""
        with self._lock:
            self._watermarks[index] = dict(watermarks)

    def gc(self, index: int) -> int:
        """Compact using the newest noted checkpoint at or below WAL
        ``index`` — called when the state machine truncates its log there,
        i.e. once that checkpoint is stable.  Returns bytes reclaimed."""
        with self._lock:
            noted = [i for i in self._watermarks if i <= index]
            if not noted:
                return 0
            anchor = max(noted)
            watermarks = self._watermarks[anchor]
            for i in noted:
                if i != anchor:
                    del self._watermarks[i]

            # Persist the applied watermark before any compaction so a
            # replay filters the same dead set this pass drops.
            self._gc_low = dict(watermarks)
            self._append(TAG_WATERMARK, _encode_watermark(watermarks))

            def dead(client_id: int, req_no: int) -> bool:
                low = watermarks.get(client_id)
                return low is not None and req_no < low

            self._requests = {
                k: v for k, v in self._requests.items() if not dead(k[0], k[1])
            }
            self._allocations = {
                k: v for k, v in self._allocations.items() if not dead(k[0], k[1])
            }

            # Per-segment live accounting over the sealed segments.
            live_bytes: Dict[int, int] = {
                seg_id: 0 for seg_id in self._segs if seg_id != self._active_id
            }
            live_reqs: Dict[int, List[Tuple[int, int, bytes]]] = {}
            live_allocs: Dict[int, List[Tuple[int, int]]] = {}
            for key, (seg_id, _, _, rec_len) in self._requests.items():
                if seg_id in live_bytes:
                    live_bytes[seg_id] += rec_len
                    live_reqs.setdefault(seg_id, []).append(key)
            for key, (_, seg_id, rec_len) in self._allocations.items():
                if seg_id in live_bytes:
                    live_bytes[seg_id] += rec_len
                    live_allocs.setdefault(seg_id, []).append(key)

            reclaimed = 0
            victims = []
            for seg_id, live in live_bytes.items():
                size = self._segs[seg_id].stat().st_size
                if size == 0 or live == 0 or live <= size // 2:
                    victims.append((seg_id, size))
            moved = 0
            for seg_id, size in sorted(victims):
                for key in live_reqs.get(seg_id, []):
                    old_seg, data_off, data_len, _ = self._requests[key]
                    data = self._read(old_seg, data_off, data_len)
                    payload, doff = _encode_request(
                        RequestAck(client_id=key[0], req_no=key[1], digest=key[2]),
                        data,
                    )
                    new_seg, payload_off, rec_len = self._append(TAG_REQUEST, payload)
                    self._requests[key] = (
                        new_seg, payload_off + doff, data_len, rec_len,
                    )
                    moved += rec_len
                for key in live_allocs.get(seg_id, []):
                    digest, _, _ = self._allocations[key]
                    payload = _encode_allocation(key[0], key[1], digest)
                    new_seg, _, rec_len = self._append(TAG_ALLOCATION, payload)
                    self._allocations[key] = (digest, new_seg, rec_len)
                    moved += rec_len
            if not victims:
                return 0
            # Rewritten entries must be durable before the originals
            # vanish, and the unlinks must be durable before we report
            # the space reclaimed.
            self._active_fh.flush()
            os.fsync(self._active_fh.fileno())
            self._durable_seq = self._seq
            for seg_id, size in victims:
                self._segs[seg_id].unlink()
                del self._segs[seg_id]
                reclaimed += size
            fsync_dir(self.dir)
            reclaimed -= moved
            if reclaimed > 0:
                self._reclaimed.inc(reclaimed)
            return max(reclaimed, 0)
