"""Flight-recorder journal: segmented, CRC-framed, bounded event logs.

The always-on successor to the single-gzip-stream ``record.Recorder``
(docs/OBSERVABILITY.md "Flight recorder").  Each boot of a node appends
``seg-<boot>-<index>.evj`` files under ``<node_dir>/journal/``, framed with
the storage engine's CRC record shape (``storage/segments.py``), so a
SIGKILL mid-write costs exactly the torn tail (``cut_torn_tail``) and a
flipped bit is caught by the CRC, never decoded.

Record tags inside a segment::

    TAG_BOOT        uvarint(node_id) || uvarint(boot) || uvarint(seg_index)
    TAG_EVENT       wire.encode(RecordedEvent)
    TAG_TRACE       uvarint(trace_id)   -- annotates the NEXT TAG_EVENT
    TAG_CHECKPOINT  uvarint(seq_no)     -- stable checkpoint / state transfer
    TAG_GAP         uvarint(count)      -- events dropped under overflow

``RecordedEvent``'s wire shape is frozen (append-only registry), so the
fleet trace-id annotation lives in the journal framing — a ``TAG_TRACE``
record ahead of the event — not inside the event itself.

Bounding is two-fold, mirroring ``logstore.py`` GC:

* **Rotation** by bytes: a segment past ``rotate_bytes`` is sealed
  (fsync + close) and a fresh one opened.
* **Retention** keyed to stable checkpoints: sealed segments strictly
  older than the segment holding the ``retain_checkpoints``-th most
  recent ``TAG_CHECKPOINT`` marker are deleted, and boots older than the
  ``retain_boots`` most recent are pruned at startup.  A reader sees a
  pruned head as ``pruned`` (partial history), never as divergence.

Overflow never blocks consensus: :class:`JournalRecorder.intercept` is a
``put_nowait`` and, on a full queue, drops the *oldest* buffered record
(``eventlog_dropped_events_total``) so the journal keeps the most recent
window; the writer thread inserts a ``TAG_GAP`` marker so replay tooling
knows the boot is gapped instead of silently divergent.
"""

from __future__ import annotations

import os
import queue
import threading
import time as _time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from .. import metrics as metrics_mod
from .. import state as st
from .. import wire
from ..messages import RequestAck
from ..storage import segments
from .record import _strip_request_data, read_event_log

JOURNAL_DIRNAME = "journal"
SEGMENT_EXT = ".evj"

TAG_BOOT = 1
TAG_EVENT = 2
TAG_TRACE = 3
TAG_CHECKPOINT = 4
TAG_GAP = 5
# Observer plane: an applied committed-batch journal line (observers have
# no state machine, so their flight record is the applied stream itself):
# uvarint(seq_no) || utf-8 commit line.
TAG_APPLY = 6

DEFAULT_ROTATE_BYTES = 512 * 1024
DEFAULT_RETAIN_CHECKPOINTS = 3
DEFAULT_RETAIN_BOOTS = 3


def _uvarint(value: int) -> bytes:
    buf = bytearray()
    wire.write_uvarint(buf, value)
    return bytes(buf)


def _read_uvarint(payload: bytes) -> int:
    value, _ = wire.read_uvarint(memoryview(payload), 0)
    return value


def _segment_name(boot: int, index: int) -> str:
    return f"seg-{boot:03d}-{index:06d}{SEGMENT_EXT}"


def _segment_files(dir_path: Path) -> List[Tuple[int, int, Path]]:
    """Sorted ``(boot, index, path)`` for every journal segment file."""
    out: List[Tuple[int, int, Path]] = []
    if not dir_path.is_dir():
        return out
    for path in sorted(dir_path.glob(f"seg-*{SEGMENT_EXT}")):
        parts = path.name[: -len(SEGMENT_EXT)].split("-")
        if len(parts) != 3:
            continue
        try:
            out.append((int(parts[1]), int(parts[2]), path))
        except ValueError:
            continue
    out.sort(key=lambda t: (t[0], t[1]))
    return out


class SegmentSink:
    """Synchronous segmented record sink: rotation by bytes, retention
    keyed to checkpoint markers.  Single-writer by contract (the
    recorder's writer thread, or the observer's apply loop), so it needs
    no lock."""

    def __init__(
        self,
        dir_path: Path,
        node_id: int,
        *,
        boot: Optional[int] = None,
        rotate_bytes: int = DEFAULT_ROTATE_BYTES,
        retain_checkpoints: int = DEFAULT_RETAIN_CHECKPOINTS,
        retain_boots: int = DEFAULT_RETAIN_BOOTS,
        registry: Optional[metrics_mod.Registry] = None,
    ):
        self.dir = Path(dir_path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.node_id = node_id
        self.rotate_bytes = rotate_bytes
        self.retain_checkpoints = retain_checkpoints
        self.retain_boots = retain_boots
        registry = (
            registry if registry is not None else metrics_mod.default_registry
        )
        self._bytes_total = registry.counter(
            "eventlog_bytes_total", labels={"node": str(node_id)}
        )

        existing = _segment_files(self.dir)
        prior_boots = sorted({b for b, _, _ in existing})
        if boot is None:
            boot = prior_boots[-1] + 1 if prior_boots else 0
        self.boot = boot
        # A crash can only tear the last segment of the last prior boot;
        # cutting it here means every later reader scans a clean file.
        if prior_boots:
            last_boot_files = [p for b, _, p in existing if b == prior_boots[-1]]
            try:
                segments.cut_torn_tail(last_boot_files[-1])
            except OSError:
                pass  # read-only media: readers still stop at the tear
        # Boot retention: keep the newest (retain_boots - 1) prior boots.
        keep_from = (
            prior_boots[-(self.retain_boots - 1)]
            if self.retain_boots > 1 and len(prior_boots) >= self.retain_boots
            else (boot if self.retain_boots <= 1 else -1)
        )
        pruned_any = False
        for b, _, path in existing:
            if b < keep_from:
                try:
                    path.unlink()
                    pruned_any = True
                except OSError:
                    pass
        if pruned_any:
            segments.fsync_dir(self.dir)

        self._seg_index = 0
        self._seg_bytes = 0
        self._file = None
        # (seq_no, seg_index) of recent checkpoint markers; retention floor.
        self._checkpoint_marks: List[Tuple[int, int]] = []
        self._open_segment()

    # -- segment lifecycle --------------------------------------------------

    def _open_segment(self) -> None:
        path = self.dir / _segment_name(self.boot, self._seg_index)
        self._file = open(path, "ab")
        self._seg_bytes = 0
        header = (
            _uvarint(self.node_id)
            + _uvarint(self.boot)
            + _uvarint(self._seg_index)
        )
        self._write(TAG_BOOT, header)

    def _seal_segment(self) -> None:
        self._file.flush()
        try:
            os.fsync(self._file.fileno())
        except OSError:
            pass
        self._file.close()

    def _rotate(self) -> None:
        self._seal_segment()
        self._seg_index += 1
        self._open_segment()
        segments.fsync_dir(self.dir)

    def _write(self, tag: int, payload: bytes) -> None:
        record = segments.encode_record(tag, payload)
        self._file.write(record)
        self._seg_bytes += len(record)
        self._bytes_total.inc(len(record))

    # -- public api ---------------------------------------------------------

    def append(self, tag: int, payload: bytes) -> None:
        self._write(tag, payload)
        if self._seg_bytes >= self.rotate_bytes:
            self._rotate()

    def note_checkpoint(self, seq_no: int) -> None:
        """Record a stable-checkpoint marker and apply retention: sealed
        segments strictly older than the ``retain_checkpoints``-th most
        recent marker's segment are history the checkpoint already
        covers."""
        self.append(TAG_CHECKPOINT, _uvarint(seq_no))
        self._checkpoint_marks.append((seq_no, self._seg_index))
        if len(self._checkpoint_marks) < self.retain_checkpoints:
            return
        self._checkpoint_marks = self._checkpoint_marks[
            -self.retain_checkpoints :
        ]
        floor_seg = self._checkpoint_marks[0][1]
        removed = False
        for b, index, path in _segment_files(self.dir):
            if b == self.boot and index < floor_seg:
                try:
                    path.unlink()
                    removed = True
                except OSError:
                    pass
        if removed:
            segments.fsync_dir(self.dir)

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._seal_segment()


class JournalRecorder:
    """Async flight recorder implementing the processor's
    ``EventInterceptor`` protocol over a :class:`SegmentSink`.

    The hot-path ``intercept`` is a non-blocking enqueue: on overflow the
    oldest buffered record is dropped (counted in
    ``eventlog_dropped_events_total``) and the writer inserts a TAG_GAP
    marker, so a slow disk degrades the journal, never consensus.  When a
    ``trace_lookup`` callable is bound (``Node`` binds its trace-binding
    LRU automatically), recorded ``EventStep``s that name a request carry
    the request's fleet trace id as a TAG_TRACE annotation.
    """

    def __init__(
        self,
        node_dir,
        node_id: int,
        *,
        time_source: Optional[Callable[[], int]] = None,
        retain_request_data: bool = True,
        buffer_size: int = 5000,
        rotate_bytes: int = DEFAULT_ROTATE_BYTES,
        retain_checkpoints: int = DEFAULT_RETAIN_CHECKPOINTS,
        retain_boots: int = DEFAULT_RETAIN_BOOTS,
        registry: Optional[metrics_mod.Registry] = None,
    ):
        self.node_id = node_id
        # Default wall-clock ms mirrors record.Recorder; deployments pass a
        # monotonic source so the doctor's replay clock is restart-safe.
        # mirlint: allow(wall-clock) — timestamp metadata, never ordering
        self.time_source = time_source or (lambda: int(_time.time() * 1000))
        self.retain_request_data = retain_request_data
        # None is reserved as the shutdown sentinel; Node.__init__ binds
        # its (client_id, req_no) -> trace id LRU here when it sees the
        # attribute (docs/OBSERVABILITY.md "Fleet plane").
        self.trace_lookup: Optional[Callable[[int, int], Optional[int]]] = None
        self.dropped_events = 0  # producer-side ledger (tests, reports)
        registry = (
            registry if registry is not None else metrics_mod.default_registry
        )
        self._dropped = registry.counter(
            "eventlog_dropped_events_total", labels={"node": str(node_id)}
        )
        self._sink = SegmentSink(
            Path(node_dir) / JOURNAL_DIRNAME,
            node_id,
            rotate_bytes=rotate_bytes,
            retain_checkpoints=retain_checkpoints,
            retain_boots=retain_boots,
            registry=registry,
        )
        self.boot = self._sink.boot
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        # Overflow accounting without a lock: _gap_noted is written only by
        # the producer (intercept), _gap_acked only by the writer thread.
        self._gap_noted = 0
        self._gap_acked = 0
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- hot path -----------------------------------------------------------

    def _trace_of(self, event: st.Event) -> int:
        lookup = self.trace_lookup
        if lookup is None or not isinstance(event, st.EventStep):
            return 0
        msg = event.msg
        ack = getattr(msg, "request_ack", None)
        if ack is None and isinstance(msg, RequestAck):
            ack = msg
        if ack is None:
            return 0
        try:
            return lookup(ack.client_id, ack.req_no) or 0
        except Exception:
            return 0  # a racing LRU eviction only costs the annotation

    def intercept(self, event: st.Event) -> None:
        if self._error is not None:
            raise RuntimeError("event recorder failed") from self._error
        if self._done.is_set() or self._stopped:
            raise RuntimeError("event recorder already stopped")
        if not self.retain_request_data:
            event = _strip_request_data(event)
        item = (
            st.RecordedEvent(
                node_id=self.node_id,
                time=self.time_source(),
                state_event=event,
            ),
            self._trace_of(event),
        )
        try:
            self._queue.put_nowait(item)
            return
        except queue.Full:
            pass
        # Overflow: evict the oldest buffered record to keep the most
        # recent window — the hot path must never wait on the writer.
        try:
            victim = self._queue.get_nowait()
            if victim is None:
                # Never swallow the shutdown sentinel (stop() race).
                try:
                    self._queue.put_nowait(None)
                except queue.Full:
                    pass
            else:
                self._gap_noted += 1
                self.dropped_events += 1
                self._dropped.inc()
        except queue.Empty:
            pass
        try:
            self._queue.put_nowait(item)
        except queue.Full:  # lost the race for the freed slot: drop new
            self._gap_noted += 1
            self.dropped_events += 1
            self._dropped.inc()

    # -- writer thread ------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    break
                gap = self._gap_noted - self._gap_acked
                if gap > 0:
                    self._gap_acked += gap
                    self._sink.append(TAG_GAP, _uvarint(gap))
                record, trace_id = item
                if trace_id:
                    self._sink.append(TAG_TRACE, _uvarint(trace_id))
                self._sink.append(TAG_EVENT, wire.encode(record))
                event = record.state_event
                if isinstance(event, st.EventCheckpointResult):
                    self._sink.note_checkpoint(event.seq_no)
                elif isinstance(event, st.EventStateTransferComplete):
                    # Journal hand-off on snapshot state transfer: the jump
                    # target is a retention anchor and tells the audit the
                    # replay baseline moved (no divergence across the gap).
                    self._sink.note_checkpoint(event.seq_no)
        except BaseException as e:  # surfaced on next intercept/stop
            self._error = e
        finally:
            try:
                self._sink.close()
            except BaseException as e:
                if self._error is None:
                    self._error = e
            self._done.set()

    def stop(self) -> None:
        """Flush and seal; the recorder cannot be used afterwards."""
        self._stopped = True
        while not self._done.is_set():
            try:
                self._queue.put(None, timeout=0.1)
                break
            except queue.Full:
                continue  # writer died or is draining; re-check _done
        self._done.wait()
        if self._error is not None:
            raise RuntimeError("event recorder failed") from self._error


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


@dataclass
class BootLog:
    """One boot's worth of journal evidence, decoded and classified."""

    boot: int
    source: str  # "journal" | "legacy"
    paths: List[Path] = field(default_factory=list)
    # (record, trace_id) in append order; trace_id 0 when unannotated.
    records: List[Tuple[st.RecordedEvent, int]] = field(default_factory=list)
    # Observer journals: (seq_no, commit line) applied-batch stream.
    applies: List[Tuple[int, str]] = field(default_factory=list)
    checkpoints: List[int] = field(default_factory=list)
    dropped: int = 0  # events lost to overflow (TAG_GAP sums)
    torn: bool = False  # a tail was cut short by a crash
    crc_damage: bool = False  # a record failed its checksum
    pruned: bool = False  # retention removed the head of this boot
    error: Optional[str] = None


def _read_journal_boot(boot: int, files: List[Tuple[int, Path]]) -> BootLog:
    log = BootLog(boot=boot, source="journal")
    first_index: Optional[int] = None
    for index, path in files:
        log.paths.append(path)
        if first_index is None:
            first_index = index
        try:
            data = path.read_bytes()
        except OSError as exc:
            log.error = f"{path}: {exc}"
            continue
        _, reason = segments.valid_prefix(data)
        if reason == segments.SCAN_TORN:
            log.torn = True
        elif reason == segments.SCAN_CRC:
            log.crc_damage = True
        pending_trace = 0
        for tag, payload, _, _ in segments.iter_records(data):
            if tag == TAG_EVENT:
                try:
                    record = wire.decode(payload)
                except ValueError as exc:
                    log.error = f"{path}: {exc}"
                    pending_trace = 0
                    continue
                if isinstance(record, st.RecordedEvent):
                    log.records.append((record, pending_trace))
                pending_trace = 0
            elif tag == TAG_TRACE:
                pending_trace = _read_uvarint(payload)
            elif tag == TAG_APPLY:
                view = memoryview(payload)
                seq, pos = wire.read_uvarint(view, 0)
                log.applies.append((seq, bytes(view[pos:]).decode()))
            elif tag == TAG_CHECKPOINT:
                log.checkpoints.append(_read_uvarint(payload))
            elif tag == TAG_GAP:
                log.dropped += _read_uvarint(payload)
            # TAG_BOOT is self-describing; unknown tags skip forward-compat.
    log.pruned = bool(first_index)
    return log


def _read_legacy_boot(boot: int, path: Path) -> BootLog:
    log = BootLog(boot=boot, source="legacy", paths=[path])
    try:
        with open(path, "rb") as f:
            for record in read_event_log(f):
                log.records.append((record, 0))
    except Exception as exc:  # torn gzip / partial frame after SIGKILL
        log.torn = True
        log.error = f"{path}: {exc!r}"
    return log


def load_boots(node_dir) -> List[BootLog]:
    """Every boot's journal under ``node_dir``, oldest first.

    Reads both layouts: legacy ``events-<boot>.gz`` single-stream logs and
    the segmented ``journal/`` directory.  Torn tails come back clean-cut
    (``torn=True``, nothing decoded past the tear) — a crash is evidence,
    never an error."""
    node_dir = Path(node_dir)
    out: List[BootLog] = []
    for path in sorted(node_dir.glob("events-*.gz")):
        try:
            boot = int(path.name[len("events-") : -len(".gz")])
        except ValueError:
            boot = len(out)
        out.append(_read_legacy_boot(boot, path))
    by_boot: dict = {}
    for boot, index, path in _segment_files(node_dir / JOURNAL_DIRNAME):
        by_boot.setdefault(boot, []).append((index, path))
    for boot in sorted(by_boot):
        out.append(_read_journal_boot(boot, sorted(by_boot[boot])))
    return out


def journal_bytes(node_dir) -> int:
    """Total on-disk journal footprint for one node directory."""
    total = 0
    for _, _, path in _segment_files(Path(node_dir) / JOURNAL_DIRNAME):
        try:
            total += path.stat().st_size
        except OSError:
            pass
    return total
