"""Group-commit segmented WAL (L4): fsync batching behind the WAL barrier.

``simplewal.py`` is correct but pays one ``write``+``fsync`` round trip per
``sync()`` call on the calling thread.  Under concurrent durability traffic
(several worker categories, several nodes sharing a disk, the storage
bench's appender fleet) those fsyncs serialize at device latency.  This
engine keeps the exact ``processor.WAL`` contract — ``sync()`` returns only
when every prior ``write``/``truncate`` is durable — but moves the disk
work to a dedicated **syncer thread**:

* ``write``/``truncate`` append an operation to a lock-guarded buffer and
  return immediately (appends are not durable until a ``sync``).
* ``sync`` takes a ticket for the operations buffered so far, wakes the
  syncer, and blocks until the ticket is durable.
* The syncer drains the whole buffer at once — every record lands in one
  ``write`` — and issues a **single fsync** for the batch, then releases
  every waiter whose ticket it covered.  Concurrent ``sync`` calls
  coalesce into one device round trip (group commit).
* An **adaptive batch window** (measure-then-adapt in the spirit of
  ``testengine.crypto.WaveController``) delays the flush a few hundred
  microseconds only while lingering demonstrably gathers committers
  that the fsync round trip itself would not have — collapsing to zero
  (no latency tax) for a lone writer or when arrivals already coalesce
  naturally during the flush.

On disk this is a directory of ``seg-<first_index>.wal`` segment files of
CRC-framed records (``storage/segments.py``), rotated at
``segment_max_bytes``, with the same lazy front-truncation and ``lowmark``
bookkeeping as ``simplewal`` — plus directory fsyncs after every segment
create/unlink so recovery can trust the directory listing.  Recovery cuts
any torn or corrupt tail off the active segment before appending.

Metrics (docs/OBSERVABILITY.md "Storage engine"): ``wal_append_bytes_total``,
``wal_fsync_seconds``, ``wal_group_commit_size``.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from .. import metrics, wire
from ..messages import Persistent
from .segments import (
    SCAN_CLEAN,
    SCAN_CRC,
    cut_torn_tail,
    encode_record,
    fsync_dir,
    iter_records,
    valid_prefix,
)

_LOW_MARK_FILE = "lowmark"

# Shared-state declaration for mirlint's lock-discipline pass: the op
# buffer and ticket counters are filled by node worker threads and drained
# by the syncer thread, so every touch happens under the condition
# (docs/STATIC_ANALYSIS.md).  The file handle and active-segment path are
# syncer-owned after __init__ and stay out of the map.
MIRLINT_SHARED_STATE = {
    "GroupCommitWAL._pending": "_cond",
    "GroupCommitWAL._ops": "_cond",
    "GroupCommitWAL._durable_ops": "_cond",
    "GroupCommitWAL._sync_waiting": "_cond",
    "GroupCommitWAL._release": "_cond",
    "GroupCommitWAL._active_est": "_cond",
    "GroupCommitWAL._have_active": "_cond",
    "GroupCommitWAL._next_index": "_cond",
    "GroupCommitWAL._low_index": "_cond",
    "GroupCommitWAL._closing": "_cond",
    "GroupCommitWAL._syncer_error": "_cond",
}


class _BatchWindow:
    """Adaptive group-commit window: how long the syncer lingers before
    flushing, hoping more committers join the batch.  Measure-then-adapt
    in the spirit of ``WaveController`` (testengine/crypto.py), keyed to
    the one signal that matters: did lingering actually gather waiters
    the fsync itself would not have?  Committers that arrive DURING a
    flush coalesce for free, so a sleep only pays off when arrivals are
    staggered relative to the device round trip.  The window doubles
    while each linger demonstrably gathers extra waiters, collapses to
    zero the moment one doesn't (with a cooldown before re-probing), and
    a lone writer never sleeps at all."""

    __slots__ = ("window_s", "floor_s", "ceiling_s", "_ceiling_cfg", "_cooldown")

    def __init__(
        self,
        initial_s: float = 0.0,
        floor_s: float = 0.0002,
        ceiling_s: float = 0.002,
    ):
        self.window_s = initial_s
        self.floor_s = floor_s
        self.ceiling_s = ceiling_s
        self._ceiling_cfg = ceiling_s
        self._cooldown = 0

    def note_fsync(self, seconds: float) -> None:
        """Cap the window at half the device's observed fsync cost: a
        linger longer than that costs more than the fsync it would save,
        no matter how well it coalesces."""
        self.ceiling_s = min(self._ceiling_cfg, max(0.0, seconds * 0.5))
        if self.window_s > self.ceiling_s:
            self.window_s = self.ceiling_s

    def propose(self, waiters: int) -> float:
        """Seconds to linger before grabbing a batch with ``waiters``
        committers already blocked on it."""
        if self.window_s > 0.0:
            return self.window_s
        if waiters >= 2 and self._cooldown == 0:
            return self.floor_s  # probe: would lingering gather more?
        if self._cooldown:
            self._cooldown -= 1
        return 0.0

    def observe(self, slept_s: float, gathered: int) -> None:
        """``gathered`` = waiters that joined while the syncer slept."""
        if slept_s <= 0.0:
            return
        if gathered > 0:
            self.window_s = min(
                self.ceiling_s, max(slept_s * 2, self.floor_s)
            )
        else:
            self.window_s = 0.0
            self._cooldown = 8


class _BatchRelease:
    """One batch's completion signal.  ``durable``/``error`` are written
    by the syncer before ``event.set()`` and read by waiters only after
    ``event.wait()`` returns — the Event provides the happens-before, so
    released committers never touch the WAL lock on the way out (a
    notify_all there makes every group commit end in a serial convoy of
    lock reacquisitions, one per waiter)."""

    __slots__ = ("event", "durable", "error")

    def __init__(self):
        self.event = threading.Event()
        self.durable = 0
        self.error: Optional[BaseException] = None


class SyncTicket:
    """In-flight durability barrier (``GroupCommitWAL.sync_begin``): the
    registration half of ``sync()`` without the blocking half, so a caller
    can overlap further writes with the fsync and ``wait()`` later — the
    pipeline scheduler's WAL stage runs batch k+1's writes while batch k's
    fsync is on disk.  ``wait()`` returns once every op buffered before
    ``sync_begin`` is durable, or raises if the syncer failed."""

    __slots__ = ("_wal", "_ticket", "_first")

    def __init__(self, wal: "GroupCommitWAL", ticket: int, first):
        self._wal = wal
        self._ticket = ticket
        self._first = first

    def done(self) -> bool:
        """True when the ticket is already durable (never blocks)."""
        if self._first is None:
            return True
        return self._wal._ticket_done(self._ticket)

    def wait(self) -> None:
        if self._first is None:
            return
        self._wal._wait_ticket(self._ticket, self._first)
        self._first = None


class GroupCommitWAL:
    """File-backed ``processor.WAL`` with fsync-batched group commit."""

    def __init__(
        self,
        path: str,
        segment_max_bytes: int = 4 * 1024 * 1024,
        batch_window: Optional[_BatchWindow] = None,
    ):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_max_bytes = segment_max_bytes

        # Two conditions over ONE lock: committers wait on _cond for
        # durability, the syncer waits on _work for work — so a sync()
        # enqueue wakes only the syncer, never the other blocked
        # committers (notify_all there is O(waiters) spurious wakeups per
        # append).  Uniformly entered via ``with self._cond`` (the shared
        # lock) so the lock-discipline map stays single-named.
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._work = threading.Condition(self._lock)
        # Op buffer: ("rec", frame-bytes) | ("rotate", first_index) |
        # ("truncate", index).  Tickets count ops ever buffered / made
        # durable; sync(ticket) returns once _durable_ops covers it.
        self._pending: List[Tuple[str, object]] = []
        self._ops = 0
        self._durable_ops = 0
        self._sync_waiting = 0
        self._release = _BatchRelease()
        self._closing = False
        self._syncer_error: Optional[BaseException] = None

        self._low_index = self._read_low_mark()
        self._next_index: Optional[int] = None

        # Syncer-owned file state (single-threaded after this point).
        self._fh = None
        self._active_path: Optional[Path] = None
        self._window = batch_window if batch_window else _BatchWindow()

        segments = self._segments()
        self._have_active = bool(segments)
        self._active_est = 0
        if segments:
            # Reopening after a crash: cut any torn/corrupt tail BEFORE
            # appending, or new frames land after garbage and are lost.
            _, self._active_path = segments[-1]
            self._active_est = cut_torn_tail(self._active_path)
            self._fh = open(self._active_path, "ab")

        self._append_bytes = metrics.counter("wal_append_bytes_total")
        self._batch_size = metrics.histogram("wal_group_commit_size")

        self._syncer = threading.Thread(
            target=self._syncer_loop, name="wal-syncer", daemon=True
        )
        self._syncer.start()

    # --- low-watermark bookkeeping (syncer side) ---

    def _read_low_mark(self) -> int:
        mark = self.dir / _LOW_MARK_FILE
        if mark.exists():
            return int(mark.read_text())
        return 1

    def _write_low_mark(self, index: int) -> None:
        tmp = self.dir / (_LOW_MARK_FILE + ".tmp")
        tmp.write_text(str(index))
        os.replace(tmp, self.dir / _LOW_MARK_FILE)
        fsync_dir(self.dir)

    def _segments(self) -> List[Tuple[int, Path]]:
        segments = []
        for entry in self.dir.iterdir():
            if entry.name.startswith("seg-") and entry.name.endswith(".wal"):
                segments.append((int(entry.name[4:-4]), entry))
        return sorted(segments)

    # --- WAL protocol (caller side) ---

    def write(self, index: int, entry: Persistent) -> None:
        payload = wire.encode(entry)
        frame = encode_record(index, payload)
        with self._cond:
            self._check_open()
            if self._next_index is not None and index != self._next_index:
                raise ValueError(
                    f"WAL out of order: expected index {self._next_index}, "
                    f"got {index}"
                )
            if (
                not self._have_active
                or self._active_est >= self.segment_max_bytes
            ):
                self._pending.append(("rotate", index))
                self._ops += 1
                self._have_active = True
                self._active_est = 0
            self._pending.append(("rec", frame))
            self._ops += 1
            self._active_est += len(frame)
            self._next_index = index + 1
        self._append_bytes.inc(len(payload))

    def truncate(self, index: int) -> None:
        """Logically drop entries below ``index``; whole segments entirely
        below it are unlinked by the syncer at the next flush."""
        with self._cond:
            self._check_open()
            if index < self._low_index:
                raise ValueError(
                    f"truncate to {index} below low index {self._low_index}"
                )
            self._low_index = index
            self._pending.append(("truncate", index))
            self._ops += 1

    def sync(self) -> None:
        """Durability barrier: block until every op buffered before this
        call has been written and fsynced (one group fsync may cover many
        concurrent callers)."""
        self.sync_begin().wait()

    def sync_begin(self) -> SyncTicket:
        """Register a durability barrier without blocking: takes a ticket
        for the ops buffered so far and wakes the syncer, exactly like
        ``sync()``, but returns a ``SyncTicket`` instead of waiting — the
        in-flight/complete notification surface the pipeline scheduler
        overlaps WAL writes with fsyncs through.  ``sync()`` is
        ``sync_begin().wait()``."""
        with self._cond:
            self._check_open()
            ticket = self._ops
            if self._durable_ops >= ticket:
                return SyncTicket(self, ticket, None)
            self._sync_waiting += 1
            release = self._release
            self._work.notify()
        return SyncTicket(self, ticket, release)

    def _ticket_done(self, ticket: int) -> bool:
        with self._cond:
            if self._syncer_error is not None:
                return True  # wait() will raise; don't report in-flight
            return self._durable_ops >= ticket

    def _wait_ticket(self, ticket: int, release: _BatchRelease) -> None:
        while True:
            release.event.wait()
            if release.error is not None:
                raise RuntimeError("WAL syncer failed") from release.error
            if release.durable >= ticket:
                return
            # Our ops rode a batch that was already in flight when we
            # registered; wait for the next release to cover the ticket.
            with self._cond:
                self._check_open()
                release = self._release

    def load_all(self, for_each: Callable[[int, Persistent], None]) -> None:
        self.sync()  # everything buffered must be visible to the scan
        with self._cond:
            low_index = self._low_index
        records: List[Tuple[int, bytes]] = []
        for _, path in self._segments():
            for index, payload, _, _ in iter_records(path.read_bytes()):
                if index >= low_index:
                    records.append((index, payload))
        records.sort(key=lambda r: r[0])
        expected = None
        for index, payload in records:
            if expected is not None and index != expected:
                raise ValueError(
                    f"WAL gap: expected index {expected}, found {index}"
                )
            for_each(index, wire.decode(payload))
            expected = index + 1
        if expected is not None:
            with self._cond:
                self._next_index = expected

    def close(self) -> None:
        with self._cond:
            if self._closing:
                return
            self._closing = True
            self._work.notify()
        self._syncer.join()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def _check_open(self) -> None:
        # Every caller holds self._cond — the guard is real, just not
        # lexical from this helper's point of view.
        if self._closing:  # mirlint: allow(lock-discipline)
            raise ValueError("WAL is closed")
        if self._syncer_error is not None:  # mirlint: allow(lock-discipline)
            raise RuntimeError("WAL syncer failed") from self._syncer_error  # mirlint: allow(lock-discipline)

    # --- syncer thread ---

    def _syncer_loop(self) -> None:
        release: Optional[_BatchRelease] = None
        try:
            while True:
                with self._cond:
                    # Flush only when a committer is actually waiting on
                    # durability (or at close): bare writes buffer in
                    # memory, exactly like simplewal's buffer in the OS
                    # page cache, and cost no fsync until a sync() lands.
                    while not self._closing and self._sync_waiting == 0:
                        self._work.wait()
                    if self._closing and not self._pending:
                        return
                    waiting_before = self._sync_waiting
                # Group-commit window: linger briefly (outside the lock)
                # iff the controller judges more committers would join.
                window = self._window.propose(waiting_before)
                if window > 0.0:
                    time.sleep(window)
                with self._cond:
                    batch = self._pending
                    self._pending = []
                    waiters = self._sync_waiting
                    self._sync_waiting = 0
                    release = self._release
                    self._release = _BatchRelease()
                records = self._apply_batch(batch)
                if records:
                    self._batch_size.observe(records)
                self._window.observe(window, waiters - waiting_before)
                with self._cond:
                    self._durable_ops += len(batch)
                    release.durable = self._durable_ops
                release.event.set()
        except BaseException as exc:  # propagate to callers, never die mute
            with self._cond:
                self._syncer_error = exc
                self._durable_ops = self._ops
                current = self._release
            # Force-release everyone: waiters on the in-flight batch (if
            # any) and waiters already registered on the next one.
            for rel in (release, current):
                if rel is not None:
                    rel.error = exc
                    rel.event.set()

    def _apply_batch(self, batch: List[Tuple[str, object]]) -> int:
        """Write every op of the batch, then make it durable with a single
        fsync.  Returns the number of records written."""
        records = 0
        for op, arg in batch:
            if op == "rec":
                self._fh.write(arg)
                records += 1
            elif op == "rotate":
                self._rotate(arg)
            else:  # "truncate"
                self._apply_truncate(arg)
        if batch and self._fh is not None:
            start = time.perf_counter()
            with metrics.timer("wal_fsync_seconds"):
                self._fh.flush()
                os.fsync(self._fh.fileno())
            self._window.note_fsync(time.perf_counter() - start)
        return records

    def _rotate(self, first_index: int) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        self._active_path = self.dir / f"seg-{first_index}.wal"
        self._fh = open(self._active_path, "ab")
        fsync_dir(self.dir)  # the new segment's dirent must survive a crash

    def _apply_truncate(self, index: int) -> None:
        self._write_low_mark(index)
        segments = self._segments()
        unlinked = False
        for i, (first, path) in enumerate(segments):
            next_first = segments[i + 1][0] if i + 1 < len(segments) else None
            if (
                next_first is not None
                and next_first <= index
                and path != self._active_path
            ):
                path.unlink()
                unlinked = True
        if unlinked:
            fsync_dir(self.dir)  # make the unlinks stick


def wal_segment_report(wal_dir: Path) -> dict:
    """Offline dump/verify of a WAL directory (the ``mircat --wal`` core):
    per-segment record counts, CRC/torn-tail status, and cross-segment
    index continuity above the lowmark.  Pure read-only."""
    wal_dir = Path(wal_dir)
    mark = wal_dir / _LOW_MARK_FILE
    low_index = int(mark.read_text()) if mark.exists() else 1
    segments = sorted(
        p for p in wal_dir.iterdir()
        if p.name.startswith("seg-") and p.name.endswith(".wal")
    )
    report = {
        "dir": str(wal_dir),
        "low_index": low_index,
        "segments": [],
        "problems": [],
    }
    indexes: List[int] = []
    for pos, path in enumerate(segments):
        data = path.read_bytes()
        valid, reason = valid_prefix(data)
        recs = list(iter_records(data))
        seg = {
            "name": path.name,
            "bytes": len(data),
            "valid_bytes": valid,
            "records": len(recs),
            "first_index": recs[0][0] if recs else None,
            "last_index": recs[-1][0] if recs else None,
            "status": reason,
        }
        report["segments"].append(seg)
        if reason == SCAN_CRC:
            report["problems"].append(
                f"{path.name}: CRC mismatch at byte {valid} "
                f"({len(data) - valid} bytes dropped)"
            )
        elif reason != SCAN_CLEAN and pos != len(segments) - 1:
            # A torn tail is expected only on the *active* (last) segment;
            # anywhere else it means a sealed segment lost bytes.
            report["problems"].append(
                f"{path.name}: torn tail in a sealed segment at byte {valid}"
            )
        indexes.extend(i for i, _, _, _ in recs)
    live = sorted(i for i in indexes if i >= low_index)
    for prev, cur in zip(live, live[1:]):
        if cur not in (prev, prev + 1):
            report["problems"].append(
                f"index gap: {prev} -> {cur} (entries lost above lowmark)"
            )
    report["live_records"] = len(live)
    report["ok"] = not report["problems"]
    return report
