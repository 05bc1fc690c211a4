"""Durable write-ahead log (L4).

Rebuild of reference ``pkg/simplewal`` (tidwall/wal-backed): a segmented
append-only log of canonically-encoded ``Persistent`` entries with explicit
``sync`` (no per-write fsync) and front truncation.

Layout: a directory of segment files named ``seg-<first_index>.wal``, each a
stream of framed records ``uvarint(len) || uvarint(index) || entry-bytes``.
Appends go to the active (highest) segment, rotating at
``segment_max_bytes``; ``truncate`` drops whole segments whose entries all
precede the cut index (lazy, like tidwall's TruncateFront) and the loader
skips residual entries below the logical low index.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from . import wire
from .messages import Persistent
from .storage.segments import fsync_dir

_LOW_MARK_FILE = "lowmark"


def _write_frame(fh, index: int, payload: bytes) -> None:
    head = bytearray()
    wire.write_uvarint(head, len(payload))
    wire.write_uvarint(head, index)
    fh.write(bytes(head))
    fh.write(payload)


def _read_frames(data: bytes):
    view = memoryview(data)
    pos = 0
    while pos < len(view):
        try:
            length, pos = wire.read_uvarint(view, pos)
            index, pos = wire.read_uvarint(view, pos)
        except ValueError:
            return  # torn tail (crash mid-append); ignore
        if pos + length > len(view):
            return  # torn payload
        yield index, bytes(view[pos : pos + length])
        pos += length


class WAL:
    """File-backed ``processor.WAL`` implementation."""

    def __init__(self, path: str, segment_max_bytes: int = 4 * 1024 * 1024):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_max_bytes = segment_max_bytes
        self._fh = None
        self._active_path: Optional[Path] = None
        self._active_size = 0
        self._next_index: Optional[int] = None  # unknown until load/append
        self._low_index = self._read_low_mark()

    # --- low-watermark bookkeeping ---

    def _read_low_mark(self) -> int:
        mark = self.dir / _LOW_MARK_FILE
        if mark.exists():
            return int(mark.read_text())
        return 1

    def _write_low_mark(self, index: int) -> None:
        tmp = self.dir / (_LOW_MARK_FILE + ".tmp")
        tmp.write_text(str(index))
        os.replace(tmp, self.dir / _LOW_MARK_FILE)
        fsync_dir(self.dir)  # the rename must survive a crash

    # --- segments ---

    def _segments(self) -> List[Tuple[int, Path]]:
        segments = []
        for entry in self.dir.iterdir():
            if entry.name.startswith("seg-") and entry.name.endswith(".wal"):
                segments.append((int(entry.name[4:-4]), entry))
        return sorted(segments)

    @staticmethod
    def _valid_length(data: bytes) -> int:
        """Byte length of the valid frame prefix (excludes any torn tail)."""
        view = memoryview(data)
        pos = 0
        while pos < len(view):
            start = pos
            try:
                length, pos = wire.read_uvarint(view, pos)
                _, pos = wire.read_uvarint(view, pos)
            except ValueError:
                return start
            if pos + length > len(view):
                return start
            pos += length
        return pos

    def _open_segment(self, first_index: int) -> None:
        if self._fh is not None:
            self._fh.close()
        self._active_path = self.dir / f"seg-{first_index}.wal"
        if self._active_path.exists():
            # Reopening after a crash: cut any torn tail BEFORE appending,
            # or new frames land after garbage and are lost to the loader.
            data = self._active_path.read_bytes()
            valid = self._valid_length(data)
            if valid != len(data):
                with open(self._active_path, "r+b") as fh:
                    fh.truncate(valid)
                    fh.flush()
                    os.fsync(fh.fileno())
        self._fh = open(self._active_path, "ab")
        self._active_size = self._active_path.stat().st_size
        # A crash between creating the segment and syncing the directory
        # loses the file even though its data was fsynced.
        fsync_dir(self.dir)

    # --- WAL protocol ---

    def write(self, index: int, entry: Persistent) -> None:
        if self._next_index is not None and index != self._next_index:
            raise ValueError(
                f"WAL out of order: expected index {self._next_index}, got {index}"
            )
        if self._fh is None or self._active_size >= self.segment_max_bytes:
            self._open_segment(index)
        payload = wire.encode(entry)
        before = self._active_size
        _write_frame(self._fh, index, payload)
        self._active_size = before + len(payload) + 20  # frame overhead bound
        self._next_index = index + 1

    def truncate(self, index: int) -> None:
        """Logically drop entries below ``index``; physically remove whole
        segments entirely below it."""
        if index < self._low_index:
            raise ValueError(
                f"truncate to {index} below low index {self._low_index}"
            )
        self._low_index = index
        self._write_low_mark(index)
        segments = self._segments()
        unlinked = False
        for i, (first, path) in enumerate(segments):
            next_first = (
                segments[i + 1][0] if i + 1 < len(segments) else None
            )
            if next_first is not None and next_first <= index and path != self._active_path:
                path.unlink()
                unlinked = True
        if unlinked:
            # A crash before the directory syncs can resurrect an unlinked
            # segment; harmless for reads (lowmark filters it) but it would
            # un-reclaim the space truncate just promised to free.
            fsync_dir(self.dir)

    def sync(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def load_all(self, for_each: Callable[[int, Persistent], None]) -> None:
        records: List[Tuple[int, bytes]] = []
        for first, path in self._segments():
            for index, payload in _read_frames(path.read_bytes()):
                if index >= self._low_index:
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
            self._next_index = expected

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
