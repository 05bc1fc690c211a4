"""Shared on-disk record framing for the storage engine (L4).

Both halves of the engine — the group-commit WAL (``storage/wal.py``) and
the log-structured request store (``storage/logstore.py``) — persist
append-only segment files built from one CRC-framed record shape::

    uvarint(payload_len) || uvarint(tag) || u32be crc32(payload) || payload

The ``tag`` is the WAL entry index for WAL segments and a record-type
discriminator for request-store segments.  The CRC is the recovery
contract: a scan stops at the first record whose length runs past the
file (a torn tail from a crash mid-append) *or* whose CRC does not match
(bit rot, or a torn tail that happens to parse), and the valid prefix is
everything before it.  Unlike ``simplewal``'s length-only framing, a torn
write can never smuggle garbage bytes into a decoded entry.

``fsync_dir`` closes the rename/create durability hole: after creating,
renaming, or unlinking a file inside a directory, the *directory* entry
itself must reach disk or a crash can resurrect an unlinked segment (or
lose a created one) — see docs/STORAGE.md "Recovery invariants".
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import Iterator, Tuple

from .. import wire

_CRC = struct.Struct(">I")

# Scan-stop reasons (``valid_prefix``): the whole file parsed, the last
# record was torn (crash mid-append; expected, survivable), or a CRC
# mismatch (corruption — survivable, but worth reporting loudly).
SCAN_CLEAN = "clean"
SCAN_TORN = "torn"
SCAN_CRC = "crc"


def encode_record(tag: int, payload: bytes) -> bytes:
    head = bytearray()
    wire.write_uvarint(head, len(payload))
    wire.write_uvarint(head, tag)
    head += _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF)
    return bytes(head) + payload


def iter_records(data: bytes) -> Iterator[Tuple[int, bytes, int, int]]:
    """Yield ``(tag, payload, start, end)`` for every valid record in the
    prefix of ``data``; stops silently at the first torn or corrupt one
    (use :func:`valid_prefix` to learn where and why)."""
    view = memoryview(data)
    pos = 0
    while pos < len(view):
        start = pos
        try:
            length, pos = wire.read_uvarint(view, pos)
            tag, pos = wire.read_uvarint(view, pos)
        except ValueError:
            return
        if pos + _CRC.size > len(view):
            return
        (crc,) = _CRC.unpack_from(view, pos)
        pos += _CRC.size
        if pos + length > len(view):
            return
        payload = bytes(view[pos : pos + length])
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return
        pos += length
        yield tag, payload, start, pos


def valid_prefix(data: bytes) -> Tuple[int, str]:
    """``(byte_length, reason)`` of the valid record prefix of ``data``.

    ``reason`` is SCAN_CLEAN when the file ends exactly on a record
    boundary, SCAN_TORN when the trailing bytes are an incomplete record,
    and SCAN_CRC when a complete-looking record failed its checksum."""
    view = memoryview(data)
    pos = 0
    while pos < len(view):
        start = pos
        try:
            length, pos = wire.read_uvarint(view, pos)
            _, pos = wire.read_uvarint(view, pos)
        except ValueError:
            return start, SCAN_TORN
        if pos + _CRC.size > len(view):
            return start, SCAN_TORN
        (crc,) = _CRC.unpack_from(view, pos)
        pos += _CRC.size
        if pos + length > len(view):
            return start, SCAN_TORN
        if zlib.crc32(view[pos : pos + length]) & 0xFFFFFFFF != crc:
            return start, SCAN_CRC
        pos += length
    return pos, SCAN_CLEAN


def cut_torn_tail(path: Path) -> int:
    """Truncate ``path`` to its valid record prefix (fsyncing the cut) and
    return the new length.  No-op when the file is already clean."""
    data = path.read_bytes()
    valid, reason = valid_prefix(data)
    if reason != SCAN_CLEAN:
        with open(path, "r+b") as fh:
            fh.truncate(valid)
            fh.flush()
            os.fsync(fh.fileno())
    return valid


def fsync_dir(path: Path) -> None:
    """fsync a directory so create/rename/unlink of its entries is durable.
    Best-effort on platforms whose directories reject O_RDONLY opens."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
