"""Durable storage engine (L4): group-commit WAL, log-structured request
store with checkpoint-keyed GC, and snapshot state transfer over the
socket plane.  See docs/STORAGE.md for the design and recovery
invariants; ``simplewal.py``/``reqstore.py`` remain as the minimal
reference implementations of the same interfaces."""

from .logstore import LogStore
from .segments import (
    SCAN_CLEAN,
    SCAN_CRC,
    SCAN_TORN,
    cut_torn_tail,
    encode_record,
    fsync_dir,
    iter_records,
    valid_prefix,
)
from .snapshot import (
    SnapshotStore,
    fetch_snapshot,
    fetch_snapshot_from_peers,
)
from .wal import GroupCommitWAL, wal_segment_report

__all__ = [
    "GroupCommitWAL",
    "LogStore",
    "SnapshotStore",
    "SCAN_CLEAN",
    "SCAN_CRC",
    "SCAN_TORN",
    "cut_torn_tail",
    "encode_record",
    "fetch_snapshot",
    "fetch_snapshot_from_peers",
    "fsync_dir",
    "iter_records",
    "valid_prefix",
    "wal_segment_report",
]
