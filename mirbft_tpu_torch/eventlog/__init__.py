"""Event-log recording and replay (L5 observability).

Rebuild of reference ``pkg/eventlog``: every event entering a state machine
is tapped through an ``EventInterceptor`` and recorded — with node id and
fake/wall time — as canonical records, enabling byte-exact deterministic
replay (``mirbft_tpu_torch.tools.mircat``).  Two recorders exist:

* :class:`Recorder` — the reference-shaped single gzip stream (testengine,
  legacy deployments).
* :class:`JournalRecorder` — the always-on flight recorder: segmented,
  CRC-framed, checkpoint-retained journal files with non-blocking overflow
  and trace-id annotation (``journal.py``), plus the incident capture /
  replay plane (``incident.py``).
"""

from .journal import (
    BootLog,
    JournalRecorder,
    SegmentSink,
    journal_bytes,
    load_boots,
)
from .record import Recorder, read_event_log, write_recorded_event

__all__ = [
    "BootLog",
    "JournalRecorder",
    "Recorder",
    "SegmentSink",
    "journal_bytes",
    "load_boots",
    "read_event_log",
    "write_recorded_event",
]
