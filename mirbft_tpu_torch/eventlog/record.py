"""Event-log recorder/reader.

Rebuild of reference ``pkg/eventlog/interceptor.go``: an asynchronous,
buffered, gzip-compressed stream of length-prefixed ``RecordedEvent``s.  The
writer thread drains a bounded queue so the interceptor call on the hot path
is a cheap enqueue (the reference's default buffer is 5000 events); options
mirror the reference's (time source, request-data retention, compression
level, buffer size).
"""

from __future__ import annotations

import gzip
import queue
import threading
import time as _time
from typing import BinaryIO, Callable, Iterator, Optional

from .. import state as st
from .. import wire
from ..messages import ForwardRequest


def write_recorded_event(stream: BinaryIO, record: st.RecordedEvent) -> None:
    wire.write_framed(stream, record)


def _strip_request_data(event: st.Event) -> st.Event:
    """Drop request payloads from recorded events (they can dominate log
    size; reference interceptor.go retain-request-data option)."""
    if isinstance(event, st.EventStep) and isinstance(event.msg, ForwardRequest):
        return st.EventStep(
            source=event.source,
            msg=ForwardRequest(
                request_ack=event.msg.request_ack, request_data=b""
            ),
        )
    return event


class Recorder:
    """Async buffered gzip event recorder implementing the processor's
    ``EventInterceptor`` protocol (reference interceptor.go:84-233)."""

    def __init__(
        self,
        node_id: int,
        dest: BinaryIO,
        time_source: Optional[Callable[[], int]] = None,
        retain_request_data: bool = False,
        compression_level: int = 6,
        buffer_size: int = 5000,
    ):
        self.node_id = node_id
        # Wall-clock default matches the reference; it is timestamp metadata
        # on the record, never replay ordering.
        # mirlint: allow(wall-clock)
        self.time_source = time_source or (lambda: int(_time.time() * 1000))
        self.dropped_events = 0
        self.retain_request_data = retain_request_data
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._gzip = gzip.GzipFile(
            fileobj=dest, mode="wb", compresslevel=compression_level
        )
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def intercept(self, event: st.Event) -> None:
        if self._error is not None:
            raise RuntimeError("event recorder failed") from self._error
        if self._done.is_set() or self._stopped:
            raise RuntimeError("event recorder already stopped")
        if not self.retain_request_data:
            event = _strip_request_data(event)
        record = st.RecordedEvent(
            node_id=self.node_id, time=self.time_source(), state_event=event
        )
        # Non-blocking overflow (flight-recorder policy, see journal.py):
        # the old 0.1 s retry loop could stall consensus indefinitely behind
        # an alive-but-slow writer.  On a full queue, evict the oldest
        # buffered record so the log keeps the most recent window and the
        # hot path never waits.
        try:
            self._queue.put_nowait(record)
            return
        except queue.Full:
            pass
        try:
            victim = self._queue.get_nowait()
            if victim is None:
                # Never swallow the shutdown sentinel (stop() race).
                try:
                    self._queue.put_nowait(None)
                except queue.Full:
                    pass
            else:
                self.dropped_events += 1
        except queue.Empty:
            pass
        try:
            self._queue.put_nowait(record)
        except queue.Full:  # lost the race for the freed slot: drop new
            self.dropped_events += 1

    def _run(self) -> None:
        try:
            while True:
                record = self._queue.get()
                if record is None:
                    break
                write_recorded_event(self._gzip, record)
        except BaseException as e:  # surfaced on next intercept/stop
            self._error = e
        finally:
            try:
                self._gzip.close()
            except BaseException as e:
                if self._error is None:
                    self._error = e
            self._done.set()

    def stop(self) -> None:
        """Flush and close; the recorder cannot be used afterwards."""
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


def read_event_log(stream: BinaryIO) -> Iterator[st.RecordedEvent]:
    """Stream records from a gzip event log (reference interceptor.go:235-289)."""
    with gzip.GzipFile(fileobj=stream, mode="rb") as gz:
        while True:
            record = wire.read_framed(gz)
            if record is None:
                return
            if not isinstance(record, st.RecordedEvent):
                raise ValueError(
                    f"event log contains non-record type {type(record).__name__}"
                )
            yield record
