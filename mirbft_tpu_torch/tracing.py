"""Ring-buffered tracing plane: spans, Chrome trace-event export, and
request-lifecycle derivation from the deterministic event stream.

The reference has no tracing layer — its observability is the status snapshot
and the replayable event log (SURVEY.md §5).  But the etcd-raft-style
architecture it inherits makes tracing essentially free: every state
transition is already an interceptable ``Event``, so per-request commit spans
(submit → ack quorum → sequence allocation → preprepare → commit) can be
*derived* from the stream rather than instrumented into the hot path.

Design (docs/OBSERVABILITY.md):

- ``Tracer`` collects Chrome trace-event records (the JSON array format that
  Perfetto / ``chrome://tracing`` load directly) into a bounded ``deque`` —
  a ring buffer, so a long run keeps the most recent window and never grows
  without bound.  It is disabled by default; every emit method's first line
  is an ``enabled`` check, keeping the disabled cost to one attribute read.
- The clock is injectable and always denominated in **microseconds** (the
  trace-event ``ts`` unit).  Two clock domains exist: ``wall`` (default,
  ``time.perf_counter``-based) for the node runtime and the device crypto
  planes, and ``sim`` for the testengine/PDES, where the virtual
  ``fake_time`` is bound in directly (1 sim unit = 1 µs in exports).
- ``CommitSpanTracker`` folds one node's event/action stream into
  per-request spans and a per-node ``commit_latency_seconds`` histogram.
- ``HashWaveTracker`` pairs ``ActionHashRequest``/``EventHashResult`` into
  device-wave spans — used by ``mircat --trace`` to reconstruct wave
  lifecycles offline from a recorded gzip event log, in sim time.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from mirbft_tpu_torch import metrics as metrics_mod
from mirbft_tpu_torch import state as st
from mirbft_tpu_torch.messages import Preprepare


def wall_clock_us() -> float:
    """Monotonic wall clock in microseconds (Chrome trace ``ts`` unit)."""
    return time.perf_counter() * 1e6


class _Span:
    """Context manager emitting one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_pid", "_tid", "_args", "_start")

    def __init__(self, tracer: "Tracer", name: str, pid: int, tid: int, args):
        self._tracer = tracer
        self._name = name
        self._pid = pid
        self._tid = tid
        self._args = args
        self._start = 0.0

    def __enter__(self) -> "_Span":
        self._start = self._tracer.now()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.complete(
            self._name,
            self._start,
            pid=self._pid,
            tid=self._tid,
            args=self._args,
        )


class _NullSpan:
    """Shared no-op span returned while the tracer is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded collector of Chrome trace-event records.

    Events live in a ring buffer (``deque(maxlen=capacity)``); metadata
    records (process/thread names) are kept separately and unbounded — there
    are only ever a handful, and they must survive ring-buffer eviction for
    the exported trace to stay labeled.
    """

    def __init__(
        self,
        capacity: int = 65536,
        clock: Callable[[], float] = wall_clock_us,
        enabled: bool = True,
        clock_domain: str = "wall",
    ):
        self.enabled = enabled
        self.clock = clock
        self.clock_domain = clock_domain
        self._events: Deque[Dict] = deque(maxlen=capacity)
        self._meta: List[Dict] = []
        # Monotonic count of events ever pushed; with the ring length it
        # yields a stable drain cursor.  The tiny lock pairs the append
        # with the counter bump so a concurrent drain never sees one
        # without the other (events silently lost or duplicated
        # otherwise); emitters hold it for one append, off any sorted or
        # serialized path.
        self._emitted = 0
        self._ring_lock = threading.Lock()  # mirlint: allow(lock-map) guards (_events, _emitted) pairing only

    def now(self) -> float:
        return float(self.clock())

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        with self._ring_lock:
            self._events.clear()
            self._emitted = 0
        self._meta.clear()

    def _push(self, ev: Dict) -> None:
        with self._ring_lock:
            self._events.append(ev)
            self._emitted += 1

    def drain(self, cursor: int = 0) -> Tuple[int, List[Dict], int]:
        """``(new_cursor, events, dropped)``: every event pushed after
        ``cursor`` that is still in the ring, without consuming anything.

        The cursor is the total-emitted count, so a collector polls with
        the last returned cursor and gets exactly the delta; ``dropped``
        counts events that were evicted by ring wraparound before this
        drain saw them (cursor too old for the retained window)."""
        with self._ring_lock:
            emitted = self._emitted
            events = list(self._events)
        start = emitted - len(events)
        skip = max(0, min(cursor, emitted) - start)
        dropped = max(0, start - cursor)
        return emitted, events[skip:], dropped

    # -- emit ---------------------------------------------------------------

    def instant(
        self,
        name: str,
        pid: int = 0,
        tid: int = 0,
        ts: Optional[float] = None,
        args: Optional[Dict] = None,
    ) -> None:
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "i",
            "ts": self.now() if ts is None else float(ts),
            "pid": pid,
            "tid": tid,
            "s": "t",
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def complete(
        self,
        name: str,
        start: float,
        end: Optional[float] = None,
        pid: int = 0,
        tid: int = 0,
        args: Optional[Dict] = None,
    ) -> None:
        if not self.enabled:
            return
        if end is None:
            end = self.now()
        ev = {
            "name": name,
            "ph": "X",
            "ts": float(start),
            "dur": max(0.0, float(end) - float(start)),
            "pid": pid,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def counter_event(
        self,
        name: str,
        values: Dict[str, float],
        pid: int = 0,
        ts: Optional[float] = None,
    ) -> None:
        """Chrome "C" record: Perfetto renders these as stacked counters."""
        if not self.enabled:
            return
        self._push(
            {
                "name": name,
                "ph": "C",
                "ts": self.now() if ts is None else float(ts),
                "pid": pid,
                "tid": 0,
                "args": dict(values),
            }
        )

    def span(self, name: str, pid: int = 0, tid: int = 0, args=None):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, pid, tid, args)

    def name_process(self, pid: int, label: str) -> None:
        self._meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": label},
            }
        )

    def name_thread(self, pid: int, tid: int, label: str) -> None:
        self._meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": label},
            }
        )

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> Dict:
        """JSON-object trace: metadata first, then events sorted by ts.

        The ring buffer preserves emission order, which for complete events
        is *end* order, not start order; sorting by ``ts`` restores the
        monotonic start-time order viewers expect.
        """
        with self._ring_lock:
            snapshot = list(self._events)
        events = sorted(snapshot, key=lambda e: e["ts"])
        return {
            "traceEvents": list(self._meta) + events,
            "displayTimeUnit": "ms",
            "otherData": {"clock_domain": self.clock_domain},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# Default process-wide tracer: off until a runtime (node.py, bench.py,
# mircat --trace, or a test) opts in.  Kept wall-clock; sim-domain tracers
# are built per-recording with the engine's fake_time bound in.
default_tracer = Tracer(enabled=False)


_COMMIT_PHASES = ("submit", "quorum", "allocate", "preprepare")


class CommitSpanTracker:
    """Folds one node's event/action stream into per-request commit spans.

    Phase markers, all derived (nothing added to the state machine):

    - ``submit``     — ``EventRequestPersisted``: the local store persisted
      the client request and acked it.
    - ``quorum``     — ``ActionCorrectRequest``: a weak quorum of acks
      established the digest as correct.
    - ``allocate``   — ``ActionHashRequest`` with a ``BatchOrigin``: the
      request was allocated into a sequence-numbered batch.
    - ``preprepare`` — ``EventStep(Preprepare)``: the leader's Preprepare
      for a batch containing the request arrived.
    - commit (span end) — ``ActionCommit``: the batch's ``QEntry`` reached
      commit; the span is emitted and ``commit_latency_seconds`` observed.

    Bounded: at most ``max_outstanding`` in-flight requests are tracked, and
    ``sample`` > 1 keeps only every Nth request — both keep a long run's
    memory flat.  The latency histogram is fed regardless of whether the
    tracer is enabled; span emission is gated on ``tracer.enabled``.
    """

    def __init__(
        self,
        tracer: Tracer,
        node_id: int,
        registry: Optional[metrics_mod.Registry] = None,
        sample: int = 1,
        max_outstanding: int = 8192,
    ):
        self.tracer = tracer
        self.node_id = node_id
        self.sample = max(1, sample)
        self.max_outstanding = max_outstanding
        reg = registry if registry is not None else metrics_mod.default_registry
        self._latency = reg.histogram(
            "commit_latency_seconds", labels={"node": str(node_id)}
        )
        self._pending: Dict[Tuple[int, int, bytes], Dict[str, float]] = {}
        self._seen = 0
        self.committed = 0
        # Optional (client_id, req_no) -> trace id resolver; when set (the
        # socket runtime wires it to Node.trace_id_of) committed spans
        # carry the fleet trace id in their args, which is what lets the
        # fleet merge join one request's spans across processes.
        self.trace_resolver: Optional[Callable[[int, int], Optional[int]]] = None

    def _mark(self, ack, phase: str) -> None:
        key = (ack.client_id, ack.req_no, ack.digest)
        rec = self._pending.get(key)
        if rec is None:
            # First sight may be any phase (e.g. a forwarded request skips
            # the local submit); the span covers the phases this node saw.
            self._seen += 1
            if (self._seen - 1) % self.sample:
                return
            if len(self._pending) >= self.max_outstanding:
                return
            rec = self._pending[key] = {}
        rec.setdefault(phase, self.tracer.now())

    def observe(self, events=(), actions=()) -> None:
        for ev in events:
            if isinstance(ev, st.EventRequestPersisted):
                self._mark(ev.request_ack, "submit")
            elif isinstance(ev, st.EventStep) and isinstance(
                ev.msg, Preprepare
            ):
                for ack in ev.msg.batch:
                    self._mark(ack, "preprepare")
        for act in actions:
            if isinstance(act, st.ActionCorrectRequest):
                self._mark(act.ack, "quorum")
            elif isinstance(act, st.ActionHashRequest) and isinstance(
                act.origin, st.BatchOrigin
            ):
                for ack in act.origin.request_acks:
                    self._mark(ack, "allocate")
            elif isinstance(act, st.ActionCommit):
                for ack in act.batch.requests:
                    self._commit(ack, act.batch.seq_no)

    def _commit(self, ack, seq_no: int) -> None:
        key = (ack.client_id, ack.req_no, ack.digest)
        rec = self._pending.pop(key, None)
        if rec is None:
            return
        end = self.tracer.now()
        start = rec.get("submit")
        if start is None:
            start = min(rec.values()) if rec else end
        self.committed += 1
        self._latency.observe((end - start) / 1e6)
        if self.tracer.enabled:
            args = {
                "seq_no": seq_no,
                "req_no": ack.req_no,
                "phases_us": {
                    ph: rec[ph] - start for ph in _COMMIT_PHASES if ph in rec
                },
            }
            if self.trace_resolver is not None:
                trace_id = self.trace_resolver(ack.client_id, ack.req_no)
                if trace_id:
                    args["trace"] = "%016x" % trace_id
            self.tracer.complete(
                "request_commit",
                start,
                end,
                pid=self.node_id,
                tid=ack.client_id,
                args=args,
            )


class HashWaveTracker:
    """Pairs hash dispatches with their results into device-wave spans.

    Used by ``mircat --trace`` for offline reconstruction: each recorded
    ``ActionHashRequest`` opens a wave keyed by its origin, the matching
    ``EventHashResult`` closes it, and a ``hash_wave`` complete event is
    emitted in the record's sim-time domain (the caller sets the tracer's
    clock to the record timestamp before each ``observe``).
    """

    def __init__(self, tracer: Tracer, node_id: int):
        self.tracer = tracer
        self.node_id = node_id
        self._open: Dict[st.HashOrigin, float] = {}
        self.waves = 0

    def observe(self, events=(), actions=()) -> None:
        for act in actions:
            if isinstance(act, st.ActionHashRequest):
                self._open.setdefault(act.origin, self.tracer.now())
        for ev in events:
            if isinstance(ev, st.EventHashResult):
                start = self._open.pop(ev.origin, None)
                if start is None:
                    continue
                self.waves += 1
                origin = ev.origin
                args = {"origin": type(origin).__name__}
                seq_no = getattr(origin, "seq_no", None)
                if seq_no is not None:
                    args["seq_no"] = seq_no
                acks = getattr(origin, "request_acks", None)
                if acks is not None:
                    args["requests"] = len(acks)
                self.tracer.complete(
                    "hash_wave",
                    start,
                    self.tracer.now(),
                    pid=self.node_id,
                    tid=1,
                    args=args,
                )
