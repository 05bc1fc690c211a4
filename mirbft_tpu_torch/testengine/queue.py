"""Time-ordered simulation event queue with a mangler hook.

Rebuild of reference ``pkg/testengine/eventqueue.go``: events carry a fake
timestamp; insertion keeps FIFO order among equal timestamps; a ``Mangler``
may intercept each event on first consumption and replace it with zero or
more (possibly delayed, duplicated, or re-mangleable) events.
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..state import EventInitialParameters
from ..messages import Msg
from ..statemachine.actions import Actions, Events


@dataclass
class SimEvent:
    """One scheduled simulation event (reference eventqueue.go:20-34).
    Exactly one of the payload fields is set."""

    target: int
    time: int
    initialize: Optional[EventInitialParameters] = None
    msg_received: Optional[Tuple[int, Msg]] = None  # (source, msg)
    client_proposal: Optional[Tuple[int, int, bytes]] = None  # (client, reqno, data)
    process_wal_actions: Optional[Actions] = None
    process_net_actions: Optional[Actions] = None
    process_hash_actions: Optional[Actions] = None
    process_client_actions: Optional[Actions] = None
    process_app_actions: Optional[Actions] = None
    process_req_store_events: Optional[Events] = None
    process_result_events: Optional[Events] = None
    tick: bool = False

    def kind(self) -> str:
        for name in (
            "initialize",
            "msg_received",
            "client_proposal",
            "process_wal_actions",
            "process_net_actions",
            "process_hash_actions",
            "process_client_actions",
            "process_app_actions",
            "process_req_store_events",
            "process_result_events",
        ):
            if getattr(self, name) is not None:
                return name
        if self.tick:
            return "tick"
        raise AssertionError("empty simulation event")


class EventQueue:
    """Reference eventqueue.go:55-99."""

    def __init__(self, seed: int = 0, mangler=None):
        self._heap: List[Tuple[int, int, SimEvent]] = []
        self._counter = 0  # FIFO tiebreak for equal timestamps
        self.fake_time = 0
        self.rand = random.Random(seed)
        self.mangler = mangler
        # id -> event; holding the reference pins the id so CPython cannot
        # reuse the address for a new event while the entry exists.
        self._mangled: dict = {}

    def __len__(self) -> int:
        return len(self._heap)

    def insert(self, event: SimEvent) -> None:
        if event.time < self.fake_time:
            raise AssertionError("attempted to modify the past")
        heapq.heappush(self._heap, (event.time, self._counter, event))
        self._counter += 1

    def peek_time(self) -> Optional[int]:
        """Fake-time of the earliest pending event, without consuming it.
        Advisory only (a mangler may replace the head at consumption): the
        scheduler drivers use the gap to the next event as lull detection —
        simulated wait the host can spend launching partial device waves
        (testengine/sched.py)."""
        if not self._heap:
            return None
        return self._heap[0][0]

    def consume(self) -> SimEvent:
        """Pop the next event, applying the mangler on first touch
        (reference eventqueue.go:74-99)."""
        while True:
            if not self._heap:
                raise AssertionError(
                    "event queue drained to empty (mangler dropped the last "
                    "pending events)"
                )
            _, _, event = heapq.heappop(self._heap)
            # mirlint: allow(id-ordering) — already-mangled marker keyed by
            # object identity; membership only, never ordered.
            eid = id(event)
            if eid in self._mangled or self.mangler is None:
                self._mangled.pop(eid, None)
                self.fake_time = event.time
                return event
            results = self.mangler.mangle(self.rand.getrandbits(62), event)
            for result in results:
                if not result.remangle:
                    # mirlint: allow(id-ordering) — same identity marker.
                    self._mangled[id(result.event)] = result.event
                self.insert(result.event)

    def remove_events_for(self, target: int) -> None:
        """Drop all pending events for a node (used on restart)."""
        self._heap = [
            entry for entry in self._heap if entry[2].target != target
        ]
        heapq.heapify(self._heap)
        # Also release mangled-set pins for dropped events, so the set does
        # not accumulate across restarts.
        self._mangled = {
            eid: ev for eid, ev in self._mangled.items() if ev.target != target
        }

    # --- convenience constructors (reference eventqueue.go:101-225) ---

    def insert_initialize(self, target: int, init_parms, from_now: int) -> None:
        self.insert(
            SimEvent(
                target=target, time=self.fake_time + from_now, initialize=init_parms
            )
        )

    def insert_tick(self, target: int, from_now: int) -> None:
        self.insert(
            SimEvent(target=target, time=self.fake_time + from_now, tick=True)
        )

    def insert_msg_received(
        self, target: int, source: int, msg: Msg, from_now: int
    ) -> None:
        self.insert(
            SimEvent(
                target=target,
                time=self.fake_time + from_now,
                msg_received=(source, msg),
            )
        )

    def insert_client_proposal(
        self, target: int, client_id: int, req_no: int, data: bytes, from_now: int
    ) -> None:
        self.insert(
            SimEvent(
                target=target,
                time=self.fake_time + from_now,
                client_proposal=(client_id, req_no, data),
            )
        )

    def insert_process(self, target: int, field_name: str, payload, from_now: int) -> None:
        self.insert(
            SimEvent(
                target=target,
                time=self.fake_time + from_now,
                **{field_name: payload},
            )
        )
