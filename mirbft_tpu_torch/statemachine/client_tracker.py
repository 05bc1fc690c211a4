"""Ready/available request lists with single-consumer resettable iterators.

Rebuild of reference ``pkg/statemachine/client_tracker.go``: the ``appendList``
structure (pending/consumed split, iterator reset on epoch change, GC from
either side, reference :64-119), specialized as the *available* list (requests
with f+1 acks and locally-stored data) and the *ready* list (strong-cert
requests eligible for proposal).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, TYPE_CHECKING

from ..messages import ClientState, NetworkState, RequestAck
from ..state import EventInitialParameters
from .stateless import is_committed

if TYPE_CHECKING:
    from .disseminator import ClientReqNo


class AppendList:
    """Single-consumer iterator over pending items; consumed items are
    retained (for iterator reset) until garbage collected
    (reference client_tracker.go:56-119)."""

    __slots__ = ("consumed", "pending")

    def __init__(self):
        self.consumed: Deque = deque()
        self.pending: Deque = deque()

    def reset_iterator(self) -> None:
        self.consumed.extend(self.pending)
        self.pending = self.consumed
        self.consumed = deque()

    def has_next(self) -> bool:
        return bool(self.pending)

    def next(self):
        value = self.pending.popleft()
        self.consumed.append(value)
        return value

    def push_back(self, value) -> None:
        self.pending.append(value)

    def garbage_collect(self, should_remove: Callable) -> None:
        self.consumed = deque(v for v in self.consumed if not should_remove(v))
        self.pending = deque(v for v in self.pending if not should_remove(v))


class ReadyList:
    """Strong-certified requests awaiting proposal."""

    __slots__ = ("_list",)

    def __init__(self):
        self._list = AppendList()

    def reset_iterator(self) -> None:
        self._list.reset_iterator()

    def has_next(self) -> bool:
        return self._list.has_next()

    def next(self) -> "ClientReqNo":
        return self._list.next()

    def push_back(self, crn: "ClientReqNo") -> None:
        self._list.push_back(crn)

    def garbage_collect(self, client_states: Dict[int, ClientState]) -> None:
        def should_remove(crn: "ClientReqNo") -> bool:
            state = client_states.get(crn.client_id)
            if state is None:
                raise AssertionError("client removal not yet supported")
            return is_committed(crn.req_no, state)

        self._list.garbage_collect(should_remove)


class AvailableList:
    """Requests with a weak quorum of acks whose data we hold locally."""

    __slots__ = ("_list",)

    def __init__(self):
        self._list = AppendList()

    def reset_iterator(self) -> None:
        self._list.reset_iterator()

    def has_next(self) -> bool:
        return self._list.has_next()

    def next(self) -> RequestAck:
        return self._list.next()

    def push_back(self, ack: RequestAck) -> None:
        self._list.push_back(ack)

    def garbage_collect(self, client_states: Dict[int, ClientState]) -> None:
        def should_remove(ack: RequestAck) -> bool:
            state = client_states.get(ack.client_id)
            if state is None:
                raise AssertionError(
                    "any available client req must have its client in config"
                )
            return is_committed(ack.req_no, state)

        self._list.garbage_collect(should_remove)


class ClientTracker:
    """Reference client_tracker.go:16-54."""

    __slots__ = (
        "my_config",
        "logger",
        "network_config",
        "ready_list",
        "available_list",
        "client_states",
    )

    def __init__(self, my_config: EventInitialParameters, logger=None):
        self.my_config = my_config
        self.logger = logger
        self.network_config = None
        self.ready_list = ReadyList()
        self.available_list = AvailableList()
        self.client_states = ()

    def reinitialize(self, network_state: NetworkState) -> None:
        self.network_config = network_state.config
        self.client_states = network_state.clients
        self.available_list = AvailableList()
        self.ready_list = ReadyList()

    def add_ready(self, crn: "ClientReqNo") -> None:
        self.ready_list.push_back(crn)

    def add_available(self, ack: RequestAck) -> None:
        self.available_list.push_back(ack)

    def allocate(self, seq_no: int, state: NetworkState) -> None:
        """GC both lists against the post-checkpoint client states
        (reference client_tracker.go:46-54)."""
        state_map = {client.id: client for client in state.clients}
        self.available_list.garbage_collect(state_map)
        self.ready_list.garbage_collect(state_map)
