"""Fluent builders for Action and Event batches.

Rebuild of the reference's ``ActionList``/``EventList``
(``pkg/statemachine/actions.go``, ``events.go``).  The reference uses linked
lists of protobuf oneofs; here a batch is a thin wrapper over a Python list of
the frozen dataclasses from ``mirbft_tpu_torch.state``, with the same fluent
constructor surface so state-machine code reads the same way.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

from .. import state as s
from ..messages import (
    ClientState,
    Msg,
    NetworkConfig,
    NetworkState,
    Persistent,
    QEntry,
    RequestAck,
)


class Actions:
    """An ordered batch of actions emitted by the state machine."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[List[s.Action]] = None):
        self.items = items if items is not None else []


    # --- composition ---

    def concat(self, other: "Actions") -> "Actions":
        if other.items:
            self.items.extend(other.items)
        return self

    def push_back(self, action: s.Action) -> "Actions":
        self.items.append(action)
        return self

    def __iter__(self) -> Iterator[s.Action]:
        return iter(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def __bool__(self) -> bool:
        return bool(self.items)

    def __repr__(self) -> str:
        return f"Actions({self.items!r})"

    # --- fluent constructors (reference actions.go) ---

    def send(self, targets: Iterable[int], msg: Msg) -> "Actions":
        self.items.append(s.ActionSend(targets=tuple(targets), msg=msg))
        return self

    def hash(self, data: Iterable[bytes], origin: s.HashOrigin) -> "Actions":
        self.items.append(s.ActionHashRequest(data=tuple(data), origin=origin))
        return self

    def persist(self, index: int, entry: Persistent) -> "Actions":
        self.items.append(s.ActionPersist(index=index, entry=entry))
        return self

    def truncate(self, index: int) -> "Actions":
        self.items.append(s.ActionTruncate(index=index))
        return self

    def commit(self, qentry: QEntry) -> "Actions":
        self.items.append(s.ActionCommit(batch=qentry))
        return self

    def checkpoint(
        self,
        seq_no: int,
        network_config: NetworkConfig,
        client_states: Tuple[ClientState, ...],
    ) -> "Actions":
        self.items.append(
            s.ActionCheckpoint(
                seq_no=seq_no,
                network_config=network_config,
                client_states=client_states,
            )
        )
        return self

    def allocate_request(self, client_id: int, req_no: int) -> "Actions":
        self.items.append(
            s.ActionAllocatedRequest(client_id=client_id, req_no=req_no)
        )
        return self

    def correct_request(self, ack: RequestAck) -> "Actions":
        self.items.append(s.ActionCorrectRequest(ack=ack))
        return self

    def forward_request(self, targets: Iterable[int], ack: RequestAck) -> "Actions":
        self.items.append(
            s.ActionForwardRequest(targets=tuple(targets), ack=ack)
        )
        return self

    def state_applied(self, seq_no: int, ns: NetworkState) -> "Actions":
        self.items.append(s.ActionStateApplied(seq_no=seq_no, network_state=ns))
        return self

    def state_transfer(self, seq_no: int, value: bytes) -> "Actions":
        self.items.append(s.ActionStateTransfer(seq_no=seq_no, value=value))
        return self


class Events:
    """An ordered batch of events to feed the state machine."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[List[s.Event]] = None):
        self.items = items if items is not None else []

    def concat(self, other: "Events") -> "Events":
        self.items.extend(other.items)
        return self

    def push_back(self, event: s.Event) -> "Events":
        self.items.append(event)
        return self

    def __iter__(self) -> Iterator[s.Event]:
        return iter(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def __bool__(self) -> bool:
        return bool(self.items)

    def __repr__(self) -> str:
        return f"Events({self.items!r})"

    # --- fluent constructors (reference events.go) ---

    def initialize(self, params: s.EventInitialParameters) -> "Events":
        self.items.append(params)
        return self

    def load_persisted_entry(self, index: int, entry: Persistent) -> "Events":
        self.items.append(s.EventLoadPersistedEntry(index=index, entry=entry))
        return self

    def complete_initialization(self) -> "Events":
        self.items.append(s.EventLoadCompleted())
        return self

    def hash_result(self, digest: bytes, origin: s.HashOrigin) -> "Events":
        self.items.append(s.EventHashResult(digest=digest, origin=origin))
        return self

    def checkpoint_result(
        self,
        seq_no: int,
        value: bytes,
        network_state: NetworkState,
        reconfigured: bool = False,
    ) -> "Events":
        self.items.append(
            s.EventCheckpointResult(
                seq_no=seq_no,
                value=value,
                network_state=network_state,
                reconfigured=reconfigured,
            )
        )
        return self

    def request_persisted(self, ack: RequestAck) -> "Events":
        self.items.append(s.EventRequestPersisted(request_ack=ack))
        return self

    def state_transfer_complete(
        self, seq_no: int, checkpoint_value: bytes, network_state: NetworkState
    ) -> "Events":
        self.items.append(
            s.EventStateTransferComplete(
                seq_no=seq_no,
                checkpoint_value=checkpoint_value,
                network_state=network_state,
            )
        )
        return self

    def state_transfer_failed(self, seq_no: int, checkpoint_value: bytes) -> "Events":
        self.items.append(
            s.EventStateTransferFailed(
                seq_no=seq_no, checkpoint_value=checkpoint_value
            )
        )
        return self

    def step(self, source: int, msg: Msg) -> "Events":
        self.items.append(s.EventStep(source=source, msg=msg))
        return self

    def tick_elapsed(self) -> "Events":
        self.items.append(s.EventTickElapsed())
        return self

    def actions_received(self) -> "Events":
        self.items.append(s.EventActionsReceived())
        return self


class _FrozenActions(Actions):
    """Immutable empty ActionList, returned by hot no-op paths to avoid
    allocating a fresh list per call.  Mutators raise so an accidental
    in-place use is caught immediately (``concat(EMPTY_ACTIONS)`` onto a
    live list is fine — it only reads)."""

    __slots__ = ()

    def _frozen(self, *_args, **_kw):
        raise AssertionError("EMPTY_ACTIONS is immutable; allocate Actions()")

    concat = _frozen
    push_back = _frozen
    send = _frozen
    hash = _frozen
    persist = _frozen
    truncate = _frozen
    commit = _frozen
    checkpoint = _frozen
    allocate_request = _frozen
    correct_request = _frozen
    forward_request = _frozen
    state_applied = _frozen
    state_transfer = _frozen


EMPTY_ACTIONS = _FrozenActions()
