"""L0 state schema: Events into and Actions out of the deterministic state machine.

TPU-native rebuild of ``/root/reference/protos/state/state.proto``.  Event and
action vocabulary parity: 11 event variants (state.proto:16-31), 11 action
variants (state.proto:113-127), 3 hash-origin variants (state.proto:85-107).

Design note: the reference models Actions/Events as protobuf oneofs threaded
through linked lists.  Here each variant is a frozen dataclass and a batch of
them is a plain Python list; the builder API lives in
``mirbft_tpu_torch.statemachine.actions``.  ``ActionHashRequest`` is the TPU
boundary: the processor collects every outstanding hash action per loop
iteration, pads them into fixed-shape uint32 arrays, and runs one vmapped
SHA-256 dispatch on device (``mirbft_tpu_torch.ops``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

from .messages import (
    ClientState,
    EpochChange,
    Msg,
    NetworkConfig,
    NetworkState,
    Persistent,
    QEntry,
    RequestAck,
)

# ---------------------------------------------------------------------------
# Hash origins (reference state.proto:85-107): tags carried alongside a hash
# request so the result can be routed back to the requesting sub-machine.
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class BatchOrigin:
    source: int
    epoch: int
    seq_no: int
    request_acks: Tuple[RequestAck, ...]


@dataclass(frozen=True, slots=True)
class VerifyBatchOrigin:
    source: int
    seq_no: int
    request_acks: Tuple[RequestAck, ...]
    expected_digest: bytes


@dataclass(frozen=True, slots=True)
class EpochChangeOrigin:
    source: int
    origin: int
    epoch_change: EpochChange


HashOrigin = Union[BatchOrigin, VerifyBatchOrigin, EpochChangeOrigin]


# ---------------------------------------------------------------------------
# Events (11 variants; reference state.proto:16-31).
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class EventInitialParameters:
    """Runtime (non-consensused) parameters (reference state.proto:33-40)."""

    id: int
    batch_size: int
    heartbeat_ticks: int
    suspect_ticks: int
    new_epoch_timeout_ticks: int
    buffer_size: int


@dataclass(frozen=True, slots=True)
class EventLoadPersistedEntry:
    index: int
    entry: Persistent


@dataclass(frozen=True, slots=True)
class EventLoadCompleted:
    pass


@dataclass(frozen=True, slots=True)
class EventHashResult:
    digest: bytes
    origin: HashOrigin


@dataclass(frozen=True, slots=True)
class EventCheckpointResult:
    seq_no: int
    value: bytes
    network_state: NetworkState
    reconfigured: bool


@dataclass(frozen=True, slots=True)
class EventRequestPersisted:
    request_ack: RequestAck


@dataclass(frozen=True, slots=True)
class EventStateTransferComplete:
    seq_no: int
    checkpoint_value: bytes
    network_state: NetworkState


@dataclass(frozen=True, slots=True)
class EventStateTransferFailed:
    seq_no: int
    checkpoint_value: bytes


@dataclass(frozen=True, slots=True)
class EventStep:
    source: int
    msg: Msg


@dataclass(frozen=True, slots=True)
class EventTickElapsed:
    pass


@dataclass(frozen=True, slots=True)
class EventActionsReceived:
    pass


Event = Union[
    EventInitialParameters,
    EventLoadPersistedEntry,
    EventLoadCompleted,
    EventHashResult,
    EventCheckpointResult,
    EventRequestPersisted,
    EventStateTransferComplete,
    EventStateTransferFailed,
    EventStep,
    EventTickElapsed,
    EventActionsReceived,
]


# ---------------------------------------------------------------------------
# Actions (11 variants; reference state.proto:113-127).
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class ActionSend:
    targets: Tuple[int, ...]
    msg: Msg


@dataclass(frozen=True, slots=True)
class ActionHashRequest:
    """The TPU hot-path action (reference state.proto:168-171): hash the
    concatenation of ``data`` and return an EventHashResult tagged ``origin``."""

    data: Tuple[bytes, ...]
    origin: HashOrigin


@dataclass(frozen=True, slots=True)
class ActionPersist:
    """Append to the write-ahead log (proto ``append_write_ahead``)."""

    index: int
    entry: Persistent


@dataclass(frozen=True, slots=True)
class ActionTruncate:
    """Truncate the write-ahead log below ``index`` (proto ``truncate_write_ahead``)."""

    index: int


@dataclass(frozen=True, slots=True)
class ActionCommit:
    batch: QEntry


@dataclass(frozen=True, slots=True)
class ActionCheckpoint:
    seq_no: int
    network_config: NetworkConfig
    client_states: Tuple[ClientState, ...]


@dataclass(frozen=True, slots=True)
class ActionAllocatedRequest:
    """Ask the client tracker whether (client_id, req_no) is locally persisted
    (proto ``allocated_request`` / ActionRequestSlot)."""

    client_id: int
    req_no: int


@dataclass(frozen=True, slots=True)
class ActionCorrectRequest:
    """Inform the client store of a known-correct digest (proto ``correct_request``)."""

    ack: RequestAck


@dataclass(frozen=True, slots=True)
class ActionForwardRequest:
    targets: Tuple[int, ...]
    ack: RequestAck


@dataclass(frozen=True, slots=True)
class ActionStateTransfer:
    """Request app state transfer to (seq_no, value) (proto ``state_transfer``)."""

    seq_no: int
    value: bytes


@dataclass(frozen=True, slots=True)
class ActionStateApplied:
    seq_no: int
    network_state: NetworkState


Action = Union[
    ActionSend,
    ActionHashRequest,
    ActionPersist,
    ActionTruncate,
    ActionCommit,
    ActionCheckpoint,
    ActionAllocatedRequest,
    ActionCorrectRequest,
    ActionForwardRequest,
    ActionStateTransfer,
    ActionStateApplied,
]


# ---------------------------------------------------------------------------
# Recording (reference protos/recording/recording.proto): one entry per event
# fed to a node's state machine, for deterministic record/replay.
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class RecordedEvent:
    node_id: int
    time: int
    state_event: Event
