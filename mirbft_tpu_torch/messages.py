"""L0 wire/state schema: consensus messages, network state, and WAL entries.

TPU-native rebuild of the reference's protobuf schema
(``/root/reference/protos/msgs/msgs.proto``).  We use frozen dataclasses with a
canonical binary codec (``mirbft_tpu_torch.wire``) instead of protobuf: the codec is
deterministic (required because epoch-change digests are computed over
serialized message content on every node), dependency-free, and keeps message
construction allocation-light on the host side so the hot loop feeds the TPU
hash batcher without marshaling overhead.

Message vocabulary parity (reference ``msgs.proto:189-207``): 15 message
variants, 8 persistent WAL entry kinds, NetworkState/Config/Client, and
Reconfiguration variants.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Tuple, Union

if sys.version_info >= (3, 11):
    # voteplane's split cache holds weakrefs to MsgBatch envelopes, which a
    # slots dataclass only supports via 3.11's weakref_slot.
    _weakrefable_dataclass = dataclass(frozen=True, slots=True, weakref_slot=True)
else:
    # 3.10 has no weakref_slot: forgo slots so __weakref__ exists.
    _weakrefable_dataclass = dataclass(frozen=True)

# ---------------------------------------------------------------------------
# Network state (consensused configuration).  Reference: msgs.proto:18-111.
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class NetworkConfig:
    """Consensused protocol parameters (reference msgs.proto:19-73)."""

    nodes: Tuple[int, ...]
    checkpoint_interval: int
    max_epoch_length: int
    number_of_buckets: int
    f: int


@dataclass(frozen=True, slots=True)
class ClientState:
    """Per-client request-window state (reference msgs.proto:75-105)."""

    id: int
    width: int
    width_consumed_last_checkpoint: int
    low_watermark: int
    committed_mask: bytes


@dataclass(frozen=True, slots=True)
class ReconfigNewClient:
    id: int
    width: int


@dataclass(frozen=True, slots=True)
class ReconfigRemoveClient:
    id: int


@dataclass(frozen=True, slots=True)
class ReconfigNewConfig:
    config: NetworkConfig


@dataclass(frozen=True, slots=True)
class ReconfigTransferClient:
    """Admit a client mid-stream at an explicit low watermark.

    Used by elastic resharding (docs/SHARDING.md): when a merge moves a
    client back into its parent group, the parent must start the client's
    window at one past the highest request the child committed —
    ``ReconfigNewClient`` (watermark 0) would re-open already-committed
    request numbers and break exactly-once under client retries.
    """

    id: int
    width: int
    low_watermark: int


Reconfiguration = Union[
    ReconfigNewClient,
    ReconfigRemoveClient,
    ReconfigNewConfig,
    ReconfigTransferClient,
]


@dataclass(frozen=True, slots=True)
class NetworkState:
    """Reference msgs.proto:18-111 (``reconfigured`` bool intentionally omitted:
    the reference marks it "TODO, do we need this?" and never reads it)."""

    config: NetworkConfig
    clients: Tuple[ClientState, ...]
    pending_reconfigurations: Tuple[Reconfiguration, ...] = ()


# ---------------------------------------------------------------------------
# Requests and acks.
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class RequestAck:
    """Digest-attestation for (client_id, req_no) (reference msgs.proto:241-245)."""

    client_id: int
    req_no: int
    digest: bytes


@dataclass(frozen=True, slots=True)
class Request:
    client_id: int
    req_no: int
    data: bytes


# ---------------------------------------------------------------------------
# Epoch configuration / view-change payloads.
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class EpochConfig:
    """Reference msgs.proto:321-328."""

    number: int
    leaders: Tuple[int, ...]
    planned_expiration: int


@dataclass(frozen=True, slots=True)
class CheckpointMsg:
    """Checkpoint attestation message (reference msgs.proto:266-269)."""

    seq_no: int
    value: bytes


@dataclass(frozen=True, slots=True)
class EpochChangeSetEntry:
    """P-set / Q-set entry (reference msgs.proto:285-289)."""

    epoch: int
    seq_no: int
    digest: bytes


@dataclass(frozen=True, slots=True)
class EpochChange:
    """PBFT view-change message, Mir-adapted (reference msgs.proto:275-299)."""

    new_epoch: int
    checkpoints: Tuple[CheckpointMsg, ...]
    p_set: Tuple[EpochChangeSetEntry, ...]
    q_set: Tuple[EpochChangeSetEntry, ...]


@dataclass(frozen=True, slots=True)
class EpochChangeAck:
    """Reference msgs.proto:305-314."""

    originator: int
    epoch_change: EpochChange


@dataclass(frozen=True, slots=True)
class NewEpochConfig:
    """Reference msgs.proto:330-340."""

    config: EpochConfig
    starting_checkpoint: CheckpointMsg
    final_preprepares: Tuple[bytes, ...]


@dataclass(frozen=True, slots=True)
class RemoteEpochChange:
    node_id: int
    digest: bytes


@dataclass(frozen=True, slots=True)
class NewEpoch:
    """NewView analogue; config Bracha-broadcast (reference msgs.proto:342-362)."""

    new_config: NewEpochConfig
    epoch_changes: Tuple[RemoteEpochChange, ...]


# ---------------------------------------------------------------------------
# The 15 consensus message variants (reference msgs.proto:189-207).
# Variants that share a payload type in the proto oneof (fetch_request /
# request_ack are both msgs.RequestAck; new_epoch_echo / new_epoch_ready are
# both NewEpochConfig) get distinct wrapper classes so dispatch is by type.
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class Preprepare:
    seq_no: int
    epoch: int
    batch: Tuple[RequestAck, ...]


@dataclass(frozen=True, slots=True)
class Prepare:
    seq_no: int
    epoch: int
    digest: bytes


@dataclass(frozen=True, slots=True)
class Commit:
    seq_no: int
    epoch: int
    digest: bytes


@dataclass(frozen=True, slots=True)
class Suspect:
    epoch: int


@dataclass(frozen=True, slots=True)
class NewEpochEcho:
    config: NewEpochConfig


@dataclass(frozen=True, slots=True)
class NewEpochReady:
    config: NewEpochConfig


@dataclass(frozen=True, slots=True)
class FetchBatch:
    seq_no: int
    digest: bytes


@dataclass(frozen=True, slots=True)
class ForwardBatch:
    seq_no: int
    request_acks: Tuple[RequestAck, ...]
    digest: bytes


@dataclass(frozen=True, slots=True)
class FetchRequest:
    ack: RequestAck


@dataclass(frozen=True, slots=True)
class ForwardRequest:
    request_ack: RequestAck
    request_data: bytes


@dataclass(frozen=True, slots=True)
class AckMsg:
    """Broadcast request acknowledgement (proto oneof field ``request_ack``)."""

    ack: RequestAck


@_weakrefable_dataclass
class MsgBatch:
    """Transport envelope: a sequence of consensus messages from one sender
    to the same targets, delivered atomically.  Nesting is not allowed.

    Processing order: the receiver applies the envelope's Prepare/Commit
    votes first (in order), then the remaining messages (in order) — see
    ``machine.StateMachine.step``.  Relative to per-message delivery this is
    merely a different (still deterministic) interleaving, which the
    protocol must tolerate from any asynchronous network anyway.

    Extension over the reference, whose Link sends every protocol message as
    its own transmission.  Consensus traffic is many tiny messages — at N
    replicas each sequence costs O(N²) Prepares/Commits and each epoch change
    O(N³) EpochChangeAcks — so aggregating everything a replica emits to the
    same destination in one processing iteration amortizes per-message
    transport and event dispatch."""

    msgs: Tuple["Msg", ...]


@dataclass(frozen=True, slots=True)
class AckBatch:
    """Aggregated request acknowledgements: semantically identical to sending
    each contained ack as its own ``AckMsg`` to the same targets, in order.

    Extension over the reference, which broadcasts one message per ack
    (``client_hash_disseminator.go:878-895``).  The ack flood is the
    throughput-dominant traffic class — O(N²) messages per request across the
    cluster — so aggregating the acks a replica generates in one step
    amortizes per-message transport and dispatch cost over the whole batch
    (the Mir paper itself batches dissemination)."""

    acks: Tuple[RequestAck, ...]


Msg = Union[
    Preprepare,
    Prepare,
    Commit,
    CheckpointMsg,
    Suspect,
    EpochChange,
    EpochChangeAck,
    NewEpoch,
    NewEpochEcho,
    NewEpochReady,
    FetchBatch,
    ForwardBatch,
    FetchRequest,
    ForwardRequest,
    AckMsg,
    AckBatch,
    MsgBatch,
]


# ---------------------------------------------------------------------------
# Persistent WAL entries (8 kinds; reference msgs.proto:127-186).
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class QEntry:
    """Persisted before a batch is preprepared (reference msgs.proto:157-164)."""

    seq_no: int
    digest: bytes
    requests: Tuple[RequestAck, ...]


@dataclass(frozen=True, slots=True)
class PEntry:
    """Persisted before a batch is prepared (reference msgs.proto:166-171)."""

    seq_no: int
    digest: bytes


@dataclass(frozen=True, slots=True)
class CEntry:
    """Persisted before a Checkpoint message is sent (reference msgs.proto:173-179)."""

    seq_no: int
    checkpoint_value: bytes
    network_state: NetworkState


@dataclass(frozen=True, slots=True)
class NEntry:
    """New sequence-window allocation marker (reference msgs.proto:141-146)."""

    seq_no: int
    epoch_config: EpochConfig


@dataclass(frozen=True, slots=True)
class FEntry:
    """Graceful epoch-end marker (reference msgs.proto:148-150)."""

    ends_epoch_config: EpochConfig


@dataclass(frozen=True, slots=True)
class ECEntry:
    """Epoch-change-sent marker; halts truncation (reference msgs.proto:152-155)."""

    epoch_number: int


@dataclass(frozen=True, slots=True)
class TEntry:
    """State-transfer-requested marker (reference msgs.proto:157-160)."""

    seq_no: int
    value: bytes


# Suspect doubles as the eighth persistent kind (reference msgs.proto:127-139).
Persistent = Union[QEntry, PEntry, CEntry, NEntry, FEntry, ECEntry, TEntry, Suspect]
