"""Status introspection: deep state snapshots and the ASCII grid renderer.

Rebuild of reference ``pkg/status/status.go`` plus the per-tracker
``status()`` methods scattered through ``pkg/statemachine``.  Here the
snapshot is built externally from the tracker objects (one reader module
instead of a method per class); structures serialize via
``dataclasses.asdict`` for the JSON surface and ``pretty()`` renders the
reference's bucket/sequence/checkpoint grid.
"""

from __future__ import annotations

import dataclasses
import io
import json
from dataclasses import dataclass
from typing import List, Tuple

from .statemachine.epoch_target import EpochTargetState
from .statemachine.machine import MachineState, StateMachine
from .statemachine.sequence import SeqState
from .statemachine.stateless import seq_to_bucket

# ---------------------------------------------------------------------------
# Snapshot structures (reference status.go:16-163).
# ---------------------------------------------------------------------------


@dataclass
class CheckpointStatus:
    seq_no: int
    max_agreements: int
    net_quorum: bool
    local_decision: bool


@dataclass
class BucketStatus:
    id: int
    leader: bool
    sequences: List[int]  # SeqState values


@dataclass
class EpochChangeMsgStatus:
    digest: bytes
    acks: List[int]


@dataclass
class EpochChangeStatus:
    source: int
    messages: List[EpochChangeMsgStatus]


@dataclass
class EpochTargetStatus:
    number: int
    state: int  # EpochTargetState value
    epoch_changes: List[EpochChangeStatus]
    echos: List[int]
    readies: List[int]
    suspicions: List[int]
    leaders: List[int]


@dataclass
class EpochTrackerStatus:
    active_epoch: EpochTargetStatus


@dataclass
class MsgBufferStatus:
    component: str
    size: int
    msgs: int


@dataclass
class NodeBufferStatus:
    id: int
    size: int
    msgs: int
    msg_buffers: List[MsgBufferStatus]


@dataclass
class ClientTrackerStatus:
    client_id: int
    low_watermark: int
    high_watermark: int
    allocated: List[int]  # 0 unallocated, 1 allocated, 2 committed


@dataclass
class StateMachineStatus:
    node_id: int
    low_watermark: int
    high_watermark: int
    epoch_tracker: EpochTrackerStatus
    node_buffers: List[NodeBufferStatus]
    buckets: List[BucketStatus]
    checkpoints: List[CheckpointStatus]
    client_windows: List[ClientTrackerStatus]

    def to_json(self) -> str:
        def default(o):
            if isinstance(o, bytes):
                return o.hex()
            raise TypeError(f"unserializable {type(o)}")

        return json.dumps(dataclasses.asdict(self), default=default)

    def pretty(self) -> str:
        return pretty(self)


# ---------------------------------------------------------------------------
# Snapshot construction.
# ---------------------------------------------------------------------------


def _epoch_change_status(changes) -> List[EpochChangeStatus]:
    out = []
    for node in sorted(changes):
        votes = changes[node]
        msgs = [
            EpochChangeMsgStatus(digest=digest, acks=sorted(parsed.acks))
            for digest, parsed in sorted(votes.parsed_by_digest.items())
        ]
        out.append(EpochChangeStatus(source=node, messages=msgs))
    return out


def _bucket_status(et) -> Tuple[int, int, List[BucketStatus]]:
    """Low/high watermarks + per-bucket sequence states
    (reference epoch_target.go:876-955 and epoch_active.go:status)."""
    network_config = et.network_config
    num_buckets = network_config.number_of_buckets

    if et.active_epoch is not None and et.active_epoch.sequences:
        ae = et.active_epoch
        low, high = ae.low_watermark(), ae.high_watermark()
        buckets = [
            BucketStatus(
                id=i,
                leader=ae.buckets[i] == et.my_config.id,
                sequences=[0] * ((high - low + 1) // num_buckets),
            )
            for i in range(num_buckets)
        ]
        for seq_no in range(low, high + 1):
            seq = ae.sequence(seq_no)
            bucket = seq_to_bucket(seq_no, network_config)
            buckets[bucket].sequences[(seq_no - low) // num_buckets] = int(seq.state)
        return low, high, buckets

    low = high = 0
    if et.state <= EpochTargetState.FETCHING or et.leader_new_epoch is None:
        if et.my_epoch_change is not None:
            low = et.my_epoch_change.low_watermark + 1
            high = low + 2 * network_config.checkpoint_interval - 1
    else:
        low = et.leader_new_epoch.new_config.starting_checkpoint.seq_no + 1
        high = low + 2 * network_config.checkpoint_interval - 1

    width = (high - low) // num_buckets + 1 if high >= low else 0
    buckets = [
        BucketStatus(id=i, leader=False, sequences=[0] * width)
        for i in range(num_buckets)
    ]

    def set_status(seq_no: int, state: int) -> None:
        bucket = seq_to_bucket(seq_no, network_config)
        column = (seq_no - low) // num_buckets
        if 0 <= column < len(buckets[bucket].sequences):
            buckets[bucket].sequences[column] = state

    if et.state <= EpochTargetState.FETCHING:
        if et.my_epoch_change is not None:
            for seq_no in et.my_epoch_change.q_set:
                if seq_no >= low:
                    set_status(seq_no, int(SeqState.PREPREPARED))
            for seq_no in et.my_epoch_change.p_set:
                if seq_no >= low:
                    set_status(seq_no, int(SeqState.PREPARED))
        for seq_no in range(low, et.commit_state.highest_commit + 1):
            set_status(seq_no, int(SeqState.COMMITTED))
        return low, high, buckets

    for seq_no in range(low, high + 1):
        if et.state == EpochTargetState.ECHOING:
            state = int(SeqState.PREPREPARED)
        elif et.state == EpochTargetState.READYING:
            state = int(SeqState.PREPARED)
        else:
            state = 0
        if seq_no <= et.commit_state.highest_commit or et.state == EpochTargetState.READY:
            state = int(SeqState.COMMITTED)
        set_status(seq_no, state)
    return low, high, buckets


def snapshot(sm: StateMachine) -> StateMachineStatus:
    """Build a deep status snapshot of an initialized state machine
    (reference state_machine.go:403-438)."""
    if sm.state != MachineState.INITIALIZED:
        return StateMachineStatus(
            node_id=0,
            low_watermark=0,
            high_watermark=0,
            epoch_tracker=EpochTrackerStatus(
                active_epoch=EpochTargetStatus(0, 0, [], [], [], [], [])
            ),
            node_buffers=[],
            buckets=[],
            checkpoints=[],
            client_windows=[],
        )

    et = sm.epoch_tracker.current_epoch
    low, high, buckets = _bucket_status(et)

    echos = sorted(n for sources in et.echos.values() for n in sources)
    readies = sorted(n for sources in et.readies.values() for n in sources)
    leaders = (
        list(et.leader_new_epoch.new_config.config.leaders)
        if et.leader_new_epoch is not None
        else []
    )

    checkpoints = [
        CheckpointStatus(
            seq_no=cp.seq_no,
            max_agreements=max(
                (len(nodes) for nodes in cp.values.values()), default=0
            ),
            net_quorum=cp.committed_value is not None,
            local_decision=cp.my_value is not None,
        )
        for cp in sorted(
            sm.checkpoint_tracker.checkpoint_map.values(),
            key=lambda cp: cp.seq_no,
        )
    ]

    client_windows = []
    # Votes may be accumulating in the native ack plane; make the Python
    # view current before rendering it.
    sm.client_hash_disseminator.sync_for_introspection()
    for client_state in sm.client_tracker.client_states:
        client = sm.client_hash_disseminator.clients[client_state.id]
        allocated = []
        last_non_zero = 0
        for i, crn in enumerate(client.req_nos.values()):
            if crn.committed:
                allocated.append(2)
                last_non_zero = i
            elif crn.requests:
                allocated.append(1)
                last_non_zero = i
            else:
                allocated.append(0)
        client_windows.append(
            ClientTrackerStatus(
                client_id=client_state.id,
                low_watermark=client.client_state.low_watermark,
                high_watermark=client.high_watermark,
                allocated=allocated[:last_non_zero],
            )
        )

    node_buffers = []
    for node_id in sorted(sm.node_buffers.node_map):
        nb = sm.node_buffers.node_map[node_id]
        msg_buffers = sorted(
            (
                MsgBufferStatus(
                    component=mb.component,
                    size=sum(size for _, size in mb.buffer),
                    msgs=len(mb.buffer),
                )
                for mb in nb.msg_bufs
            ),
            key=lambda m: (m.component, m.size, m.msgs),
        )
        node_buffers.append(
            NodeBufferStatus(
                id=nb.id,
                size=nb.total_size,
                msgs=sum(m.msgs for m in msg_buffers),
                msg_buffers=msg_buffers,
            )
        )

    return StateMachineStatus(
        node_id=sm.my_config.id,
        low_watermark=low,
        high_watermark=high,
        epoch_tracker=EpochTrackerStatus(
            active_epoch=EpochTargetStatus(
                number=et.number,
                state=int(et.state),
                epoch_changes=_epoch_change_status(et.changes),
                echos=echos,
                readies=readies,
                suspicions=sorted(et.suspicions),
                leaders=leaders,
            )
        ),
        node_buffers=node_buffers,
        buckets=buckets,
        checkpoints=checkpoints,
        client_windows=client_windows,
    )


# ---------------------------------------------------------------------------
# ASCII renderer (reference status.go:165-303).
# ---------------------------------------------------------------------------

_SEQ_CHARS = {
    int(SeqState.UNINITIALIZED): " ",
    int(SeqState.ALLOCATED): "A",
    int(SeqState.PENDING_REQUESTS): "F",
    int(SeqState.READY): "R",
    int(SeqState.PREPREPARED): "Q",
    int(SeqState.PREPARED): "P",
    int(SeqState.COMMITTED): "C",
}


def pretty(s: StateMachineStatus) -> str:
    buf = io.StringIO()
    w = buf.write
    et = s.epoch_tracker.active_epoch
    w("===========================================\n")
    w(
        f"NodeID={s.node_id}, LowWatermark={s.low_watermark}, "
        f"HighWatermark={s.high_watermark}, Epoch={et.number}\n"
    )
    w("===========================================\n\n")
    w(f"=== Epoch Number {et.number} ===\n")
    w(f"Epoch is in state: {EpochTargetState(et.state).name}\n")
    w("  EpochChanges:\n")
    for ec in et.epoch_changes:
        for msg in ec.messages:
            w(
                f"    Source={ec.source} Digest={msg.digest[:2].hex()} "
                f"Acks={msg.acks}\n"
            )
    w(f"  Echos: {et.echos}\n")
    w(f"  Readies: {et.readies}\n")
    w(f"  Suspicions: {et.suspicions}\n")
    w(f"  Leaders: {et.leaders}\n")
    w("\n=====================\n\n")

    num_buckets = max(len(s.buckets), 1)
    columns = (
        range(s.low_watermark, s.high_watermark + 1, num_buckets)
        if s.high_watermark > s.low_watermark
        else []
    )

    def h_rule():
        w("--" * len(list(columns)))

    if s.high_watermark == s.low_watermark:
        w("=== Empty Watermarks ===\n")
    elif s.high_watermark - s.low_watermark > 10000:
        w(
            f"=== Suspiciously wide watermarks [{s.low_watermark}, "
            f"{s.high_watermark}] ===\n"
        )
        return buf.getvalue()
    else:
        digits = len(str(s.high_watermark))
        for i in range(digits, 0, -1):
            magnitude = 10 ** (i - 1)
            for seq_no in columns:
                w(f" {seq_no // magnitude % 10}")
            w("\n")
        h_rule()
        w("- === Buckets ===\n")
        for bucket in s.buckets:
            for state in bucket.sequences:
                w("|" + _SEQ_CHARS.get(state, "?"))
            w(
                f"| Bucket={bucket.id} (LocalLeader)\n"
                if bucket.leader
                else f"| Bucket={bucket.id}\n"
            )
        h_rule()
        w("- === Checkpoints ===\n")
        cps = {cp.seq_no: cp for cp in s.checkpoints}
        for seq_no in columns:
            cp = cps.get(seq_no)
            w(f"|{cp.max_agreements}" if cp else "| ")
        w("| Max Agreements\n")
        for seq_no in columns:
            cp = cps.get(seq_no)
            if cp is None:
                w("| ")
            elif cp.net_quorum and not cp.local_decision:
                w("|N")
            elif cp.net_quorum and cp.local_decision:
                w("|G")
            elif cp.local_decision:
                w("|M")
            else:
                w("|P")
        w("| Status\n")

    h_rule()
    w("-\n\n\n Request Windows\n")
    h_rule()
    for cw in s.client_windows:
        w(
            f"\nClient {cw.client_id:x} L/H {cw.low_watermark}/"
            f"{cw.high_watermark} : {cw.allocated}\n"
        )
        h_rule()

    w("\n\n Message Buffers\n")
    h_rule()
    for nb in s.node_buffers:
        w(f"- === Node {nb.id:3d} buffers === \n")
        w(f"  Bytes={nb.size:<8d}, Messages={nb.msgs:<5d}\n")
        for mb in nb.msg_buffers:
            w(
                f"  -  Bytes={mb.size:<8d} Messages={mb.msgs:<5d} "
                f"Component={mb.component}\n"
            )
    w("\n\nDone\n")
    return buf.getvalue()
