"""Pure action-execution functions (reference ``pkg/processor/serial.go``).

Ordering guarantees preserved from the reference:
* **WAL-before-send**: ``process_wal_actions`` performs all writes/truncates
  and a sync, then hands the WAL-dependent Sends onward (serial.go:128-156).
* **reqstore-sync-before-ack**: ``process_reqstore_events`` syncs the request
  store before its events reach the state machine (serial.go:62-69).
* Self-sends short-circuit into local Step events (serial.go:166-171).
"""

from __future__ import annotations

import operator
from typing import List, Optional, Tuple

from .. import metrics, tracing
from .. import state as st
from .. import messages as m
from ..messages import CEntry, EpochConfig, FEntry, NetworkState, Persistent
from ..statemachine.actions import Actions, Events
from ..statemachine.machine import StateMachine
from .interfaces import App, EventInterceptor, Hasher, Link, WAL, RequestStore


def process_reqstore_events(req_store: RequestStore, events: Events) -> Events:
    """Sync the request store, then release the events (durability barrier)."""
    req_store.sync()
    return events


def initialize_wal_for_new_node(
    wal: WAL,
    runtime_params: st.EventInitialParameters,
    initial_network_state: NetworkState,
    initial_checkpoint_value: bytes,
) -> Events:
    """Seed a fresh WAL with the genesis CEntry + FEntry
    (reference serial.go:71-113)."""
    entries: List[Persistent] = [
        CEntry(
            seq_no=0,
            checkpoint_value=initial_checkpoint_value,
            network_state=initial_network_state,
        ),
        FEntry(
            ends_epoch_config=EpochConfig(
                number=0,
                leaders=initial_network_state.config.nodes,
                planned_expiration=0,
            )
        ),
    ]
    events = Events().initialize(runtime_params)
    for i, entry in enumerate(entries):
        index = i + 1
        events.load_persisted_entry(index, entry)
        wal.write(index, entry)
    events.complete_initialization()
    wal.sync()
    return events


def recover_wal_for_existing_node(
    wal: WAL, runtime_params: st.EventInitialParameters
) -> Events:
    """Replay an existing WAL into initialization events
    (reference serial.go:115-126)."""
    events = Events().initialize(runtime_params)
    wal.load_all(lambda index, entry: events.load_persisted_entry(index, entry))
    events.complete_initialization()
    return events


def apply_wal_actions(
    wal: WAL, actions: Actions, request_store: Optional[RequestStore] = None
) -> Tuple[Actions, Optional[int]]:
    """The write half of a WAL batch: execute Persist/Truncate actions and
    collect the WAL-dependent Sends, WITHOUT the sync.  Returns
    ``(net_actions, truncated_at)``; the caller owns the durability
    barrier — it must sync the WAL before releasing ``net_actions`` to the
    network, and run request-store GC for ``truncated_at`` only after that
    sync (the pipeline scheduler overlaps batch k+1's writes with batch
    k's fsync through this split; ``process_wal_actions`` recombines the
    two halves for the serial path)."""
    net_actions = Actions()
    truncated_at: Optional[int] = None
    note = getattr(request_store, "note_checkpoint", None)
    for action in actions:
        if isinstance(action, st.ActionSend):
            net_actions.push_back(action)
        elif isinstance(action, st.ActionPersist):
            wal.write(action.index, action.entry)
            if note is not None and isinstance(action.entry, CEntry):
                note(
                    action.index,
                    {
                        client.id: client.low_watermark
                        for client in action.entry.network_state.clients
                    },
                )
        elif isinstance(action, st.ActionTruncate):
            wal.truncate(action.index)
            truncated_at = action.index
        else:
            raise AssertionError(
                f"unexpected WAL action type {type(action).__name__}"
            )
    return net_actions, truncated_at


def process_wal_actions(
    wal: WAL, actions: Actions, request_store: Optional[RequestStore] = None
) -> Actions:
    """Execute Persist/Truncate actions, sync, and pass Sends through —
    the fsync-before-send barrier (reference serial.go:128-156).

    When the request store supports checkpoint-keyed GC
    (``storage.LogStore``), the WAL worker is also where the GC protocol
    anchors: persisting a checkpoint CEntry *notes* its per-client low
    watermarks against its WAL index, and a Truncate — emitted only once
    a checkpoint is stable (statemachine/persisted.py) — releases the GC
    for the noted watermarks at or below that index.  Both hooks are
    advisory and degrade to no-ops on stores without them."""
    net_actions, truncated_at = apply_wal_actions(
        wal, actions, request_store=request_store
    )
    wal.sync()
    gc = getattr(request_store, "gc", None)
    if gc is not None and truncated_at is not None:
        gc(truncated_at)
    return net_actions


_ack_sort_key = operator.attrgetter("client_id", "req_no")


def _coalesce_sends(actions: Actions) -> List[st.ActionSend]:
    """Aggregate this iteration's sends per target set: AckMsg/AckBatch
    sends merge into one AckBatch, and if a target set still has more than
    one message the whole group is wrapped in a single MsgBatch envelope,
    emitted at the position of the group's first send.

    The reference transmits every protocol message individually; consensus
    traffic is many tiny messages (O(N²) Prepares/Commits per sequence,
    O(N³) EpochChangeAcks per epoch change, O(N²) acks per request), so
    per-message transport and dispatch dominate at scale.  The network
    offers no cross-message ordering guarantee and delivery order within
    the envelope is preserved, so coalescing one iteration's output is
    observationally equivalent — and deterministic, since grouping follows
    action order."""
    groups: dict = {}  # targets -> (first_index, msgs, acks)
    out: List[Optional[st.ActionSend]] = []
    for action in actions:
        if not isinstance(action, st.ActionSend):
            raise AssertionError(
                f"unexpected Net action type {type(action).__name__}"
            )
        slot = groups.get(action.targets)
        if slot is None:
            slot = (len(out), [], [])
            groups[action.targets] = slot
            out.append(None)  # placeholder keeps first-occurrence position
        msg = action.msg
        if isinstance(msg, m.AckMsg):
            slot[2].append(msg.ack)
        elif isinstance(msg, m.AckBatch):
            slot[2].extend(msg.acks)
        else:
            slot[1].append(msg)
    for targets, (index, msgs, acks) in groups.items():
        if acks:
            # Sort the merged batch by (client, req_no): the receiver's
            # disseminator consumes same-client in-window runs in one inlined
            # loop, so grouping maximizes run length.  Deterministic, and
            # order within an envelope carries no protocol meaning.
            acks.sort(key=_ack_sort_key)
            msgs.append(
                m.AckMsg(ack=acks[0])
                if len(acks) == 1
                else m.AckBatch(acks=tuple(acks))
            )
        out[index] = st.ActionSend(
            targets=targets,
            msg=msgs[0] if len(msgs) == 1 else m.MsgBatch(msgs=tuple(msgs)),
        )
    return [a for a in out if a is not None]


def _resolve_forwards(
    self_id: int, request_store: Optional[RequestStore], actions: Actions
) -> Actions:
    """Convert ActionForwardRequest into ActionSend(ForwardRequest) by
    resolving the ack against the request store.  Drops silently when the
    store lacks the body (GC'd since the action was emitted) or no store
    was provided — the requester's FetchRequest retry loop
    (disseminator.ClientRequest.fetch) re-asks another replica, so a
    dropped forward costs latency, never liveness."""
    if not any(isinstance(a, st.ActionForwardRequest) for a in actions):
        return actions
    resolved = Actions()
    for action in actions:
        if not isinstance(action, st.ActionForwardRequest):
            resolved.push_back(action)
            continue
        if request_store is None:
            continue
        data = request_store.get_request(action.ack)
        if data is None:
            continue
        msg = m.ForwardRequest(request_ack=action.ack, request_data=data)
        targets = tuple(t for t in action.targets if t != self_id)
        if targets:
            resolved.push_back(st.ActionSend(targets=targets, msg=msg))
    return resolved


def process_net_actions(
    self_id: int,
    link: Link,
    actions: Actions,
    request_store: Optional[RequestStore] = None,
) -> Events:
    """Sends to self become local Step events (reference serial.go:158-178).
    ForwardRequest actions resolve against the request store (see
    _resolve_forwards), then sends are coalesced per target set
    (see _coalesce_sends)."""
    events = Events()
    actions = _resolve_forwards(self_id, request_store, actions)
    for action in _coalesce_sends(actions):
        for replica in action.targets:
            if replica == self_id:
                events.step(replica, action.msg)
            else:
                link.send(replica, action.msg)
    return events


def process_hash_actions(hasher: Hasher, actions: Actions) -> Events:
    """The TPU hot path (reference serial.go:180-198, redesigned batched):
    every ActionHashRequest of the iteration becomes one entry in a single
    ``hash_batches`` call; the backend pads and vmaps them in one device
    dispatch.  Results are emitted in action order, so the event stream stays
    deterministic regardless of device timing."""
    hash_actions = []
    for action in actions:
        if not isinstance(action, st.ActionHashRequest):
            raise AssertionError(
                f"unexpected Hash action type {type(action).__name__}"
            )
        hash_actions.append(action)

    events = Events()
    if not hash_actions:
        return events
    metrics.histogram("hash_batch_size").observe(len(hash_actions))
    with tracing.default_tracer.span(
        "hash_batch", tid=1, args={"batches": len(hash_actions)}
    ):
        with metrics.timer("hash_dispatch_seconds"):
            digests = hasher.hash_batches(
                [action.data for action in hash_actions]
            )
    if len(digests) != len(hash_actions):
        raise AssertionError("hasher returned wrong number of digests")
    for action, digest in zip(hash_actions, digests):
        events.hash_result(digest, action.origin)
    return events


def process_app_actions(app: App, actions: Actions) -> Events:
    """Commit / Checkpoint / StateTransfer execution
    (reference serial.go:200-244)."""
    events = Events()
    committed = metrics.counter("committed_requests")
    for action in actions:
        if isinstance(action, st.ActionCommit):
            app.apply(action.batch)
            committed.inc(len(action.batch.requests))
        elif isinstance(action, st.ActionCheckpoint):
            value, pending_reconfigs = app.snap(
                action.network_config, action.client_states
            )
            events.checkpoint_result(
                seq_no=action.seq_no,
                value=value,
                network_state=NetworkState(
                    config=action.network_config,
                    clients=action.client_states,
                    pending_reconfigurations=tuple(pending_reconfigs),
                ),
                reconfigured=bool(pending_reconfigs),
            )
        elif isinstance(action, st.ActionStateTransfer):
            try:
                network_state = app.transfer_to(action.seq_no, action.value)
            except Exception:
                events.state_transfer_failed(action.seq_no, action.value)
            else:
                events.state_transfer_complete(
                    action.seq_no, action.value, network_state
                )
        else:
            raise AssertionError(
                f"unexpected App action type {type(action).__name__}"
            )
    return events


def process_state_machine_events(
    sm: StateMachine, interceptor: Optional[EventInterceptor], events: Events
) -> Actions:
    """Apply events to the deterministic state machine, tapping each through
    the interceptor, and close with an ActionsReceived marker correlating the
    resulting action batch to its events (reference serial.go:246-270)."""
    actions = Actions()
    for event in events:
        if interceptor is not None:
            interceptor.intercept(event)
        actions.concat(sm.apply_event(event))
    marker = st.EventActionsReceived()
    if interceptor is not None:
        interceptor.intercept(marker)
    # The marker is applied, not just recorded: it is the batch boundary at
    # which the state machine flushes deferred ack broadcasts
    # (reference state_machine.go:224-228 applies it as an event too).
    actions.concat(sm.apply_event(marker))
    return actions
