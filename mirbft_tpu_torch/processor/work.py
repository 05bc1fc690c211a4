"""Action/event routing between work categories.

Rebuild of reference ``pkg/processor/work.go``: classifies state-machine
output into WAL / net / hash / client / app queues, enforcing that Sends are
WAL-dependent unless the message type is safe to send before the WAL syncs
(RequestAck, Checkpoint, FetchBatch, ForwardBatch — reference work.go:144-158).
"""

from __future__ import annotations

from .. import state as st
from ..messages import AckBatch, AckMsg, CheckpointMsg, FetchBatch, ForwardBatch
from ..statemachine.actions import Actions, Events

# Message types that may be sent without waiting for the WAL sync.
_WAL_INDEPENDENT_SENDS = (AckMsg, AckBatch, CheckpointMsg, FetchBatch, ForwardBatch)


class WorkItems:
    """Reference work.go:15-136.

    ``forwarding`` routes ActionForwardRequest into the net category
    (where ``process_net_actions`` resolves it to a ForwardRequest send
    from the request store).  The testengine's differential mode passes
    False to mirror the native fast engine, which still drops forwards at
    this point (fastengine.cpp, reference work.go:176) — routing them
    would change the simulated schedule and break bit-identity."""

    __slots__ = (
        "wal_actions",
        "net_actions",
        "hash_actions",
        "client_actions",
        "app_actions",
        "req_store_events",
        "result_events",
        "forwarding",
    )

    def __init__(self, forwarding: bool = True):
        self.wal_actions = Actions()
        self.net_actions = Actions()
        self.hash_actions = Actions()
        self.client_actions = Actions()
        self.app_actions = Actions()
        self.req_store_events = Events()
        self.result_events = Events()
        self.forwarding = forwarding

    # --- result ingestion ---

    def add_hash_results(self, events: Events) -> None:
        self.result_events.concat(events)

    def add_net_results(self, events: Events) -> None:
        self.result_events.concat(events)

    def add_app_results(self, events: Events) -> None:
        self.result_events.concat(events)

    def add_client_results(self, events: Events) -> None:
        # Client results pass through the request-store durability barrier
        # before reaching the state machine.
        self.req_store_events.concat(events)

    def add_wal_results(self, actions: Actions) -> None:
        # WAL-dependent sends become eligible for the network after sync.
        self.net_actions.concat(actions)

    def add_req_store_results(self, events: Events) -> None:
        self.result_events.concat(events)

    def add_state_machine_results(self, actions: Actions) -> None:
        """Reference work.go:138-182."""
        for action in actions:
            if isinstance(action, st.ActionSend):
                if isinstance(action.msg, _WAL_INDEPENDENT_SENDS):
                    self.net_actions.push_back(action)
                else:
                    self.wal_actions.push_back(action)
            elif isinstance(action, st.ActionHashRequest):
                self.hash_actions.push_back(action)
            elif isinstance(action, (st.ActionPersist, st.ActionTruncate)):
                self.wal_actions.push_back(action)
            elif isinstance(action, (st.ActionCommit, st.ActionCheckpoint)):
                self.app_actions.push_back(action)
            elif isinstance(
                action,
                (
                    st.ActionAllocatedRequest,
                    st.ActionCorrectRequest,
                    st.ActionStateApplied,
                ),
            ):
                self.client_actions.push_back(action)
            elif isinstance(action, st.ActionForwardRequest):
                # Forwarding closes the pull path the reference leaves open
                # (work.go:176 "XXX address" drops these): the action is
                # WAL-independent — the referenced body is already durable
                # in the request store, and the reply carries no protocol
                # state of ours — so it rides the net category directly,
                # where process_net_actions resolves the ack to the stored
                # body and sends a ForwardRequest.  Ingress accepts it at
                # processor/replicas.py (digest-verified, routed through the
                # request-store durability barrier).  With forwarding off
                # (native-engine differential mode) the action is dropped
                # here, exactly as fastengine.cpp still does.
                if self.forwarding:
                    self.net_actions.push_back(action)
            elif isinstance(action, st.ActionStateTransfer):
                self.app_actions.push_back(action)
            else:
                raise AssertionError(
                    f"unexpected action type {type(action).__name__}"
                )
