"""Network-ingress pre-validation.

Rebuild of reference ``pkg/processor/replicas.go`` + ``msgfilter.go``: a
structural sanity gate applied to every message before it enters the state
machine.  With the canonical wire codec, type confusion is already rejected
at decode time (``mirbft_tpu_torch.wire``); this layer re-validates structure for
messages arriving through in-process transports that bypass serialization,
and intercepts ForwardRequest before the state machine (reference
replicas.go:45-52 — its handling is deliberately external so apps can attach
their own signature validation; like the reference, the actual buffering is
not yet implemented).
"""

from __future__ import annotations

from typing import Dict

from ..messages import (
    AckBatch,
    AckMsg,
    MsgBatch,
    CheckpointMsg,
    Commit,
    EpochChange,
    EpochChangeAck,
    FetchBatch,
    FetchRequest,
    ForwardBatch,
    ForwardRequest,
    Msg,
    NewEpoch,
    NewEpochConfig,
    NewEpochEcho,
    NewEpochReady,
    Preprepare,
    Prepare,
    RequestAck,
    Suspect,
)
from ..statemachine.actions import Events

_MSG_TYPES = (
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
)


class MessageValidationError(ValueError):
    pass


def pre_process(msg: Msg) -> None:
    """Structural validation of all 15 message types
    (reference msgfilter.go:18-105)."""
    if not isinstance(msg, _MSG_TYPES):
        raise MessageValidationError(
            f"unknown message type {type(msg).__name__}"
        )
    if isinstance(msg, (FetchRequest, AckMsg)):
        if not isinstance(msg.ack, RequestAck):
            raise MessageValidationError("ack field must be a RequestAck")
    elif isinstance(msg, AckBatch):
        if not msg.acks:
            raise MessageValidationError("AckBatch must carry at least one ack")
        for ack in msg.acks:
            if not isinstance(ack, RequestAck):
                raise MessageValidationError(
                    "AckBatch entries must be RequestAcks"
                )
    elif isinstance(msg, MsgBatch):
        if not msg.msgs:
            raise MessageValidationError(
                "MsgBatch must carry at least one message"
            )
        for inner in msg.msgs:
            if isinstance(inner, MsgBatch):
                raise MessageValidationError("MsgBatch cannot nest")
            pre_process(inner)
    elif isinstance(msg, ForwardRequest):
        if not isinstance(msg.request_ack, RequestAck):
            raise MessageValidationError(
                "ForwardRequest request_ack must be a RequestAck"
            )
    elif isinstance(msg, NewEpoch):
        cfg = msg.new_config
        if not isinstance(cfg, NewEpochConfig) or cfg.config is None or (
            cfg.starting_checkpoint is None
        ):
            raise MessageValidationError("NewEpoch config incomplete")
    elif isinstance(msg, (NewEpochEcho, NewEpochReady)):
        cfg = msg.config
        if not isinstance(cfg, NewEpochConfig) or cfg.config is None or (
            cfg.starting_checkpoint is None
        ):
            raise MessageValidationError(
                f"{type(msg).__name__} config incomplete"
            )


def split_forward_requests(msg: Msg):
    """Separate ForwardRequests from a message (unwrapping one MsgBatch
    envelope level): returns ``(remainder_or_None, [forward_requests])``.
    The state machine's client message path does not accept ForwardRequest,
    so every ingress (threaded runtime and testengine alike) must intercept
    them — including inside envelopes — before stepping."""
    if isinstance(msg, ForwardRequest):
        return None, (msg,)
    if isinstance(msg, MsgBatch):
        forwards = tuple(
            inner for inner in msg.msgs if isinstance(inner, ForwardRequest)
        )
        if forwards:
            kept = tuple(
                inner
                for inner in msg.msgs
                if not isinstance(inner, ForwardRequest)
            )
            if not kept:
                return None, forwards
            return (
                kept[0] if len(kept) == 1 else MsgBatch(msgs=kept)
            ), forwards
    return msg, ()


class Replica:
    """Reference replicas.go:34-56.

    ``on_forward(source, forward_request)`` handles intercepted
    ForwardRequests (reference replicas.go:45-52 keeps their handling
    deliberately external so embedders can attach validation; here the node
    runtime wires it to ``Clients.ingest_forwarded`` and routes the result
    through the request-store durability barrier).  Without a handler,
    forwards are dropped at ingress as before."""

    __slots__ = ("id", "on_forward")

    def __init__(self, replica_id: int, on_forward=None):
        self.id = replica_id
        self.on_forward = on_forward

    def step(self, msg: Msg) -> Events:
        pre_process(msg)
        msg, forwards = split_forward_requests(msg)
        if forwards and self.on_forward is not None:
            for forward in forwards:
                self.on_forward(self.id, forward)
        if msg is None:
            return Events()
        return Events().step(self.id, msg)


class Replicas:
    """Reference replicas.go:14-32."""

    __slots__ = ("_replicas", "_on_forward")

    def __init__(self, on_forward=None):
        self._replicas: Dict[int, Replica] = {}
        self._on_forward = on_forward

    def replica(self, replica_id: int) -> Replica:
        r = self._replicas.get(replica_id)
        if r is None:
            r = Replica(replica_id, self._on_forward)
            self._replicas[replica_id] = r
        return r
