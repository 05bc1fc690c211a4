"""Fault-injection DSL for the deterministic test engine.

Rebuild of reference ``pkg/testengine/manglers.go``.  The reference builds
its fluent matcher API via reflection over struct fields; here matchers are
plain chained predicates.  Usage reads the same::

    matching.msgs().from_nodes(1, 3).at_percent(10).drop()
    Until(matching.msgs().of_type(Commit).with_sequence(20)).delay(500)
    For(matching.msgs().from_self()).crash_and_restart_after(100, init_parms)

Filters apply first-to-last; order matters (reference manglers.go:26-34).

Two deliberate divergences from the reference's matcher semantics, both
consequences of this engine's transport envelopes (the reference delivers
every message bare; this engine coalesces a node's sends into ``MsgBatch``
envelopes and its acks into ``AckBatch``, processor/serial.py):

* **Envelope expansion** — message-scoped filters (``of_type``,
  ``with_sequence``, ``with_epoch``) match a delivered event if ANY message
  inside its envelope satisfies ALL of them ("the delivery contains a
  Commit for seq 10").  The action then applies to the WHOLE delivery —
  dropping an envelope drops everything bundled with the matching message,
  which is the honest semantics for a transport-level fault.
* **Ack batching** — ``of_type(AckMsg)`` also matches ``AckBatch`` (the
  batched transport form of the same traffic), so "drop 70% of acks"
  scenarios exercise what they did in the reference.

Every predicate carries an introspectable ``kind``/``params`` descriptor so
the native fast engine can compile a DSL-built mangler into its own
representation (see fastengine.py) and stay bit-identical to this one.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Type

from ..messages import (
    AckBatch,
    AckMsg,
    CheckpointMsg,
    Commit,
    EpochChange,
    EpochChangeAck,
    FetchBatch,
    ForwardBatch,
    Msg,
    MsgBatch,
    NewEpoch,
    NewEpochEcho,
    NewEpochReady,
    Preprepare,
    Prepare,
    Suspect,
)
from ..state import EventInitialParameters
from .queue import SimEvent


@dataclass
class MangleResult:
    event: SimEvent
    remangle: bool = False


def _msg_epoch(msg: Msg) -> Optional[int]:
    if isinstance(msg, (Preprepare, Prepare, Commit, Suspect)):
        return msg.epoch
    if isinstance(msg, EpochChange):
        return msg.new_epoch
    if isinstance(msg, EpochChangeAck):
        return msg.epoch_change.new_epoch
    if isinstance(msg, NewEpoch):
        return msg.new_config.config.number
    if isinstance(msg, (NewEpochEcho, NewEpochReady)):
        return msg.config.config.number
    return None


def _msg_seq_no(msg: Msg) -> Optional[int]:
    if isinstance(
        msg, (Preprepare, Prepare, Commit, CheckpointMsg, FetchBatch, ForwardBatch)
    ):
        return msg.seq_no
    return None


def _expand(msg: Msg):
    """The delivered message plus, for envelopes, every bundled message."""
    yield msg
    if isinstance(msg, MsgBatch):
        for inner in msg.msgs:
            yield from _expand(inner)


class Predicate:
    """One introspectable filter predicate.

    ``scope`` is ``"event"`` (fn(random, event) -> bool) or ``"msg"``
    (fn(msg) -> bool, evaluated per candidate message under envelope
    expansion).  ``kind``/``params`` describe the predicate for the native
    engine's mangler compiler."""

    __slots__ = ("kind", "params", "scope", "fn")

    def __init__(self, kind: str, params: tuple, scope: str, fn: Callable):
        self.kind = kind
        self.params = params
        self.scope = scope
        self.fn = fn


class Conditional:
    """A chainable conjunction of predicates (the reference's ``matching``).

    Event-scoped predicates are a plain conjunction over the event.
    Message-scoped predicates match if any single message in the delivered
    envelope satisfies all of them (see module docstring)."""

    def __init__(self, predicates: Sequence[Predicate]):
        self._predicates = list(predicates)

    def matches(self, random: int, event: SimEvent) -> bool:
        msg_preds: List[Predicate] = []
        for p in self._predicates:
            if p.scope == "msg":
                msg_preds.append(p)
            elif not p.fn(random, event):
                return False
        if not msg_preds:
            return True
        if event.msg_received is None:
            return False
        return any(
            all(p.fn(candidate) for p in msg_preds)
            for candidate in _expand(event.msg_received[1])
        )

    def _and(self, kind: str, params: tuple, scope: str, fn) -> "Conditional":
        return Conditional(
            self._predicates + [Predicate(kind, params, scope, fn)]
        )

    # --- message-scoped filters ---

    def from_self(self) -> "Conditional":
        return self._and(
            "from_self",
            (),
            "event",
            lambda r, e: e.msg_received is not None
            and e.msg_received[0] == e.target,
        )

    def from_node(self, node_id: int) -> "Conditional":
        return self.from_nodes(node_id)

    def from_nodes(self, *node_ids: int) -> "Conditional":
        # Ignores self-referential messages (links to self must stay reliable).
        return self._and(
            "from_nodes",
            tuple(node_ids),
            "event",
            lambda r, e: e.msg_received is not None
            and e.msg_received[0] != e.target
            and e.msg_received[0] in node_ids,
        )

    def to_node(self, node_id: int) -> "Conditional":
        return self.to_nodes(node_id)

    def to_nodes(self, *node_ids: int) -> "Conditional":
        return self._and(
            "to_nodes",
            tuple(node_ids),
            "event",
            lambda r, e: e.target in node_ids,
        )

    # synonyms used for startup matching
    for_node = to_node
    for_nodes = to_nodes

    def at_percent(self, percent: int) -> "Conditional":
        return self._and(
            "at_percent", (percent,), "event", lambda r, e: r % 100 <= percent
        )

    def with_sequence(self, seq_no: int) -> "Conditional":
        return self._and(
            "with_sequence",
            (seq_no,),
            "msg",
            lambda m: _msg_seq_no(m) == seq_no,
        )

    def with_epoch(self, epoch: int) -> "Conditional":
        return self._and(
            "with_epoch", (epoch,), "msg", lambda m: _msg_epoch(m) == epoch
        )

    def of_type(self, *msg_types: Type) -> "Conditional":
        ack_batched = AckMsg in msg_types

        def fn(m, _types=msg_types, _ab=ack_batched):
            return isinstance(m, _types) or (_ab and isinstance(m, AckBatch))

        return self._and("of_type", tuple(msg_types), "msg", fn)

    def from_client(self, client_id: int) -> "Conditional":
        return self._and(
            "from_client",
            (client_id,),
            "event",
            lambda r, e: e.client_proposal is not None
            and e.client_proposal[0] == client_id,
        )

    # --- terminal constructors (sugar for For(self).X()) ---

    def drop(self) -> "EventMangling":
        return For(self).drop()

    def jitter(self, max_delay: int) -> "EventMangling":
        return For(self).jitter(max_delay)

    def duplicate(self, max_delay: int) -> "EventMangling":
        return For(self).duplicate(max_delay)

    def delay(self, delay: int) -> "EventMangling":
        return For(self).delay(delay)

    def crash_and_restart_after(
        self, delay: int, init_parms: EventInitialParameters
    ) -> "EventMangling":
        return For(self).crash_and_restart_after(delay, init_parms)


class _MatchingNamespace:
    """Entry points (reference MatchMsgs / MatchNodeStartup /
    MatchClientProposal)."""

    @staticmethod
    def msgs() -> Conditional:
        return Conditional(
            [
                Predicate(
                    "msgs", (), "event", lambda r, e: e.msg_received is not None
                )
            ]
        )

    @staticmethod
    def node_startup() -> Conditional:
        return Conditional(
            [
                Predicate(
                    "node_startup",
                    (),
                    "event",
                    lambda r, e: e.initialize is not None,
                )
            ]
        )

    @staticmethod
    def client_proposal() -> Conditional:
        return Conditional(
            [
                Predicate(
                    "client_proposal",
                    (),
                    "event",
                    lambda r, e: e.client_proposal is not None,
                )
            ]
        )


matching = _MatchingNamespace()


# ---------------------------------------------------------------------------
# Concrete manglers (reference manglers.go:604-679).
# ---------------------------------------------------------------------------


class EventMangling:
    """A conditional mangler: applies ``action`` when the filter matches,
    passes the event through untouched otherwise.

    ``wrap`` ("for" | "until" | "after") carries the For/Until/After
    combinator; the latch state lives here so the base ``matcher`` stays a
    pure introspectable conjunction."""

    def __init__(
        self,
        matcher: Conditional,
        wrap: str,
        action_kind: str,
        action_params: tuple,
        action: Callable[[int, SimEvent], List[MangleResult]],
    ):
        self.matcher = matcher
        self.wrap = wrap
        self.action_kind = action_kind
        self.action_params = action_params
        self.action = action
        self._matched = False  # Until/After latch

    def _applies(self, random: int, event: SimEvent) -> bool:
        if self.wrap == "for":
            return self.matcher.matches(random, event)
        if self.wrap == "until":
            if self._matched or self.matcher.matches(random, event):
                self._matched = True
                return False
            return True
        if self.wrap == "after":
            if self._matched or self.matcher.matches(random, event):
                self._matched = True
                return True
            return False
        raise AssertionError(f"unknown mangler wrap {self.wrap!r}")

    def mangle(self, random: int, event: SimEvent) -> List[MangleResult]:
        if not self._applies(random, event):
            return [MangleResult(event)]
        return self.action(random, event)


class _Mangling:
    """Builder bound to a filter + combinator (the reference's ``Mangling``)."""

    def __init__(self, filter_: Conditional, wrap: str = "for"):
        self.filter = filter_
        self.wrap = wrap

    def do(self, action, kind: str = "custom", params: tuple = ()) -> EventMangling:
        return EventMangling(self.filter, self.wrap, kind, params, action)

    def drop(self) -> EventMangling:
        return self.do(lambda r, e: [], kind="drop")

    def jitter(self, max_delay: int) -> EventMangling:
        def action(r: int, e: SimEvent) -> List[MangleResult]:
            e.time += r % max_delay
            return [MangleResult(e)]

        return self.do(action, kind="jitter", params=(max_delay,))

    def duplicate(self, max_delay: int) -> EventMangling:
        def action(r: int, e: SimEvent) -> List[MangleResult]:
            clone = copy.copy(e)
            clone.time += r % max_delay
            return [MangleResult(e), MangleResult(clone)]

        return self.do(action, kind="duplicate", params=(max_delay,))

    def delay(self, delay: int) -> EventMangling:
        def action(r: int, e: SimEvent) -> List[MangleResult]:
            e.time += delay
            # remangle: a delayed event may be delayed again on next touch
            return [MangleResult(e, remangle=True)]

        return self.do(action, kind="delay", params=(delay,))

    def crash_and_restart_after(
        self, delay: int, init_parms: EventInitialParameters
    ) -> EventMangling:
        def action(r: int, e: SimEvent) -> List[MangleResult]:
            return [
                MangleResult(e),
                MangleResult(
                    SimEvent(
                        target=init_parms.id,
                        time=e.time + delay,
                        initialize=init_parms,
                    )
                ),
            ]

        return self.do(
            action, kind="crash_and_restart_after", params=(delay, init_parms)
        )


@dataclass(frozen=True)
class DropMessages:
    """Structured unconditional drop mangler.

    Equivalent to ``For(matching.msgs().from_nodes(*from_nodes)
    [.to_nodes(*to_nodes)]).drop()`` (empty set = match any), but applied by
    the native fast engine at its SEND queue (no per-event RNG draw), making
    it the cheapest mangler in the fast envelope (BASELINE config 4's
    silenced-leader scenario).  Self-links stay reliable, matching the
    ``from_nodes`` matcher."""

    from_nodes: tuple = ()
    to_nodes: tuple = ()

    def matches(self, source: int, target: int) -> bool:
        if source == target:
            return False
        if self.from_nodes and source not in self.from_nodes:
            return False
        if self.to_nodes and target not in self.to_nodes:
            return False
        return True

    def mangle(self, random: int, event: SimEvent) -> List[MangleResult]:
        if event.msg_received is None:
            return [MangleResult(event)]
        if self.matches(event.msg_received[0], event.target):
            return []
        return [MangleResult(event)]


# ---------------------------------------------------------------------------
# Spec serialization: the kind/params descriptors are JSON round-trippable,
# so a DSL-built program can be shipped to another process (tools/mirnet.py
# sends Byzantine wire programs to node children via cluster.json) and
# rebuilt bit-identically (net/byzantine.py compiles the result to wire
# faults).  crash_and_restart_after and .do(custom) carry live objects and
# are refused.
# ---------------------------------------------------------------------------

_MSG_TYPE_BY_NAME = {
    cls.__name__: cls
    for cls in (
        AckBatch,
        AckMsg,
        CheckpointMsg,
        Commit,
        EpochChange,
        EpochChangeAck,
        FetchBatch,
        ForwardBatch,
        MsgBatch,
        NewEpoch,
        NewEpochEcho,
        NewEpochReady,
        Preprepare,
        Prepare,
        Suspect,
    )
}

_SPEC_ACTIONS = ("drop", "jitter", "duplicate", "delay")
_ENTRY_PREDICATES = ("msgs", "node_startup", "client_proposal")


def spec_from_mangler(mangler: EventMangling) -> dict:
    """JSON-ready descriptor of a DSL-built mangler (inverse:
    :func:`mangler_from_spec`)."""
    if mangler.action_kind not in _SPEC_ACTIONS:
        raise ValueError(
            f"mangler action {mangler.action_kind!r} is not serializable"
        )
    predicates = []
    for p in mangler.matcher._predicates:
        params = p.params
        if p.kind == "of_type":
            params = tuple(t.__name__ for t in params)
        predicates.append({"kind": p.kind, "params": list(params)})
    return {
        "wrap": mangler.wrap,
        "predicates": predicates,
        "action": {
            "kind": mangler.action_kind,
            "params": list(mangler.action_params),
        },
    }


def mangler_from_spec(spec: dict) -> EventMangling:
    """Rebuild a mangler from :func:`spec_from_mangler` output (fresh latch
    state — Until/After start unmatched)."""
    cond: Optional[Conditional] = None
    for pd in spec["predicates"]:
        kind, params = pd["kind"], list(pd["params"])
        if cond is None:
            if kind not in _ENTRY_PREDICATES:
                raise ValueError(
                    f"spec must start with one of {_ENTRY_PREDICATES}, "
                    f"got {kind!r}"
                )
            cond = getattr(matching, kind)()
            continue
        if kind == "of_type":
            try:
                types = tuple(_MSG_TYPE_BY_NAME[name] for name in params)
            except KeyError as err:
                raise ValueError(f"unknown message type {err.args[0]!r}")
            cond = cond.of_type(*types)
        elif kind in ("from_self", "from_nodes", "to_nodes", "at_percent",
                      "with_sequence", "with_epoch", "from_client"):
            cond = getattr(cond, kind)(*params)
        else:
            raise ValueError(f"unknown predicate kind {kind!r}")
    if cond is None:
        raise ValueError("spec has no predicates")
    wrap = {"for": For, "until": Until, "after": After}.get(spec["wrap"])
    if wrap is None:
        raise ValueError(f"unknown wrap {spec['wrap']!r}")
    action = spec["action"]
    if action["kind"] not in _SPEC_ACTIONS:
        raise ValueError(f"unknown action kind {action['kind']!r}")
    return getattr(wrap(cond), action["kind"])(*action["params"])


def For(matcher: Conditional) -> _Mangling:
    """Apply whenever the condition matches (reference manglers.go:74-79)."""
    return _Mangling(matcher, "for")


def Until(matcher: Conditional) -> _Mangling:
    """Apply until the condition first matches (reference manglers.go:41-56)."""
    return _Mangling(matcher, "until")


def After(matcher: Conditional) -> _Mangling:
    """Apply only after the condition first matches
    (reference manglers.go:59-71)."""
    return _Mangling(matcher, "after")
