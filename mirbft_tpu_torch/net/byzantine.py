"""Byzantine wire mode: mangler DSL programs and active malice on a Link.

Two layers, both wrapping a real transport's ``send`` (the processor never
knows):

* :class:`WireMangler` — compiles ``testengine/manglers.py`` DSL programs
  (rebuilt from their JSON specs, :func:`~..testengine.manglers.
  mangler_from_spec`) into wire faults.  Message-scoped predicates
  (``of_type`` / ``with_sequence`` / ``with_epoch``) evaluate against the
  *decoded* outbound message (including ``MsgBatch`` envelope expansion,
  exactly the simulator's semantics); actions map to the wire as
  drop / delay / jitter / duplicate, with the DSL's sim-time units read as
  **milliseconds**.  ``crash_and_restart_after`` and custom actions carry
  live objects and are refused at spec time.
* :class:`ByzantineLink` — actively malicious peer behaviors beyond what a
  lossy network can do (docs/FAULTS.md):

  - **Equivocating leader** (``equivocate_epoch``): outbound Preprepares in
    the configured epoch are rewritten *per destination* with a
    protocol-invalid batch (an ack for a nonexistent client, different for
    every peer) — the exact shape ``statemachine/epoch_active.py`` must
    answer with a Suspect, not a crash.
  - **Stale replays** (``replay_kinds``): matching outbound messages
    (Suspect / EpochChange by default) are re-sent ``replay_copies`` more
    times after ``replay_ms`` — stale view-change votes and duplicated
    frames the dedup paths must absorb.

Every injected behavior counts in ``net_faults_injected_total{kind}``
(kinds ``equivocate`` / ``replay`` / ``mangler_*``), the same counter the
frame-level :class:`~.faults.FaultInjector` uses, so byzantine scenarios
are machine-checkable against the doctor's attribution.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .. import metrics as metrics_mod
from ..messages import EpochChange, Msg, MsgBatch, Preprepare, RequestAck, Suspect
from ..testengine.manglers import EventMangling, mangler_from_spec
from ..testengine.queue import SimEvent
from .faults import DelayScheduler

# Shared-state declaration for mirlint's lock-discipline pass: apply()
# runs on every sender thread, and both the mangler latch state and the
# RNG stream mutate on match, so they stay under the WireMangler lock
# (docs/STATIC_ANALYSIS.md).
MIRLINT_SHARED_STATE = {
    "WireMangler._manglers": "_lock",
    "WireMangler._rng": "_lock",
}

# Client ids this high can never exist in a standard network state; an ack
# claiming one is protocol-invalid at every honest replica.
_EQUIVOCATION_CLIENT_BASE = 1 << 20

_REPLAYABLE = {"Suspect": Suspect, "EpochChange": EpochChange}


@dataclass
class ByzantineBehaviors:
    """Active-malice knobs for one node (JSON round-trippable; shipped per
    node in mirnet's ``cluster.json``)."""

    # Rewrite own Preprepares of this epoch with per-dest invalid batches.
    equivocate_epoch: Optional[int] = None
    # Re-send matching outbound messages later (stale view-change replays).
    replay_kinds: Tuple[str, ...] = ()
    replay_ms: float = 150.0
    replay_copies: int = 1
    # Mangler DSL programs (spec_from_mangler output), applied after the
    # behaviors above.
    manglers: List[dict] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "equivocate_epoch": self.equivocate_epoch,
            "replay_kinds": list(self.replay_kinds),
            "replay_ms": self.replay_ms,
            "replay_copies": self.replay_copies,
            "manglers": list(self.manglers),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ByzantineBehaviors":
        for kind in d.get("replay_kinds", ()):
            if kind not in _REPLAYABLE:
                raise ValueError(f"unreplayable message kind {kind!r}")
        return cls(
            equivocate_epoch=d.get("equivocate_epoch"),
            replay_kinds=tuple(d.get("replay_kinds", ())),
            replay_ms=float(d.get("replay_ms", 150.0)),
            replay_copies=int(d.get("replay_copies", 1)),
            manglers=list(d.get("manglers", [])),
        )


class WireMangler:
    """Apply mangler DSL programs at ``Link.send`` granularity.

    Each outbound ``(dest, msg)`` becomes a synthetic
    ``SimEvent(target=dest, msg_received=(node_id, msg))`` so the DSL's
    matchers evaluate unchanged; action semantics on the wire:
    ``drop`` → discard, ``delay(d)`` → deliver after d ms, ``jitter(m)`` →
    deliver after (r % m) ms, ``duplicate(m)`` → deliver now plus a copy
    after (r % m) ms.  Programs chain in order, each consuming the
    previous one's output (the simulator applies one mangler per queue;
    chaining is the wire-mode extension)."""

    def __init__(
        self,
        node_id: int,
        manglers: List[EventMangling],
        seed: int = 0,
        registry: Optional[metrics_mod.Registry] = None,
    ):
        self.node_id = node_id
        self._manglers = manglers
        self._rng = random.Random((seed * 7919) ^ node_id)
        self._registry = (
            registry if registry is not None else metrics_mod.default_registry
        )
        self._lock = threading.Lock()  # latch state + rng

    def _count(self, kind: str) -> None:
        self._registry.counter(
            "net_faults_injected_total", labels={"kind": kind}
        ).inc()

    def apply(self, dest: int, msg: Msg) -> List[Tuple[float, Msg]]:
        """Returns ``[(delay_ms, msg), ...]`` — empty when dropped."""
        out = [(0.0, msg)]
        with self._lock:
            for mangler in self._manglers:
                nxt: List[Tuple[float, Msg]] = []
                for base_delay, m in out:
                    event = SimEvent(
                        target=dest,
                        time=0,
                        msg_received=(self.node_id, m),
                    )
                    rand = self._rng.getrandbits(62)
                    if not mangler._applies(rand, event):
                        nxt.append((base_delay, m))
                        continue
                    kind = mangler.action_kind
                    if kind == "drop":
                        self._count("mangler_drop")
                        continue
                    if kind == "delay":
                        (delay,) = mangler.action_params
                        self._count("mangler_delay")
                        nxt.append((base_delay + float(delay), m))
                    elif kind == "jitter":
                        (max_delay,) = mangler.action_params
                        self._count("mangler_delay")
                        nxt.append((base_delay + rand % max_delay, m))
                    elif kind == "duplicate":
                        (max_delay,) = mangler.action_params
                        self._count("mangler_duplicate")
                        nxt.append((base_delay, m))
                        nxt.append((base_delay + rand % max_delay, m))
                    else:
                        raise AssertionError(
                            f"unsupported wire action {kind!r}"
                        )
                out = nxt
                if not out:
                    break
        return out


class ByzantineLink:
    """A ``Link`` decorator injecting active malice before a real
    transport (module docstring).  Only the Link surface (``send``) is
    wrapped — lifecycle stays on the inner transport."""

    def __init__(
        self,
        inner,
        node_id: int,
        behaviors: Optional[ByzantineBehaviors] = None,
        seed: int = 0,
        registry: Optional[metrics_mod.Registry] = None,
    ):
        self.inner = inner
        self.node_id = node_id
        self.behaviors = (
            behaviors if behaviors is not None else ByzantineBehaviors()
        )
        self._registry = (
            registry if registry is not None else metrics_mod.default_registry
        )
        self._wire = WireMangler(
            node_id,
            [mangler_from_spec(s) for s in self.behaviors.manglers],
            seed=seed,
            registry=registry,
        )
        self._scheduler = DelayScheduler(name=f"net{node_id}-byz")
        self._replay_types = tuple(
            _REPLAYABLE[k] for k in self.behaviors.replay_kinds
        )

    def _count(self, kind: str) -> None:
        self._registry.counter(
            "net_faults_injected_total", labels={"kind": kind}
        ).inc()

    # --- behaviors ---

    def _equivocate(self, dest: int, msg: Msg) -> Msg:
        """Rewrite own Preprepares of the configured epoch with a per-dest
        protocol-invalid batch (an ack for a client that cannot exist) —
        a different lie for every peer."""
        epoch = self.behaviors.equivocate_epoch
        if isinstance(msg, Preprepare) and msg.epoch == epoch:
            self._count("equivocate")
            poisoned = RequestAck(
                client_id=_EQUIVOCATION_CLIENT_BASE + dest,
                req_no=0,
                digest=b"\x5a" * 32,
            )
            return Preprepare(
                seq_no=msg.seq_no, epoch=msg.epoch, batch=(poisoned,)
            )
        if isinstance(msg, MsgBatch):
            rewritten = tuple(self._equivocate(dest, m) for m in msg.msgs)
            if any(a is not b for a, b in zip(rewritten, msg.msgs)):
                return MsgBatch(msgs=rewritten)
        return msg

    def _maybe_replay(self, dest: int, msg: Msg) -> None:
        for m in self._expand(msg):
            if isinstance(m, self._replay_types):
                for copy_no in range(1, self.behaviors.replay_copies + 1):
                    self._count("replay")
                    self._scheduler.schedule(
                        copy_no * self.behaviors.replay_ms / 1000.0,
                        lambda d=dest, stale=m: self.inner.send(d, stale),
                    )

    @staticmethod
    def _expand(msg: Msg):
        yield msg
        if isinstance(msg, MsgBatch):
            for inner in msg.msgs:
                yield from ByzantineLink._expand(inner)

    # --- Link ---

    def send(self, dest: int, msg: Msg) -> None:
        if self.behaviors.equivocate_epoch is not None:
            msg = self._equivocate(dest, msg)
        if self._replay_types:
            self._maybe_replay(dest, msg)
        for delay_ms, out in self._wire.apply(dest, msg):
            if delay_ms > 0:
                self._scheduler.schedule(
                    delay_ms / 1000.0,
                    lambda d=dest, m=out: self.inner.send(d, m),
                )
            else:
                self.inner.send(dest, out)

    def stop(self) -> None:
        self._scheduler.stop()
