"""KIND_GROUP subframe codec + committed-batch log shipping.

Every KIND_GROUP frame payload is one subframe::

    subtype 1 byte   SHIP_* / MAP_*
    group   4 bytes  big-endian group id (0 for MAP_* frames)
    seq     8 bytes  big-endian sequence number (0 where meaningless)
    body    rest     subtype-specific bytes

Subtypes:

* ``SHIP_SUBSCRIBE`` — observer -> node: tail group ``group`` from
  sequence ``seq`` (exclusive; 0 means "from genesis").
* ``SHIP_BATCH`` — node -> observer: one committed-batch journal line
  (the ``commits.log`` format) for sequence ``seq``.
* ``SHIP_CHECKPOINT`` — node -> observer: the group took a checkpoint at
  ``seq``; body is the 32-byte snapshot digest.
* ``SHIP_RESET`` — node -> observer: the subscription start is below the
  feed's retained backlog; bootstrap from the checkpoint at ``seq``
  (body = digest, fetched over the existing KIND_SNAPSHOT plane) before
  tailing resumes.
* ``MAP_REQUEST`` / ``MAP_REPLY`` — group-map discovery; the reply body
  is :meth:`~mirbft_tpu_torch.groups.routing.GroupMap.to_json_bytes`.
* ``RESHARD_PLAN`` — harness -> node: stage one serialized
  :class:`~mirbft_tpu_torch.groups.reshard.ReshardPlan` on a group member
  ahead of the cutover marker (``seq`` carries the marker req_no the
  plan is keyed by); answered with ``RESHARD_STATE``.
* ``RESHARD_QUERY`` / ``RESHARD_STATE`` — reshard progress poll; the
  state body is the coordinator's JSON state document (phase,
  map_version, cutover seq).
* ``RESHARD_CUTOVER`` — node -> observer: the group committed its
  cutover marker and crossed the reconfiguration checkpoint at ``seq``;
  body is the new map's JSON wire form, so bootstrapping learners hear
  about the epoch they are being promoted into on the same feed they
  tail (docs/SHARDING.md "Elastic resharding").

The registry (:data:`SUBTYPE_NAMES`) and :func:`sample_payloads` exist
for mirlint's wire-schema pass: every subtype must be named, unique, and
round-trip through :func:`encode`/:func:`decode`.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Callable, List, Optional, Tuple

from .. import metrics as metrics_mod

SHIP_SUBSCRIBE = 0
SHIP_BATCH = 1
SHIP_CHECKPOINT = 2
SHIP_RESET = 3
MAP_REQUEST = 4
MAP_REPLY = 5
RESHARD_PLAN = 6
RESHARD_QUERY = 7
RESHARD_STATE = 8
RESHARD_CUTOVER = 9

# Subtype registry: mirlint's wire pass checks this stays in lockstep
# with the SHIP_*/MAP_*/RESHARD_* constants above
# (docs/STATIC_ANALYSIS.md).
SUBTYPE_NAMES = {
    SHIP_SUBSCRIBE: "ship_subscribe",
    SHIP_BATCH: "ship_batch",
    SHIP_CHECKPOINT: "ship_checkpoint",
    SHIP_RESET: "ship_reset",
    MAP_REQUEST: "map_request",
    MAP_REPLY: "map_reply",
    RESHARD_PLAN: "reshard_plan",
    RESHARD_QUERY: "reshard_query",
    RESHARD_STATE: "reshard_state",
    RESHARD_CUTOVER: "reshard_cutover",
}

_SUB_HEADER = struct.Struct(">BIQ")

# The feed pushes to subscribers and is fed by the node's app thread;
# backlog, checkpoint marker, and the subscriber list all move under the
# feed lock (docs/STATIC_ANALYSIS.md lock-discipline pass).
MIRLINT_SHARED_STATE = {
    "ShipFeed._tail": "_lock",
    "ShipFeed._checkpoint": "_lock",
    "ShipFeed._subs": "_lock",
    "ShipFeed._head_seq": "_lock",
}


def encode(subtype: int, group_id: int, seq: int, body: bytes = b"") -> bytes:
    if subtype not in SUBTYPE_NAMES:
        raise ValueError(f"unknown KIND_GROUP subtype {subtype}")
    return _SUB_HEADER.pack(subtype, group_id, seq) + body


def decode(payload: bytes) -> Tuple[int, int, int, bytes]:
    """``(subtype, group_id, seq, body)``; raises ValueError on garbage."""
    if len(payload) < _SUB_HEADER.size:
        raise ValueError(f"KIND_GROUP subframe too short ({len(payload)}B)")
    subtype, group_id, seq = _SUB_HEADER.unpack_from(payload)
    if subtype not in SUBTYPE_NAMES:
        raise ValueError(f"unknown KIND_GROUP subtype {subtype}")
    return subtype, group_id, seq, payload[_SUB_HEADER.size:]


def encode_subscribe(group_id: int, from_seq: int) -> bytes:
    return encode(SHIP_SUBSCRIBE, group_id, from_seq)


def encode_batch(group_id: int, seq: int, line: bytes) -> bytes:
    return encode(SHIP_BATCH, group_id, seq, line)


def encode_checkpoint(group_id: int, seq: int, digest: bytes) -> bytes:
    return encode(SHIP_CHECKPOINT, group_id, seq, digest)


def encode_reset(group_id: int, seq: int, digest: bytes) -> bytes:
    return encode(SHIP_RESET, group_id, seq, digest)


def encode_map_request() -> bytes:
    return encode(MAP_REQUEST, 0, 0)


def encode_map_reply(map_bytes: bytes) -> bytes:
    return encode(MAP_REPLY, 0, 0, map_bytes)


def encode_reshard_plan(
    group_id: int, marker_req_no: int, plan_bytes: bytes
) -> bytes:
    return encode(RESHARD_PLAN, group_id, marker_req_no, plan_bytes)


def encode_reshard_query(group_id: int) -> bytes:
    return encode(RESHARD_QUERY, group_id, 0)


def encode_reshard_state(group_id: int, state_bytes: bytes) -> bytes:
    return encode(RESHARD_STATE, group_id, 0, state_bytes)


def encode_reshard_cutover(
    group_id: int, cutover_seq: int, map_bytes: bytes
) -> bytes:
    return encode(RESHARD_CUTOVER, group_id, cutover_seq, map_bytes)


def sample_payloads() -> dict:
    """One representative payload per subtype — mirlint round-trips every
    entry and fails if a subtype is missing from this table."""
    return {
        SHIP_SUBSCRIBE: encode_subscribe(1, 40),
        SHIP_BATCH: encode_batch(1, 41, b"41 ab cd"),
        SHIP_CHECKPOINT: encode_checkpoint(1, 40, b"\x02" * 32),
        SHIP_RESET: encode_reset(1, 40, b"\x02" * 32),
        MAP_REQUEST: encode_map_request(),
        MAP_REPLY: encode_map_reply(b'{"0": [["127.0.0.1", 1]]}'),
        RESHARD_PLAN: encode_reshard_plan(1, 0, b'{"action": "split"}'),
        RESHARD_QUERY: encode_reshard_query(1),
        RESHARD_STATE: encode_reshard_state(1, b'{"phase": 3}'),
        RESHARD_CUTOVER: encode_reshard_cutover(
            1, 40, b'{"map_version": 1}'
        ),
    }


class ShipFeed:
    """Host side of the observer plane: one feed per hosted group.

    The node's app wrapper calls :meth:`note_commit` for every applied
    batch and :meth:`note_checkpoint` when a checkpoint lands; the feed
    pushes SHIP_BATCH / SHIP_CHECKPOINT frames to every live subscriber
    and retains the commit lines since the last checkpoint as its
    catch-up backlog.  A subscriber asking for history below that backlog
    gets SHIP_RESET (bootstrap from the checkpoint over KIND_SNAPSHOT)
    followed by everything retained — so replay is gap-free by
    construction: the backlog always covers (last checkpoint, head].

    Pushes are serialized under the feed lock; a subscriber whose socket
    errors is dropped on the spot.  A *stalled* (connected but unread)
    subscriber backpressures the feed — acceptable for the localhost
    harness and documented as a non-goal in docs/SHARDING.md.
    """

    def __init__(self, group_id: int, registry=None):
        self.group_id = group_id
        reg = registry if registry is not None else metrics_mod.default_registry
        self._lock = threading.Lock()
        self._tail: List[Tuple[int, bytes]] = []
        self._checkpoint: Optional[Tuple[int, bytes]] = None
        self._subs: List[Callable[[bytes], None]] = []
        self._head_seq = 0
        labels = {"group": str(group_id)}
        self._commits = reg.counter("group_commits_total", labels=labels)
        self._sent = reg.counter("ship_batches_sent_total", labels=labels)
        self._sub_gauge = reg.gauge("ship_subscribers", labels=labels)

    @staticmethod
    def _push(subs: List[Callable[[bytes], None]], payload: bytes) -> List:
        """Send to every subscriber; returns the dead ones (caller prunes
        under the feed lock)."""
        dead = []
        for send in subs:
            try:
                send(payload)
            except Exception:
                dead.append(send)
        return dead

    def note_commit(self, seq: int, line: str, trace=None) -> None:
        """Ship one committed batch line.  ``trace`` optionally maps
        ``"client:req"`` -> trace id hex; it rides after the line behind a
        NUL separator (a commit line is space-separated hex/decimal text,
        so NUL can never appear in it) and observers strip it before
        writing ``commits.log`` — byte identity with members is kept."""
        self._commits.inc()
        data = line.encode()
        if trace:
            data += b"\x00" + json.dumps(trace, sort_keys=True).encode()
        with self._lock:
            self._tail.append((seq, data))
            self._head_seq = max(self._head_seq, seq)
            if self._subs:
                self._sent.inc(len(self._subs))
            dead = self._push(
                list(self._subs), encode_batch(self.group_id, seq, data)
            )
            for send in dead:
                self._subs.remove(send)
            if dead:
                self._sub_gauge.set(len(self._subs))

    def note_checkpoint(self, seq: int, digest: bytes) -> None:
        with self._lock:
            self._checkpoint = (seq, digest)
            self._tail = [(s, d) for s, d in self._tail if s > seq]
            self._head_seq = max(self._head_seq, seq)
            dead = self._push(
                list(self._subs),
                encode_checkpoint(self.group_id, seq, digest),
            )
            for send in dead:
                self._subs.remove(send)
            if dead:
                self._sub_gauge.set(len(self._subs))

    def note_reshard_cutover(self, seq: int, map_bytes: bytes) -> None:
        """Announce a committed cutover to live subscribers.  Not added
        to the batch backlog — the marker batch itself is already in the
        tail; this frame just carries the new map to bootstrapping
        learners ahead of their promotion (docs/SHARDING.md)."""
        with self._lock:
            dead = self._push(
                list(self._subs),
                encode_reshard_cutover(self.group_id, seq, map_bytes),
            )
            for send in dead:
                self._subs.remove(send)
            if dead:
                self._sub_gauge.set(len(self._subs))

    def handle_subscribe(self, from_seq: int, send: Callable[[bytes], None]) -> None:
        """Register a subscriber and replay the catch-up window to it:
        RESET first if its start predates the retained backlog, then
        every retained batch past the start, then the current checkpoint
        marker (idempotent at the observer)."""
        with self._lock:
            start = from_seq
            if self._checkpoint is not None and from_seq < self._checkpoint[0]:
                send(
                    encode_reset(
                        self.group_id, self._checkpoint[0], self._checkpoint[1]
                    )
                )
                start = self._checkpoint[0]
            for seq, data in self._tail:
                if seq > start:
                    send(encode_batch(self.group_id, seq, data))
                    self._sent.inc()
            if self._checkpoint is not None:
                send(
                    encode_checkpoint(
                        self.group_id, self._checkpoint[0], self._checkpoint[1]
                    )
                )
            self._subs.append(send)
            self._sub_gauge.set(len(self._subs))

    def state(self) -> dict:
        """Diagnostics snapshot (tests)."""
        with self._lock:
            return {
                "group": self.group_id,
                "head_seq": self._head_seq,
                "backlog": len(self._tail),
                "checkpoint": self._checkpoint,
                "subscribers": len(self._subs),
            }
