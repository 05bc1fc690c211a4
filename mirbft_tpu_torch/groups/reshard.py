"""Elastic resharding: live split/merge of consensus groups.

The shard plane (docs/SHARDING.md) froze the group count at deploy time;
this module makes it elastic by composing surfaces that already exist:

* **Versioned maps** — :class:`~mirbft_tpu_torch.groups.routing.GroupMap` carries
  a monotonically increasing ``map_version`` and per-group ``(modulus,
  residue)`` routes, so a split refines the parent's key range in place
  (``(m, r)`` → parent ``(2m, r)``, child ``(2m, r+m)``) and every router
  can order two maps by version.
* **Observer bootstrap** — the child group's members first run as
  non-voting observers of the parent over the ship feed + KIND_SNAPSHOT
  plane, so by cutover they hold the parent's full committed prefix.
* **Marker cutover** — the parent commits an ordinary request from the
  reserved :data:`RESHARD_CONTROL_CLIENT` (present in every group's
  genesis client set).  Because the marker is consensus-ordered, every
  member observes it at the same sequence number and installs the new map
  at the same point in the log.
* **Reconfiguration** — at the first checkpoint after the marker the
  coordinator emits the pending reconfiguration the reference models
  (``ReconfigRemoveClient`` for a split/drain, the watermark-carrying
  ``ReconfigTransferClient`` for a merge), and the existing checkpoint
  machinery applies it one checkpoint later — so the total ordering stall
  is bounded by two checkpoint intervals by construction.

The :class:`ReshardCoordinator` is deliberately dumb about transport: the
harness stages a :class:`ReshardPlan` on every member (RESHARD_PLAN
subframe, persisted to disk for restart), the commit-log app calls
:meth:`~ReshardCoordinator.on_commit` per applied batch and
:meth:`~ReshardCoordinator.on_checkpoint` per snapshot, and everything
else — metrics, map install, phase persistence — happens inside.

A plan's semantics come from the *staged plan*, not the marker body:
batches circulate as RequestAcks (digests), so the only thing the marker
carries in-band is its identity ``(control client, req_no)``.

Known limitation (documented in docs/SHARDING.md): a member that
state-transfers *past* the marker inside the one-checkpoint window
between marker commit and reconfiguration emission never observes the
marker and would not install the map.  The scenarios do not inject
faults during a reshard; closing this requires carrying the reshard
phase in the snapshot body.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import metrics as metrics_mod
from ..messages import ReconfigRemoveClient, ReconfigTransferClient

# The coordinator is fed from the node's apply thread (on_commit /
# on_checkpoint) and queried from connection threads (state_doc,
# gated_client); all phase state moves under the coordinator lock
# (docs/STATIC_ANALYSIS.md lock-discipline pass).
MIRLINT_SHARED_STATE = {
    "ReshardCoordinator.phase": "_lock",
    "ReshardCoordinator.plan": "_lock",
    "ReshardCoordinator.marker_seq": "_lock",
    "ReshardCoordinator.cutover_seq": "_lock",
    "ReshardCoordinator._emitted": "_lock",
    "ReshardCoordinator._marker_t": "_lock",
    "ReshardCoordinator._committed_up_to": "_lock",
}

# Reserved client id for cutover markers, seeded into every group's
# genesis client set so a marker can be ordered in any group.  Bit 30
# set keeps it far above every harness-assigned client id (small
# integers found by residue search, well below 2**20) while still
# fitting the native ack plane's packed int32 client-id field
# (_native/ackplane.cpp pack_acks).
RESHARD_CONTROL_CLIENT = (1 << 30) | 0x5E5

# Coordinator phases (the ``reshard_state`` gauge).
IDLE = 0
STAGED = 1  # plan staged; waiting for the marker to commit
CUTTING = 2  # marker committed, map installed; reconfiguration in flight
DONE = 3  # reconfiguration applied; client set reflects the plan

PHASE_NAMES = {IDLE: "idle", STAGED: "staged", CUTTING: "cutting", DONE: "done"}

# Plan actions.
ACTION_SPLIT = "split"  # parent sheds the moved client to a new child
ACTION_MERGE_DRAIN = "merge_drain"  # child sheds the moved client back
ACTION_MERGE_COMMIT = "merge_commit"  # parent re-admits it at a watermark


@dataclass(frozen=True, slots=True)
class ReshardPlan:
    """One staged reshard step for one group; JSON wire form rides in
    RESHARD_PLAN subframes and persists to ``reshard-plan.json``.

    ``map_doc`` is the *post-cutover* map as a versioned
    :meth:`GroupMap.to_json_bytes` document; ``marker_req_no`` names the
    control-client request whose commit triggers the cutover;
    ``low_watermark`` (``merge_commit`` only) is one past the highest
    request number the draining group committed for ``moved_client``.
    """

    plan_id: str
    action: str
    group_id: int
    moved_client: int
    moved_client_width: int
    map_doc: dict
    marker_req_no: int
    low_watermark: int = 0
    lag_bound: int = 64

    def __post_init__(self):
        if self.action not in (
            ACTION_SPLIT, ACTION_MERGE_DRAIN, ACTION_MERGE_COMMIT,
        ):
            raise ValueError(f"unknown reshard action {self.action!r}")

    def to_json_bytes(self) -> bytes:
        return json.dumps(asdict(self), sort_keys=True).encode()

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "ReshardPlan":
        doc = json.loads(data.decode())
        return cls(
            plan_id=str(doc["plan_id"]),
            action=str(doc["action"]),
            group_id=int(doc["group_id"]),
            moved_client=int(doc["moved_client"]),
            moved_client_width=int(doc["moved_client_width"]),
            map_doc=dict(doc["map_doc"]),
            marker_req_no=int(doc["marker_req_no"]),
            low_watermark=int(doc.get("low_watermark", 0)),
            lag_bound=int(doc.get("lag_bound", 64)),
        )

    def reconfiguration(self):
        """The pending reconfiguration this plan emits at its first
        post-marker checkpoint."""
        if self.action == ACTION_MERGE_COMMIT:
            return ReconfigTransferClient(
                id=self.moved_client,
                width=self.moved_client_width,
                low_watermark=self.low_watermark,
            )
        return ReconfigRemoveClient(id=self.moved_client)

    def map_version(self) -> int:
        return int(self.map_doc.get("map_version", 0))


class ReshardCoordinator:
    """Per-node reshard state machine, driven by the commit-log app.

    Thread model: ``stage`` runs on a transport reader thread while
    ``on_commit``/``on_checkpoint`` run on the app thread — every phase
    mutation happens under the coordinator lock.  ``on_cutover`` (the
    instance's map-install hook) is invoked outside the lock.
    """

    def __init__(
        self,
        group_id: int,
        initial_map_version: int = 0,
        registry=None,
        state_path: Optional[Path] = None,
        on_cutover: Optional[Callable[[bytes, int, int], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        reg = registry if registry is not None else metrics_mod.default_registry
        labels = {"group": str(group_id)}
        self.group_id = group_id
        self.on_cutover = on_cutover
        self._clock = clock
        self._state_path = state_path
        self._lock = threading.Lock()
        self.phase = IDLE
        self.plan: Optional[ReshardPlan] = None
        self.marker_seq: Optional[int] = None
        self.cutover_seq: Optional[int] = None
        self._emitted = False
        self._marker_t: Optional[float] = None
        # Highest committed req_no per client — the commit gate the
        # instance consults before acking the moved client while a plan
        # is in flight (exactly-once across the cutover: an ack must
        # imply commit, or the reconfiguration could drop the request).
        self._committed_up_to: Dict[int, int] = {}
        self._g_state = reg.gauge("reshard_state", labels=labels)
        self._g_version = reg.gauge("map_version", labels=labels)
        self._g_cutover_s = reg.gauge(
            "reshard_cutover_seconds", labels=labels
        )
        self._g_state.set(IDLE)
        self._g_version.set(initial_map_version)
        if state_path is not None and state_path.exists():
            self._restore(state_path)

    # --- persistence (best-effort crash tolerance) ---

    def _persist(self) -> None:
        # Always entered with the coordinator lock held (stage /
        # on_commit / on_checkpoint); the Lock is not reentrant.
        if self._state_path is None:
            return
        doc = {
            "phase": self.phase,  # mirlint: allow(lock-discipline)
            "plan": json.loads(self.plan.to_json_bytes()) if self.plan else None,  # mirlint: allow(lock-discipline)
            "marker_seq": self.marker_seq,  # mirlint: allow(lock-discipline)
            "cutover_seq": self.cutover_seq,  # mirlint: allow(lock-discipline)
            "emitted": self._emitted,  # mirlint: allow(lock-discipline)
        }
        tmp = self._state_path.with_suffix(".tmp")
        try:
            tmp.write_text(json.dumps(doc, sort_keys=True))
            tmp.replace(self._state_path)
        except OSError:
            pass  # diagnostics only; consensus state is in the log

    def _restore(self, path: Path) -> None:
        # Runs from __init__ only, before any other thread can hold a
        # reference to this coordinator.
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            return
        if doc.get("plan"):  # mirlint: allow(lock-discipline)
            self.plan = ReshardPlan.from_json_bytes(  # mirlint: allow(lock-discipline)
                json.dumps(doc["plan"]).encode()
            )
            self.phase = int(doc.get("phase", STAGED))  # mirlint: allow(lock-discipline)
            self.marker_seq = doc.get("marker_seq")  # mirlint: allow(lock-discipline)
            self.cutover_seq = doc.get("cutover_seq")  # mirlint: allow(lock-discipline)
            self._emitted = bool(doc.get("emitted"))  # mirlint: allow(lock-discipline)
            self._g_state.set(self.phase)  # mirlint: allow(lock-discipline)
            if self.phase >= CUTTING and self.plan is not None:  # mirlint: allow(lock-discipline)
                self._g_version.set(self.plan.map_version())  # mirlint: allow(lock-discipline)

    # --- harness surface ---

    def stage(self, plan: ReshardPlan) -> None:
        """Stage a plan ahead of its marker.  Idempotent per plan_id;
        re-staging a different plan while one is in flight raises."""
        with self._lock:
            if self.plan is not None and self.phase in (STAGED, CUTTING):
                if self.plan.plan_id == plan.plan_id:
                    return
                raise RuntimeError(
                    f"reshard plan {self.plan.plan_id!r} already in flight"
                )
            self.plan = plan
            self.phase = STAGED
            self.marker_seq = None
            self.cutover_seq = None
            self._emitted = False
            self._marker_t = None
            self._g_state.set(STAGED)
            self._persist()

    def state_doc(self) -> dict:
        with self._lock:
            return {
                "group": self.group_id,
                "phase": self.phase,
                "phase_name": PHASE_NAMES[self.phase],
                "plan_id": self.plan.plan_id if self.plan else None,
                "action": self.plan.action if self.plan else None,
                "map_version": (
                    self.plan.map_version()
                    if self.plan and self.phase >= CUTTING
                    else None
                ),
                "marker_seq": self.marker_seq,
                "cutover_seq": self.cutover_seq,
            }

    # --- ack gate (exactly-once across the cutover) ---

    def gated_client(self) -> Optional[int]:
        """The client whose acks must be commit-gated right now, if any."""
        with self._lock:
            if self.plan is not None and self.phase in (STAGED, CUTTING):
                return self.plan.moved_client
            return None

    def committed_up_to(self, client_id: int) -> int:
        with self._lock:
            return self._committed_up_to.get(client_id, -1)

    # --- app-thread hooks ---

    def on_commit(self, seq: int, requests) -> None:
        """Called per applied batch with its RequestAcks.  Detects the
        staged marker; on match, flips to CUTTING and installs the new
        map via ``on_cutover`` (outside the lock)."""
        fire = None
        with self._lock:
            for r in requests:
                prev = self._committed_up_to.get(r.client_id, -1)
                if r.req_no > prev:
                    self._committed_up_to[r.client_id] = r.req_no
            if (
                self.phase == STAGED
                and self.plan is not None
                and any(
                    r.client_id == RESHARD_CONTROL_CLIENT
                    and r.req_no == self.plan.marker_req_no
                    for r in requests
                )
            ):
                self.phase = CUTTING
                self.marker_seq = seq
                self._marker_t = self._clock()
                self._g_state.set(CUTTING)
                self._g_version.set(self.plan.map_version())
                fire = (
                    json.dumps(self.plan.map_doc, sort_keys=True).encode(),
                    self.plan.map_version(),
                    seq,
                )
                self._persist()
        if fire is not None and self.on_cutover is not None:
            self.on_cutover(*fire)

    def on_checkpoint(self, client_states, seq: int) -> Tuple:
        """Called from the app's ``snap``.  Returns the pending
        reconfigurations to ride in this checkpoint (emitted exactly
        once, at the first checkpoint after the marker), and detects
        completion on later checkpoints from the client set itself."""
        with self._lock:
            if self.phase != CUTTING or self.plan is None:
                return ()
            if not self._emitted:
                self._emitted = True
                self._persist()
                return (self.plan.reconfiguration(),)
            ids = {c.id for c in client_states}
            moved = self.plan.moved_client
            applied = (
                moved in ids
                if self.plan.action == ACTION_MERGE_COMMIT
                else moved not in ids
            )
            if applied:
                self.phase = DONE
                self.cutover_seq = seq
                self._g_state.set(DONE)
                if self._marker_t is not None:
                    self._g_cutover_s.set(self._clock() - self._marker_t)
                self._persist()
            return ()


# --------------------------------------------------------------------------
# Commit-log analysis helpers (harness + mircat side).
#
# A commit line is ``<seq> <digest-hex> <client:req,...>`` — the
# commits.log / ship-feed format (tools/mirnet.py _CommitLogApp).
# --------------------------------------------------------------------------


def parse_commit_line(line: str) -> Tuple[int, List[Tuple[int, int]]]:
    """``(seq, [(client_id, req_no), ...])``; tolerant of empty batches."""
    parts = line.split()
    seq = int(parts[0])
    reqs: List[Tuple[int, int]] = []
    if len(parts) > 2 and parts[2]:
        for item in parts[2].split(","):
            cid, _, rno = item.partition(":")
            reqs.append((int(cid), int(rno)))
    return seq, reqs


def committed_requests_of(lines, client_id: int) -> Set[int]:
    """Every req_no committed for ``client_id`` across ``lines``."""
    out: Set[int] = set()
    for line in lines:
        for cid, rno in parse_commit_line(line)[1]:
            if cid == client_id:
                out.add(rno)
    return out


def low_watermark_after(lines, client_id: int) -> int:
    """One past the highest committed req_no for ``client_id`` — the
    watermark a receiving group seeds the transferred client at."""
    reqs = committed_requests_of(lines, client_id)
    return (max(reqs) + 1) if reqs else 0


def backlog_lines(lines, client_id: int) -> List[str]:
    """The commit lines that carry requests of ``client_id`` — the slice
    of the parent's history a split child replays as its half of the
    backlog."""
    out: List[str] = []
    for line in lines:
        if any(cid == client_id for cid, _ in parse_commit_line(line)[1]):
            out.append(line)
    return out


def marker_seq_in(lines, marker_req_no: int) -> Optional[int]:
    """Sequence number of the cutover marker batch in ``lines``."""
    for line in lines:
        for cid, rno in parse_commit_line(line)[1]:
            if cid == RESHARD_CONTROL_CLIENT and rno == marker_req_no:
                return parse_commit_line(line)[0]
    return None
