"""Protocol health plane: anomaly detection over snapshots and events.

The reference has no health subsystem — its observability ends at the
status snapshot and the replayable event log.  PR 1 added *measurement*
(metrics, spans, Prometheus); this layer adds *judgment*: detectors that
watch those signals and say what is wrong, which peer caused it, and when
it started.  Mir's deterministic event/action architecture makes every
liveness or safety anomaly mechanically detectable from state the tree
already exposes, so the monitor is a pure consumer — it never touches the
state machine, only ``status.snapshot()`` views and the event stream.

Detector suite (thresholds in :class:`HealthThresholds`, documented in
docs/OBSERVABILITY.md):

- **watermark_stall** — commit progress (watermark movement, client-window
  movement, and commits observed on the event stream, null batches
  included) stops for N consecutive observations while work is pending
  (allocated-uncommitted client requests, live suspicions, or undecided
  checkpoints).
- **epoch_thrash** — repeated view changes without an intervening commit
  (the cascade shape of BASELINE config 4, flagged as it happens).
- **checkpoint_stagnation** — a checkpoint this node decided locally that
  cannot reach a network quorum.
- **client_starvation** — one client's window stops advancing while it
  still holds allocated-uncommitted requests.
- **msg_buffer_growth** — monotonic message-buffer growth above a floor
  (a backpressure leak: something buffers faster than it drains).
- **peer_fault** — the per-peer fault ledger: ingress rejections, invalid
  digests, and suspicion votes attributed to the offending node id
  (suspicions attribute to the suspected epoch's primary,
  ``epoch % num_nodes`` — epoch_tracker.py:288).
- **checkpoint_divergence** — :class:`DivergenceDetector`, the testengine
  safety tripwire: cross-replica checkpoint fingerprints compared each
  interval; any same-seq mismatch flags the minority replica(s).

Every detection emits one structured :class:`Anomaly` through three
channels: the logger (``warn``), the tracer (an ``anomaly`` instant
event), and the metrics registry (``anomalies_total{kind}``,
``peer_faults_total{peer,kind}``, ``health_status``).  Consumers:
``Node.health()`` (runtime scrape surface), the testengine recorder
(``Recorder.health``), ``bench.py`` (BENCH_HEALTH.json), and
``mircat --doctor`` (offline analysis of any recorded event log).
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as metrics_mod
from . import state as st
from . import tracing
from .messages import CEntry, Suspect

# Anomaly kinds (the `kind` label of anomalies_total; linted snake_case +
# documented by tools/check_metric_names.py).
ANOMALY_KINDS = (
    "watermark_stall",
    "epoch_thrash",
    "checkpoint_stagnation",
    "client_starvation",
    "msg_buffer_growth",
    "peer_fault",
    "checkpoint_divergence",
)

# Per-peer fault kinds (the `kind` label of peer_faults_total; same lint).
FAULT_KINDS = (
    "ingress_reject",
    "invalid_digest",
    "suspicion_vote",
    "peer_unreachable",
)


@dataclass(frozen=True)
class Anomaly:
    """One detected protocol anomaly (JSON-ready via ``as_dict``)."""

    kind: str  # one of ANOMALY_KINDS
    node_id: int  # the node observing (or, for divergence, deviating)
    time: float  # clock value at detection (sim units or seconds)
    since: float  # clock value when the condition started
    peer: Optional[int] = None  # offending node id, when attributable
    detail: Dict[str, object] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, object]:
        return asdict(self)

    def describe(self) -> str:
        peer = f" peer={self.peer}" if self.peer is not None else ""
        extra = "".join(f" {k}={v}" for k, v in sorted(self.detail.items()))
        return (
            f"[{self.kind}] node={self.node_id}{peer} "
            f"since={self.since:g} at={self.time:g}{extra}"
        )


@dataclass
class HealthThresholds:
    """Detector thresholds, in consecutive *observations* (one observation
    per health tick / snapshot interval).  Defaults are sized so clean runs
    never trip them (the false-positive guard in tests/test_health.py) but
    a silenced-leader partition does within its suspect window."""

    # Observations with no commit progress AND pending work.
    stall_observations: int = 6
    # Epoch increments without intervening commit progress.
    thrash_epoch_increments: int = 3
    # Observations a locally-decided checkpoint may lack a net quorum.
    checkpoint_stalled_observations: int = 6
    # Observations one client's window may sit still with allocated reqs.
    starvation_observations: int = 8
    # Consecutive observations of strictly-growing buffered bytes...
    buffer_growth_observations: int = 5
    # ...counted only above this floor (small transients are normal).
    buffer_growth_floor_bytes: int = 256 * 1024

    def as_dict(self) -> Dict[str, int]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "HealthThresholds":
        """Build from a JSON dict, ignoring unknown keys — the shape
        ``tools/mirnet.py`` ships in ``cluster.json`` so wire deployments
        (one observation per 20 ms tick, not per sim event) can scale the
        observation counts, and the offline doctor can judge the recorded
        run by the very thresholds the live run used."""
        known = {f.name for f in fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in known})


@dataclass
class HealthConfig:
    """Testengine attachment knobs (``Recorder.health``): how often, in sim
    units, snapshots are observed and cross-replica fingerprints compared.
    Both default to the tick interval — one observation per node tick."""

    thresholds: HealthThresholds = field(default_factory=HealthThresholds)
    divergence_check_interval: int = 500


class HealthMonitor:
    """Per-node detector suite over periodic status snapshots plus the
    event stream.  Thread-safety: the node runtime observes snapshots on
    the coordinator thread and events on the result worker, so emission
    and the fault ledger are lock-protected; detector state is only
    touched by ``observe_snapshot`` (single caller in every wiring)."""

    def __init__(
        self,
        node_id: int,
        *,
        registry: Optional[metrics_mod.Registry] = None,
        tracer: Optional[tracing.Tracer] = None,
        logger=None,
        clock: Optional[Callable[[], float]] = None,
        thresholds: Optional[HealthThresholds] = None,
        num_nodes: Optional[int] = None,
    ):
        self.node_id = node_id
        self.registry = (
            registry if registry is not None else metrics_mod.default_registry
        )
        self.tracer = tracer if tracer is not None else tracing.default_tracer
        self.logger = logger
        self.clock = clock if clock is not None else time.monotonic
        self.thresholds = thresholds if thresholds is not None else HealthThresholds()
        # Learned from the event stream (checkpoint/WAL network states) when
        # not provided; needed to attribute suspicions to the epoch primary.
        self.num_nodes = num_nodes

        self.anomalies: List[Anomaly] = []
        # (peer, fault_kind) -> count; every fault increments
        # peer_faults_total{peer,kind}, the first per key emits an Anomaly.
        self.faults: Dict[Tuple[int, str], int] = {}
        # Closed stall windows [(since, until, low_watermark), ...]; an open
        # window is (self._stall_since, None, low) until recovery.
        self.stall_windows: List[Tuple[float, Optional[float], int]] = []
        self.observations = 0
        # Monitor state is written by the node's processing loop and read
        # by snapshot(); the mutating entry points each take the lock,
        # while plain-counter reads tolerate staleness by design.
        # mirlint: allow(lock-map)
        self._lock = threading.Lock()

        # Commit progress, fed from the event stream (``ActionCommit`` in
        # ``observe_events``).  The status snapshot alone is too coarse: the
        # low watermark and client windows only move per checkpoint
        # interval, so a healthy fill phase would read as a stall.
        self._commits_seen = 0
        self._client_commits: Dict[int, int] = {}
        # watermark-stall state
        self._last_commit_sig: Optional[tuple] = None
        self._last_activity_sig: Optional[tuple] = None
        self._last_low: Optional[int] = None
        self._stall_count = 0
        self._stall_since: Optional[float] = None
        self._stall_flagged = False
        # epoch-thrash state
        self._last_epoch: Optional[int] = None
        self._thrash_increments = 0
        self._thrash_since: Optional[float] = None
        self._thrash_flagged = False
        # checkpoint-stagnation state: seq_no -> (count, since)
        self._cp_stalled: Dict[int, Tuple[int, float]] = {}
        self._cp_flagged: set = set()
        # client-starvation state: client_id -> (commit_sig, count, since)
        self._client_state: Dict[int, Tuple[tuple, int, float]] = {}
        self._client_flagged: set = set()
        # buffer-growth state
        self._last_buffer_bytes = 0
        self._growth_count = 0
        self._growth_since: Optional[float] = None
        self._growth_flagged = False
        # Flight-recorder auto-capture (docs/OBSERVABILITY.md "Flight
        # recorder"): deployments bind an eventlog.incident.AnomalyCapture
        # here; every emitted anomaly is offered for incident bundling.
        # Best-effort by contract — a capture failure never reaches the
        # detection path.
        self.capture_hook: Optional[Callable[[Anomaly], None]] = None

    def configure(
        self,
        thresholds: Optional[HealthThresholds] = None,
        num_nodes: Optional[int] = None,
    ) -> None:
        """Late-bind thresholds/num_nodes on an already-constructed monitor
        (``Node`` builds its monitor with defaults; ``tools/mirnet.py``
        reconfigures it from ``cluster.json`` before processing starts)."""
        if thresholds is not None:
            self.thresholds = thresholds
        if num_nodes is not None:
            self.num_nodes = num_nodes

    # --- emission (all three channels) ---

    def _emit(self, anomaly: Anomaly) -> None:
        with self._lock:
            self.anomalies.append(anomaly)
        self.registry.counter(
            "anomalies_total", labels={"kind": anomaly.kind}
        ).inc()
        self.tracer.instant(
            "anomaly",
            pid=anomaly.node_id,
            ts=anomaly.time,
            args=anomaly.as_dict(),
        )
        if self.logger is not None:
            self.logger.warn(
                "health anomaly",
                kind=anomaly.kind,
                node=anomaly.node_id,
                peer=anomaly.peer,
                since=anomaly.since,
                **{k: v for k, v in anomaly.detail.items()},
            )
        if self.capture_hook is not None:
            try:
                self.capture_hook(anomaly)
            except Exception:
                pass  # capture is evidence, never a failure mode

    def _set_status_gauge(self) -> None:
        self.registry.gauge(
            "health_status", labels={"node": str(self.node_id)}
        ).set(1.0 if self.anomalies else 0.0)

    # --- per-peer fault ledger ---

    def record_fault(
        self, peer: int, kind: str, now: Optional[float] = None, **detail
    ) -> None:
        """Attribute one fault to ``peer``.  Every fault counts in
        ``peer_faults_total{peer,kind}``; the first per (peer, kind) also
        emits a ``peer_fault`` anomaly (so clean runs stay anomaly-free and
        a misbehaving peer surfaces exactly once per misbehavior class)."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        now = self.clock() if now is None else now
        with self._lock:
            key = (peer, kind)
            count = self.faults.get(key, 0) + 1
            self.faults[key] = count
        self.registry.counter(
            "peer_faults_total", labels={"peer": str(peer), "kind": kind}
        ).inc()
        if count == 1:
            self._emit(
                Anomaly(
                    kind="peer_fault",
                    node_id=self.node_id,
                    time=now,
                    since=now,
                    peer=peer,
                    detail={"fault": kind, **detail},
                )
            )
        self._set_status_gauge()

    # --- event-stream detectors ---

    def observe_events(self, events, actions=None) -> None:
        """Fold one processed event batch: counts commits as progress for
        the snapshot detectors, learns the node count from network states
        in the stream, and feeds the fault ledger (suspicion votes,
        mismatched forwarded-batch digests)."""
        if actions is not None:
            for action in actions:
                if isinstance(action, st.ActionCommit):
                    # Null batches count too: the protocol making *any*
                    # forward progress (including heartbeat fill toward the
                    # next checkpoint) is not stalled.
                    self._commits_seen += 1
                    for ack in action.batch.requests:
                        self._client_commits[ack.client_id] = (
                            self._client_commits.get(ack.client_id, 0) + 1
                        )
        for event in events:
            t = event.__class__
            if t is st.EventStep:
                msg = event.msg
                if isinstance(msg, Suspect):
                    # A suspicion targets the suspected epoch's primary
                    # (number % num_nodes); without a learned node count the
                    # vote cannot be attributed and is skipped.
                    if self.num_nodes:
                        self.record_fault(
                            msg.epoch % self.num_nodes,
                            "suspicion_vote",
                            voter=event.source,
                            epoch=msg.epoch,
                        )
            elif t is st.EventHashResult:
                origin = event.origin
                if (
                    isinstance(origin, st.VerifyBatchOrigin)
                    and origin.expected_digest != event.digest
                ):
                    # A fetched batch whose content does not hash to the
                    # advertised digest: a byzantine forwarder.
                    self.record_fault(
                        origin.source, "invalid_digest", seq_no=origin.seq_no
                    )
            elif t is st.EventCheckpointResult or (
                t is st.EventStateTransferComplete
            ):
                self.num_nodes = len(event.network_state.config.nodes)
            elif t is st.EventLoadPersistedEntry:
                if isinstance(event.entry, CEntry):
                    self.num_nodes = len(event.entry.network_state.config.nodes)

    # --- snapshot detectors ---

    @staticmethod
    def _has_pending_work(snap) -> bool:
        """Evidence the watermark *should* be moving: allocated-uncommitted
        client requests, live suspicions, or undecided local checkpoints.
        Gates the stall detector so a quiescent node (everything committed,
        nothing submitted) is healthy, not stalled."""
        for cw in snap.client_windows:
            if 1 in cw.allocated:
                return True
        if snap.epoch_tracker.active_epoch.suspicions:
            return True
        for cp in snap.checkpoints:
            if cp.seq_no < snap.low_watermark:
                continue  # obsolete (the genesis entry never quorums)
            if cp.local_decision and not cp.net_quorum:
                return True
        return False

    def _commit_sig(self, snap) -> tuple:
        """Commit-progress fingerprint: watermark movement, commits seen on
        the event stream (null batches included), and client-window
        movement.  Resets the epoch-thrash streak and gates starvation —
        deliberately excludes three-phase activity, which churns during a
        view-change cascade without anything committing."""
        return (
            snap.low_watermark,
            self._commits_seen,
            tuple(
                (
                    cw.client_id,
                    cw.low_watermark,
                    sum(1 for a in cw.allocated if a == 2),
                )
                for cw in snap.client_windows
            ),
        )

    def _activity_sig(self, snap) -> tuple:
        """Protocol-activity fingerprint: commit progress plus three-phase
        sequence state transitions.  The stall detector resets on this —
        commits are too coarse during a healthy fill phase (the first
        commit can land several ticks after proposals start), but under a
        real partition every component freezes together."""
        return (
            self._commit_sig(snap),
            tuple(tuple(b.sequences) for b in snap.buckets),
        )

    def observe_snapshot(self, snap, now: Optional[float] = None) -> None:
        """Run the periodic detectors over one ``status.snapshot()`` view."""
        now = self.clock() if now is None else now
        self.observations += 1
        th = self.thresholds
        low = snap.low_watermark
        epoch = snap.epoch_tracker.active_epoch.number

        # -- watermark stall --
        activity_sig = self._activity_sig(snap)
        commit_sig = activity_sig[0]
        # Any protocol activity clears a stall; only commits clear a thrash
        # streak or count as the progress starvation is measured against.
        active = (
            self._last_activity_sig is not None
            and activity_sig != self._last_activity_sig
        )
        advanced = (
            self._last_commit_sig is not None
            and commit_sig != self._last_commit_sig
        )
        if active or self._last_activity_sig is None:
            if self._stall_since is not None:
                # Close the open stall window on recovery.
                self.stall_windows.append(
                    (self._stall_since, now, self._last_low)
                )
                if self.logger is not None and self._stall_flagged:
                    self.logger.info(
                        "watermark stall recovered",
                        node=self.node_id,
                        low_watermark=low,
                    )
            self._stall_count = 0
            self._stall_since = None
            self._stall_flagged = False
        elif self._has_pending_work(snap):
            if self._stall_since is None:
                self._stall_since = now
            self._stall_count += 1
            if self._stall_count >= th.stall_observations and (
                not self._stall_flagged
            ):
                self._stall_flagged = True
                self._emit(
                    Anomaly(
                        kind="watermark_stall",
                        node_id=self.node_id,
                        time=now,
                        since=self._stall_since,
                        detail={
                            "low_watermark": low,
                            "observations": self._stall_count,
                        },
                    )
                )
        self._last_activity_sig = activity_sig
        self._last_commit_sig = commit_sig
        self._last_low = low

        # -- epoch thrash --
        if self._last_epoch is not None and epoch > self._last_epoch:
            if advanced:
                self._thrash_increments = 1
                self._thrash_since = now
                self._thrash_flagged = False
            else:
                if self._thrash_increments == 0:
                    self._thrash_since = now
                self._thrash_increments += epoch - self._last_epoch
            if (
                self._thrash_increments >= th.thrash_epoch_increments
                and not self._thrash_flagged
            ):
                self._thrash_flagged = True
                self._emit(
                    Anomaly(
                        kind="epoch_thrash",
                        node_id=self.node_id,
                        time=now,
                        since=self._thrash_since or now,
                        detail={
                            "epoch": epoch,
                            "view_changes_without_commit": (
                                self._thrash_increments
                            ),
                        },
                    )
                )
        elif advanced:
            self._thrash_increments = 0
            self._thrash_flagged = False
        self._last_epoch = epoch

        # -- checkpoint-quorum stagnation --
        live = set()
        for cp in snap.checkpoints:
            if cp.seq_no < low:
                # Obsolete entry (notably the genesis checkpoint at seq 0,
                # which lingers in the map without ever reaching a network
                # quorum) — not a liveness signal.
                continue
            if cp.local_decision and not cp.net_quorum:
                live.add(cp.seq_no)
                count, since = self._cp_stalled.get(cp.seq_no, (0, now))
                count += 1
                self._cp_stalled[cp.seq_no] = (count, since)
                if count >= th.checkpoint_stalled_observations and (
                    cp.seq_no not in self._cp_flagged
                ):
                    self._cp_flagged.add(cp.seq_no)
                    self._emit(
                        Anomaly(
                            kind="checkpoint_stagnation",
                            node_id=self.node_id,
                            time=now,
                            since=since,
                            detail={
                                "seq_no": cp.seq_no,
                                "max_agreements": cp.max_agreements,
                            },
                        )
                    )
        for seq_no in list(self._cp_stalled):
            if seq_no not in live:
                del self._cp_stalled[seq_no]
                self._cp_flagged.discard(seq_no)

        # -- client-window starvation --
        seen = set()
        for cw in snap.client_windows:
            seen.add(cw.client_id)
            starving = 1 in cw.allocated
            # Per-client progress: the window advancing OR this client's
            # requests committing both reset the counter.
            cw_sig = (
                cw.low_watermark,
                sum(1 for a in cw.allocated if a == 2),
                self._client_commits.get(cw.client_id, 0),
            )
            last_sig, count, since = self._client_state.get(
                cw.client_id, (cw_sig, 0, now)
            )
            if cw_sig != last_sig or not starving:
                count = 0
                since = now
                self._client_flagged.discard(cw.client_id)
            elif advanced:
                # Starvation is relative: it only accrues while the rest of
                # the system makes progress this client is excluded from.
                # A global freeze is a stall, not starvation.
                count += 1
                if count >= th.starvation_observations and (
                    cw.client_id not in self._client_flagged
                ):
                    self._client_flagged.add(cw.client_id)
                    self._emit(
                        Anomaly(
                            kind="client_starvation",
                            node_id=self.node_id,
                            time=now,
                            since=since,
                            detail={
                                "client_id": cw.client_id,
                                "client_low_watermark": cw.low_watermark,
                            },
                        )
                    )
            self._client_state[cw.client_id] = (cw_sig, count, since)
        for client_id in list(self._client_state):
            if client_id not in seen:
                del self._client_state[client_id]
                self._client_flagged.discard(client_id)

        # -- message-buffer growth --
        total = sum(nb.size for nb in snap.node_buffers)
        if (
            total > self._last_buffer_bytes
            and total >= th.buffer_growth_floor_bytes
        ):
            if self._growth_count == 0:
                self._growth_since = now
            self._growth_count += 1
            if self._growth_count >= th.buffer_growth_observations and (
                not self._growth_flagged
            ):
                self._growth_flagged = True
                self._emit(
                    Anomaly(
                        kind="msg_buffer_growth",
                        node_id=self.node_id,
                        time=now,
                        since=self._growth_since or now,
                        detail={"buffered_bytes": total},
                    )
                )
        elif total <= self._last_buffer_bytes:
            self._growth_count = 0
            self._growth_flagged = False
        self._last_buffer_bytes = total

        self._set_status_gauge()

    # --- report surface ---

    def report(self) -> Dict[str, object]:
        """JSON-ready health report (``Node.health()``, BENCH_HEALTH.json,
        ``mircat --doctor``)."""
        with self._lock:
            anomalies = [a.as_dict() for a in self.anomalies]
            faults = {
                f"{peer}:{kind}": count
                for (peer, kind), count in sorted(self.faults.items())
            }
        windows = list(self.stall_windows)
        if self._stall_since is not None:
            windows.append((self._stall_since, None, self._last_low))
        return {
            "node_id": self.node_id,
            "healthy": not anomalies,
            "observations": self.observations,
            "anomaly_count": len(anomalies),
            "anomalies": anomalies,
            "peer_faults": faults,
            "stall_windows": [
                {"since": since, "until": until, "low_watermark": low}
                for since, until, low in windows
            ],
        }


class DivergenceDetector:
    """Cross-replica checkpoint-fingerprint comparison — the testengine
    safety tripwire.  Each interval the recorder feeds every simulated
    node's app-level ``(checkpoint_seq_no, checkpoint_hash)``; replicas at
    the same seq_no must report the same hash, and any mismatch flags the
    minority holder(s) as diverged.  One anomaly per (seq_no, node)."""

    def __init__(
        self,
        *,
        registry: Optional[metrics_mod.Registry] = None,
        tracer: Optional[tracing.Tracer] = None,
        logger=None,
    ):
        self.registry = (
            registry if registry is not None else metrics_mod.default_registry
        )
        self.tracer = tracer if tracer is not None else tracing.default_tracer
        self.logger = logger
        self.anomalies: List[Anomaly] = []
        self.checks = 0
        self._flagged: set = set()  # (seq_no, node_id)

    def observe(
        self, fingerprints: Dict[int, Tuple[int, bytes]], now: float
    ) -> List[Anomaly]:
        """``fingerprints``: node_id -> (checkpoint_seq_no, checkpoint_hash).
        Returns the anomalies newly emitted by this sweep."""
        self.checks += 1
        by_seq: Dict[int, Dict[bytes, List[int]]] = {}
        for node_id, (seq_no, value) in fingerprints.items():
            by_seq.setdefault(seq_no, {}).setdefault(value, []).append(node_id)
        fresh: List[Anomaly] = []
        for seq_no, values in by_seq.items():
            if len(values) <= 1:
                continue
            majority = max(len(nodes) for nodes in values.values())
            tied = sum(
                1 for nodes in values.values() if len(nodes) == majority
            ) > 1
            for value, nodes in sorted(values.items()):
                if len(nodes) == majority and majority > 1 and not tied:
                    continue  # the agreeing side is not the deviant
                for node_id in nodes:
                    key = (seq_no, node_id)
                    if key in self._flagged:
                        continue
                    self._flagged.add(key)
                    anomaly = Anomaly(
                        kind="checkpoint_divergence",
                        node_id=node_id,
                        time=now,
                        since=now,
                        detail={
                            "seq_no": seq_no,
                            "value": value.hex()[:16],
                            "disagreeing_nodes": sorted(
                                n
                                for ns in values.values()
                                for n in ns
                                if n != node_id
                            ),
                        },
                    )
                    self.anomalies.append(anomaly)
                    fresh.append(anomaly)
                    self.registry.counter(
                        "anomalies_total",
                        labels={"kind": "checkpoint_divergence"},
                    ).inc()
                    self.tracer.instant(
                        "anomaly", pid=node_id, ts=now, args=anomaly.as_dict()
                    )
                    if self.logger is not None:
                        self.logger.error(
                            "checkpoint divergence",
                            node=node_id,
                            seq_no=seq_no,
                        )
        return fresh
