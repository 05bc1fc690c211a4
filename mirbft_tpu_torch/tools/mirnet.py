"""mirnet: multi-process deployment harness over real localhost TCP.

One module, three roles:

* **Parent (default)** — reserves N ports, writes ``cluster.json``, spawns
  one OS process per node (``python -m mirbft_tpu_torch.tools.mirnet --node i``),
  submits client requests through a real socket client handle
  (:class:`SocketClient`, KIND_CLIENT frames), waits until a quorum of
  nodes has committed every request, then diffs the per-node commit logs
  for **bit-identical agreement** — same sequence numbers, same batch
  digests, byte for byte.  ``--kill-restart`` additionally SIGKILLs one
  node mid-run, verifies the survivors' ``net_reconnects_total`` moved
  (reconnect/backoff observed through Prometheus text, not logs), restarts
  the node from its durable WAL, and requires the cluster to keep
  committing.
* **Child (``--node i``)** — runs a full :class:`~mirbft_tpu_torch.node.Node`
  over :class:`~mirbft_tpu_torch.net.tcp.TcpTransport` with durable WAL +
  request store under ``<dir>/node-<i>/``, appends every applied batch to
  ``commits.log``, snapshots ``metrics.prom`` twice a second, and exits
  cleanly on SIGTERM.  When the cluster config asks for it, the child also
  wires a :class:`~mirbft_tpu_torch.net.faults.FaultInjector` into its transport
  (polling ``<dir>/faults.json`` for mid-run schedule changes), wraps its
  link in a :class:`~mirbft_tpu_torch.net.byzantine.ByzantineLink`, and records
  its event stream to ``events-<boot>.gz`` for the doctor.
* **Scenario (``--scenario name``)** — fault-injection choreography
  (docs/FAULTS.md): the parent drives partition/heal/flap/byzantine/kill
  scripts against a fully instrumented cluster, then judges the outcome
  with the deployment doctor (``mircat --doctor``): bit-identical
  agreement, anomaly budget, and injected-fault-to-attributed-fault
  accounting, written to ``scenario.json`` and the ``scenario_verdict``
  gauge.

* **Sharded parent (``--groups S``)** — S independent consensus groups
  behind the client-routing tier (docs/SHARDING.md): one full cluster per
  group under ``<dir>/group-<g>/``, a ``shard.json`` topology file, the
  route-aware :class:`~mirbft_tpu_torch.groups.routing.RoutedClient` driving
  traffic, and optional observer children
  (:func:`~mirbft_tpu_torch.groups.observer.Observer`) tailing each group.
  Layouts: **disjoint** (default, one process per (group, node) — clean
  per-group doctor attribution) and **cohost** (one process per host
  index runs that node of every group; any one client connection
  multiplexes submissions to all co-hosted groups).

The harness is also importable: tests and ``bench.py`` call
:func:`run_deployment`, :func:`run_sharded_deployment`, and
:func:`run_scenario` directly (see tests/test_mirnet.py and the
``net_loopback_4n_commit_s`` bench key).

Usage::

    python -m mirbft_tpu_torch.tools.mirnet --nodes 4 --reqs 20 --kill-restart
    python -m mirbft_tpu_torch.tools.mirnet --groups 2 --observers 1
    python -m mirbft_tpu_torch.tools.mirnet --scenario partition-minority
    python -m mirbft_tpu_torch.tools.mirnet --list-scenarios
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

# Client-frame payloads (8-byte big-endian req_no + opaque request body)
# and the 1-byte reply statuses are shared with the routing tier —
# mirbft_tpu_torch/groups/routing.py is the source of truth; the old local
# names stay as aliases for embedders and tests.
from mirbft_tpu_torch.groups.routing import (
    CLIENT_BUSY,
    CLIENT_OK,
    CLIENT_REDIRECT,
    GroupMap,
    RoutedClient,
    client_for_group,
    client_hash,
)
from mirbft_tpu_torch.groups.routing import CLIENT_REQ as _CLIENT_REQ
from mirbft_tpu_torch.groups.reshard import RESHARD_CONTROL_CLIENT

_METRICS_SNAPSHOT_S = 0.5
_PROPOSE_RETRY_S = 10.0
# How often a child re-reads faults.json for choreography changes.
_FAULT_POLL_S = 0.1

# Health thresholds for wire scenarios: the live tick period is 0.02s (one
# observation per tick), so the simulator-calibrated defaults (~6
# observations) would flag sub-200ms hiccups.  These scale the windows to
# ~3-4s of wall clock, which is noise-immune on a loaded CI host while
# still far below any real stall.
_WIRE_THRESHOLDS = {
    "stall_observations": 150,
    "checkpoint_stalled_observations": 150,
    "starvation_observations": 200,
    "buffer_growth_observations": 125,
}

# Default node config for steady-state scenarios: suspicion exists but is
# slow enough (200 ticks = 4s) that a healthy wire run never trips it.
_STEADY_CONFIG = {"suspect_ticks": 200}
# Scenarios that *want* a view change: suspect fast, but give the epoch
# change itself room to complete.
_VIEWCHANGE_CONFIG = {"suspect_ticks": 25, "new_epoch_timeout_ticks": 100}


def _cluster_path(root: Path) -> Path:
    return root / "cluster.json"


def _faults_path(root: Path) -> Path:
    return root / "faults.json"


def _node_dir(root: Path, node_id: int) -> Path:
    return root / f"node-{node_id}"


def _shard_path(root: Path) -> Path:
    return root / "shard.json"


def _group_dir(root: Path, group_id: int) -> Path:
    return root / f"group-{group_id}"


def _observer_dir(root: Path, group_id: int, obs_idx: int) -> Path:
    return _group_dir(root, group_id) / f"observer-{obs_idx}"


def _write_json_atomic(path: Path, obj: dict) -> None:
    """Readers (polling children) never see a torn file."""
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.replace(path)


def _write_cluster(
    root: Path,
    node_count: int,
    ports: List[int],
    client_ids: List[int],
    *,
    seed: int = 0,
    faults: bool = False,
    record_events: bool = True,
    thresholds: Optional[dict] = None,
    node_config: Optional[dict] = None,
    byzantine: Optional[dict] = None,
    unreachable_after_s: float = 5.0,
    pipeline: bool = True,
    group_id: Optional[int] = None,
    num_groups: int = 1,
    group_map: Optional[dict] = None,
    fleet: bool = False,
    client_watermarks: Optional[Dict[int, int]] = None,
) -> None:
    """``cluster.json``: everything a child needs to boot.  The fault
    plane keys are optional — plain deployments (``run_deployment``) leave
    them at their inert defaults.  The flight recorder is **on by
    default** (``record_events``, docs/OBSERVABILITY.md "Flight
    recorder"): every child journals its event stream to
    ``node-<i>/journal/`` with bounded retention; ``--no-flight-recorder``
    is the escape hatch.  The pipelined schedule is the default;
    ``pipeline=False`` (the ``--classic`` flag) selects the reference
    coordinator, and the active schedule is recorded under ``schedule``.
    Sharded deployments (docs/SHARDING.md) additionally record the node's
    ``group_id`` and the full serialized group map so children can answer
    MAP_REQUEST frames and redirect misrouted submissions without ever
    reaching outside their own group directory."""
    doc = {
        "node_count": node_count,
        "client_ids": client_ids,
        "ports": {str(i): ports[i] for i in range(node_count)},
        "seed": seed,
        "faults": faults,
        "record_events": record_events,
        "thresholds": thresholds,
        "node_config": node_config,
        "byzantine": {
            str(k): v for k, v in (byzantine or {}).items()
        },
        "unreachable_after_s": unreachable_after_s,
        "pipeline": pipeline,
        "schedule": "pipelined" if pipeline else "classic",
        # Fleet observability (docs/OBSERVABILITY.md "Fleet plane"):
        # children enable the process tracer and serve KIND_TELEMETRY
        # pulls; committed batches ship trace-id trailers to observers.
        "fleet": fleet,
    }
    if group_id is not None:
        doc["group_id"] = int(group_id)
        doc["num_groups"] = int(num_groups)
        doc["group_map"] = group_map or {}
        # Elastic resharding (docs/SHARDING.md): a group bootstrapped as
        # the receiving side of a client transfer seeds that client's
        # request window at one past what the previous owner committed,
        # so retried requests below the watermark dedup instead of
        # double-committing.
        doc["client_watermarks"] = {
            str(k): int(v) for k, v in (client_watermarks or {}).items()
        }
    _write_json_atomic(_cluster_path(root), doc)


def _load_fault_plan(root: Path, node_id: int):
    """``(version, FaultPlan)`` for one node from ``faults.json``;
    tolerant of a missing or half-written file (returns an inert plan)."""
    from mirbft_tpu_torch.net.faults import FaultPlan

    try:
        doc = json.loads(_faults_path(root).read_text())
        plan = doc.get("plans", {}).get(str(node_id), {})
        return int(doc.get("version", 0)), FaultPlan.from_dict(plan)
    except (OSError, ValueError):
        return -1, FaultPlan()


def _reserve_ports(count: int) -> List[int]:
    """Bind ``count`` ephemeral ports, record them, release them all at
    once right before the children start.  The tiny reuse race is
    acceptable on localhost (SO_REUSEADDR on both sides)."""
    socks, ports = [], []
    for _ in range(count):
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        socks.append(sock)
        ports.append(sock.getsockname()[1])
    for sock in socks:
        sock.close()
    return ports


# --------------------------------------------------------------------------
# Child role: one real node process
# --------------------------------------------------------------------------


class _CommitLogApp:
    """App that journals every applied batch to ``commits.log`` — one line
    per QEntry: ``<seq_no> <digest-hex> <client:req,...>``.  The file is
    the ground truth the parent diffs across nodes.

    With a ``snapstore``, checkpoint values are **digest-only**: ``snap``
    persists the snapshot body locally (storage.SnapshotStore) and the
    32-byte sha256 digest is what circulates in Checkpoint messages.  A
    ``transfer_to`` that misses locally — a restarted node asked to jump
    to a checkpoint it never produced — fetches the body from a peer over
    KIND_SNAPSHOT frames; a failed fetch raises, which the state machine
    turns into EventStateTransferFailed and a deterministic tick-backoff
    retry, so transient unavailability costs latency, never liveness.
    Without a snapstore the legacy inline format (digest ‖ body) is kept."""

    def __init__(
        self,
        log_path: Path,
        snapstore=None,
        peer_addrs=None,
        feed=None,
        checkpoint_log: Optional[Path] = None,
    ):
        self._file = open(log_path, "a", buffering=1)
        # Harness-side observation ledger; the append/record methods all
        # take the lock, and the summary readers run after the child
        # processes have exited.
        # mirlint: allow(lock-map)
        self._lock = threading.Lock()
        self.last_checkpoint = (0, b"")
        self.state_transfers: List[int] = []
        self.snapstore = snapstore
        self.peer_addrs = list(peer_addrs or [])
        # Sharded deployments attach a groups.ship.ShipFeed so committed
        # batches and checkpoints fan out to observers, plus a node-side
        # checkpoints.log (the bit-identity evidence observers diff
        # against).  App actions are processed serially, so _last_seq at
        # snap() time is exactly the checkpoint boundary sequence.
        self.feed = feed
        self._checkpoint_log = checkpoint_log
        self._last_seq = 0
        # Optional (client_id, req_no) -> trace id lookup (fleet mode):
        # shipped batches then carry the trace trailer observers strip
        # before journaling, which keeps commits.log byte-identical.
        self.trace_lookup = None
        # Optional groups.reshard.ReshardCoordinator: sees every applied
        # batch (marker detection) and injects pending reconfigurations
        # at checkpoint boundaries (docs/SHARDING.md).
        self.reshard = None

    def apply(self, entry) -> None:
        reqs = ",".join(f"{r.client_id}:{r.req_no}" for r in entry.requests)
        line = f"{entry.seq_no} {entry.digest.hex()} {reqs}"
        with self._lock:
            self._file.write(line + "\n")
            self._last_seq = entry.seq_no
        if self.reshard is not None:
            self.reshard.on_commit(entry.seq_no, entry.requests)
        if self.feed is not None:
            trace = None
            if self.trace_lookup is not None:
                trace = {}
                for r in entry.requests:
                    trace_id = self.trace_lookup(r.client_id, r.req_no)
                    if trace_id:
                        trace[f"{r.client_id}:{r.req_no}"] = (
                            "%016x" % trace_id
                        )
            self.feed.note_commit(entry.seq_no, line, trace=trace or None)

    def snap(self, network_config, client_states):
        import hashlib

        from mirbft_tpu_torch import wire
        from mirbft_tpu_torch.messages import NetworkState

        state = NetworkState(
            config=network_config,
            clients=tuple(client_states),
            pending_reconfigurations=(),
        )
        encoded = wire.encode(state)
        if self.snapstore is not None:
            digest = self.snapstore.save(encoded)
            with self._lock:
                seq = self._last_seq
            if self._checkpoint_log is not None:
                with open(self._checkpoint_log, "a") as f:
                    f.write(f"{seq} {digest.hex()}\n")
            if self.feed is not None:
                self.feed.note_checkpoint(seq, digest)
            pendings = ()
            if self.reshard is not None:
                # Deterministic across members: every node staged the
                # same plan before the marker committed, so all emit the
                # identical reconfiguration at the same checkpoint.
                pendings = self.reshard.on_checkpoint(client_states, seq)
            return digest, pendings
        return hashlib.sha256(encoded).digest() + encoded, ()

    def transfer_to(self, seq_no, snap):
        from mirbft_tpu_torch import wire

        with self._lock:
            self.state_transfers.append(seq_no)
            self._last_seq = max(self._last_seq, seq_no)
        if self.snapstore is None:
            return wire.decode(snap[32:])
        blob = self.snapstore.load(snap)
        if blob is None:
            from mirbft_tpu_torch.storage import fetch_snapshot_from_peers

            blob = fetch_snapshot_from_peers(self.peer_addrs, snap)
            if blob is None:
                raise RuntimeError(
                    f"snapshot {snap.hex()[:12]} unavailable locally and "
                    f"from {len(self.peer_addrs)} peers"
                )
            self.snapstore.save(blob)  # serve it onward; retries hit disk
        return wire.decode(blob)

    def close(self) -> None:
        with self._lock:
            self._file.close()


def _group_fingerprint(group_id: Optional[int], fingerprint: bytes) -> bytes:
    """Salt the protocol-handshake fingerprint with the group id so a
    cross-group protocol connection fails the handshake outright instead
    of ever mixing two groups' consensus traffic.  Ungrouped (legacy)
    nodes keep the unsalted fingerprint, wire-compatible with old peers."""
    if group_id is None:
        return fingerprint
    import hashlib

    digest = hashlib.sha256(
        struct.pack(">I", int(group_id)) + fingerprint
    ).digest()
    return digest[: len(fingerprint)] if len(fingerprint) <= 32 else digest


class _Instance:
    """One booted node runtime: transport + node + durable stores, plus
    the group-plane surfaces when the cluster file names a group — the
    client-envelope router, the MAP_REQUEST/SHIP_SUBSCRIBE handler, and
    the :class:`~mirbft_tpu_torch.groups.ship.ShipFeed` the app wrapper feeds.

    ``run_node`` owns exactly one; ``run_host`` (the cohost layout) boots
    one per co-hosted group in a single process and installs a shared
    ``submit_router`` so any of the host's listening ports serves client
    envelopes for every co-hosted group."""

    def __init__(self, root: Path, node_id: int, submit_router=None,
                 hasher=None):
        from mirbft_tpu_torch import metrics as metrics_mod
        from mirbft_tpu_torch.config import Config, standard_initial_network_state
        from mirbft_tpu_torch.health import HealthThresholds
        from mirbft_tpu_torch.net.framing import decode_client_envelope_routed
        from mirbft_tpu_torch.net.tcp import TcpTransport, config_fingerprint
        from mirbft_tpu_torch.node import Node, ProcessorConfig
        from mirbft_tpu_torch.ops import CpuHasher
        from mirbft_tpu_torch.storage import GroupCommitWAL, LogStore, SnapshotStore

        self.root = root
        self.node_id = node_id
        self._decode_env = decode_client_envelope_routed
        self._submit_router = submit_router

        cluster = json.loads(_cluster_path(root).read_text())
        node_count = cluster["node_count"]
        self.client_ids = cluster["client_ids"]
        # Transferred-client watermarks (docs/SHARDING.md "Elastic
        # resharding"): requests below a client's watermark were already
        # committed by the previous owner group — acked without
        # proposing, and the genesis window starts past them.
        self.client_watermarks: Dict[int, int] = {
            int(k): int(v)
            for k, v in (cluster.get("client_watermarks") or {}).items()
        }
        ports: Dict[int, int] = {
            int(k): v for k, v in cluster["ports"].items()
        }
        self._peer_ids = [pid for pid in ports if pid != node_id]
        self.fleet = bool(cluster.get("fleet"))
        if self.fleet:
            from mirbft_tpu_torch import tracing

            # Fleet mode turns the process tracer on so commit spans land
            # in the ring the collector drains.  Idempotent: cohost
            # layouts boot several instances in one process.
            tracing.default_tracer.enabled = True
        network_state = standard_initial_network_state(
            node_count, *self.client_ids
        )
        if self.client_watermarks:
            from mirbft_tpu_torch.messages import ClientState, NetworkState

            network_state = NetworkState(
                config=network_state.config,
                clients=tuple(
                    ClientState(
                        c.id,
                        c.width,
                        c.width_consumed_last_checkpoint,
                        self.client_watermarks.get(c.id, c.low_watermark),
                        c.committed_mask,
                    )
                    for c in network_state.clients
                ),
                pending_reconfigurations=(),
            )

        self.group_id: Optional[int] = cluster.get("group_id")
        self.map_bytes: Optional[bytes] = None
        self.current_map: Optional[GroupMap] = None
        self.map_version = 0
        self.feed = None
        self.reshard = None
        self._redirects = None
        if self.group_id is not None:
            from mirbft_tpu_torch.groups.ship import ShipFeed

            gmap = GroupMap.from_json_doc(cluster["group_map"])
            self.current_map = gmap
            self.map_bytes = gmap.to_json_bytes()
            self.map_version = gmap.map_version
            self.feed = ShipFeed(self.group_id)
            self._redirects = metrics_mod.default_registry.counter(
                "router_redirects_total",
                labels={"group": str(self.group_id)},
            )

        ndir = _node_dir(root, node_id)
        ndir.mkdir(parents=True, exist_ok=True)
        self._marker = ndir / "initialized"
        self.restarting = self._marker.exists()

        self.injector = None
        self.faults_version = -1
        if cluster.get("faults"):
            from mirbft_tpu_torch.net.faults import FaultInjector

            self.faults_version, plan = _load_fault_plan(root, node_id)
            self.injector = FaultInjector(node_id, plan)

        self.transport = TcpTransport(
            node_id,
            peers={pid: ("127.0.0.1", port) for pid, port in ports.items()},
            listen_port=ports[node_id],
            fingerprint=_group_fingerprint(
                self.group_id, config_fingerprint(network_state)
            ),
            unreachable_after_s=float(
                cluster.get("unreachable_after_s", 5.0)
            ),
            fault_injector=self.injector,
        )

        link = self.transport
        self.byz_link = None
        byz_spec = (cluster.get("byzantine") or {}).get(str(node_id))
        if byz_spec is not None:
            from mirbft_tpu_torch.net.byzantine import (
                ByzantineBehaviors,
                ByzantineLink,
            )

            self.byz_link = ByzantineLink(
                self.transport,
                node_id,
                ByzantineBehaviors.from_dict(byz_spec),
                seed=int(cluster.get("seed", 0)),
            )
            link = self.byz_link

        self.recorder = None
        if cluster.get("record_events"):
            from mirbft_tpu_torch.eventlog.journal import JournalRecorder

            # The always-on flight recorder (docs/OBSERVABILITY.md):
            # segmented CRC-framed journal under node-<i>/journal/ with
            # checkpoint-keyed retention and non-blocking overflow.  The
            # Node binds its trace LRU to the recorder's trace_lookup
            # slot, so recorded EventSteps carry fleet trace ids.
            self.recorder = JournalRecorder(
                ndir,
                node_id,
                # Monotonic ms: the doctor pins its replay clock to
                # these, and CLOCK_MONOTONIC is system-wide on Linux, so
                # incident windows compare across local node processes.
                time_source=lambda: time.monotonic_ns() // 1_000_000,
                retain_request_data=True,
            )

        cfg = {"id": node_id, "batch_size": 1}
        cfg.update(cluster.get("node_config") or {})
        self.snapstore = SnapshotStore(str(ndir / "snaps"))
        self.app = _CommitLogApp(
            ndir / "commits.log",
            snapstore=self.snapstore,
            peer_addrs=[
                ("127.0.0.1", port)
                for pid, port in ports.items()
                if pid != node_id
            ],
            feed=self.feed,
            checkpoint_log=(
                ndir / "checkpoints.log" if self.feed is not None else None
            ),
        )
        if self.group_id is not None:
            from mirbft_tpu_torch.groups import reshard as reshard_mod

            self.reshard = reshard_mod.ReshardCoordinator(
                self.group_id,
                initial_map_version=self.map_version,
                state_path=ndir / "reshard-state.json",
                on_cutover=self._install_map,
            )
            self.app.reshard = self.reshard
            # A restart mid-reshard re-installs the post-cutover map the
            # coordinator persisted (the feed has no subscribers yet, so
            # no cutover frame needs re-pushing).
            if (
                self.reshard.phase >= reshard_mod.CUTTING
                and self.reshard.plan is not None
            ):
                self._install_map(
                    json.dumps(
                        self.reshard.plan.map_doc, sort_keys=True
                    ).encode(),
                    self.reshard.plan.map_version(),
                    self.reshard.marker_seq or 0,
                )
        self.wal = GroupCommitWAL(str(ndir / "wal"))
        self.request_store = LogStore(str(ndir / "reqs"))
        pipeline = None
        if cluster.get("pipeline"):
            from mirbft_tpu_torch.processor.pipeline import PipelineConfig

            pipeline = PipelineConfig()
        self.node = Node(
            node_id,
            Config(**cfg),
            ProcessorConfig(
                # ``hasher``: injected by run_host when the cohost layout
                # shares one fused device wave across groups
                # (groups/cohost.py); every other layout keeps the
                # per-process CPU hasher.
                hasher=hasher if hasher is not None else CpuHasher(),
                link=link,
                app=self.app,
                wal=self.wal,
                request_store=self.request_store,
                interceptor=self.recorder,
            ),
            pipeline=pipeline,
        )
        thresholds = cluster.get("thresholds")
        self.node.health_monitor.configure(
            thresholds=(
                HealthThresholds.from_dict(thresholds) if thresholds else None
            ),
            num_nodes=node_count,
        )
        self.transport.health_monitor = self.node.health_monitor
        self._network_state = network_state
        self.metrics_path = ndir / "metrics.prom"
        self.node_label = (
            f"g{self.group_id}n{node_id}"
            if self.group_id is not None
            else f"n{node_id}"
        )
        if self.recorder is not None:
            from mirbft_tpu_torch.eventlog.incident import AnomalyCapture

            # Anomalies auto-capture incident bundles under
            # <root>/incidents/ (flight_recorder_captures_total); the
            # hook runs its file copies on a daemon thread, so detection
            # never waits on disk.  The 2 s settle lets the condition's
            # commit gap accumulate in the journal files past the
            # replay stall threshold (STALL_GAP_MS) before the copy —
            # the journal writer drains a queue, so the on-disk tail
            # lags the detection instant by its flush cadence.
            self.node.health_monitor.capture_hook = AnomalyCapture(
                root, self.node_label, settle_s=2.0
            )
        if self.fleet:
            self.app.trace_lookup = self.node.trace_id_of

    # --- wire surfaces ---

    def _on_message(self, source: int, msg) -> None:
        try:
            self.node.step(source, msg)
        except Exception:
            pass  # node stopping; the reader connection just drops

    def _install_map(self, map_bytes: bytes, version: int, seq: int) -> None:
        """Cutover hook (groups/reshard.py): swap in the post-cutover map
        and announce it on the ship feed.  Plain attribute assignment —
        atomic under the GIL; reader threads pick up the new epoch on
        their next redirect/route check."""
        self.current_map = GroupMap.from_json_bytes(map_bytes)
        self.map_bytes = map_bytes
        self.map_version = version
        if self.feed is not None:
            self.feed.note_reshard_cutover(seq, map_bytes)

    def serve_client(
        self,
        body: bytes,
        reply,
        trace_id: int = 0,
        client_id: Optional[int] = None,
    ) -> None:
        """Propose one de-enveloped client submission on this instance and
        ack it on the requester's connection.  A traced envelope binds the
        id locally and announces it to group peers (best-effort) so every
        replica's commit span carries the request's trace id.

        ``client_id`` comes from a version-3 routed envelope; legacy
        envelopes (None) mean the group's home client.  Two reshard
        surfaces live here: requests below a transferred client's
        watermark were committed by the previous owner and ack without
        proposing, and while a reshard plan is in flight the moved
        client's acks are **commit-gated** — an OK must imply commit,
        or the cutover reconfiguration could drop an acked request."""
        from mirbft_tpu_torch import tracing

        (req_no,) = _CLIENT_REQ.unpack_from(body)
        data = body[_CLIENT_REQ.size :]
        if client_id is None:
            client_id = self.client_ids[0]
        watermark = self.client_watermarks.get(client_id)
        if watermark is not None and req_no < watermark:
            reply(CLIENT_OK)
            return
        if trace_id:
            self.node.note_trace(client_id, req_no, trace_id)
            if self.fleet:
                self._announce_trace(client_id, req_no, trace_id)
        gated = (
            self.reshard is not None
            and self.reshard.gated_client() == client_id
        )
        tracer = tracing.default_tracer
        start = tracer.now() if tracer.enabled else 0.0
        deadline = time.monotonic() + _PROPOSE_RETRY_S
        while time.monotonic() < deadline:
            try:
                self.node.client(client_id).propose(req_no, data)
            except KeyError:
                time.sleep(0.02)  # client window not allocated yet
                continue
            if gated:
                while self.reshard.committed_up_to(client_id) < req_no:
                    if time.monotonic() >= deadline:
                        reply(CLIENT_BUSY)  # not committed: client retries
                        return
                    time.sleep(0.02)
            if tracer.enabled:
                # The routing tier's own span: admission of one routed
                # submission on this member, under the request's fleet
                # trace id when the envelope carried one.
                args = {
                    "client": client_id,
                    "req_no": req_no,
                    "group": self.group_id,
                }
                if trace_id:
                    args["trace"] = "%016x" % trace_id
                tracer.complete(
                    "route_submit",
                    start,
                    pid=self.group_id or 0,
                    tid=self.node_id,
                    args=args,
                )
            reply(CLIENT_OK)
            return
        reply(CLIENT_BUSY)

    def _announce_trace(
        self, client_id: int, req_no: int, trace_id: int
    ) -> None:
        """Push a TEL_ANNOUNCE binding to every peer over the existing
        protocol links (best-effort: a down peer just misses the tag)."""
        from mirbft_tpu_torch.net import telemetry
        from mirbft_tpu_torch.net.framing import KIND_TELEMETRY, encode_frame

        frame = encode_frame(
            KIND_TELEMETRY,
            telemetry.encode_announce(
                self.node_id, [(client_id, req_no, "%016x" % trace_id)]
            ),
        )
        for pid in self._peer_ids:
            self.transport._enqueue_frame(pid, frame)

    def redirect(self, reply) -> None:
        """Misrouted submission: answer with the authoritative group map
        so the client heals its routing in one round trip."""
        self._redirects.inc()
        reply(CLIENT_REDIRECT + self.map_bytes)

    def _on_client(self, payload: bytes, reply) -> None:
        from mirbft_tpu_torch.groups.reshard import RESHARD_CONTROL_CLIENT

        env_group, trace_id, client_id, _mv, body = self._decode_env(
            payload
        )
        if self._submit_router is not None:
            self._submit_router(
                env_group, body, reply, trace_id, client_id
            )
        elif self.group_id is None:
            self.serve_client(body, reply, trace_id=trace_id)
        elif (
            client_id is not None
            and client_id != RESHARD_CONTROL_CLIENT
        ):
            # Routed (v3) envelope: route by the *client* under our own
            # map — possibly newer than the sender's — so a submission
            # routed under a stale epoch earns a redirect carrying the
            # current map instead of committing to the wrong group.
            # Control-client markers are exempt: the harness addresses
            # them to a specific group by construction.
            if self.current_map.group_for(client_id) != self.group_id:
                self.redirect(reply)
            else:
                self.serve_client(
                    body, reply, trace_id=trace_id, client_id=client_id
                )
        elif env_group != self.group_id:
            self.redirect(reply)
        else:
            self.serve_client(
                body, reply, trace_id=trace_id, client_id=client_id
            )

    def _on_group(self, payload: bytes, send) -> None:
        from mirbft_tpu_torch.groups import reshard as reshard_mod
        from mirbft_tpu_torch.groups import ship

        try:
            subtype, group, seq, body = ship.decode(payload)
        except ValueError:
            return  # garbage subframe: drop, never kill the connection
        if subtype == ship.MAP_REQUEST:
            send(ship.encode_map_reply(self.map_bytes))
        elif subtype == ship.SHIP_SUBSCRIBE and group == self.group_id:
            self.feed.handle_subscribe(seq, send)
        elif subtype == ship.RESHARD_PLAN and group == self.group_id:
            try:
                self.reshard.stage(
                    reshard_mod.ReshardPlan.from_json_bytes(body)
                )
                doc = self.reshard.state_doc()
            except (ValueError, RuntimeError) as err:
                doc = {"group": self.group_id, "error": str(err)}
            send(
                ship.encode_reshard_state(
                    self.group_id, json.dumps(doc, sort_keys=True).encode()
                )
            )
        elif subtype == ship.RESHARD_QUERY and group == self.group_id:
            send(
                ship.encode_reshard_state(
                    self.group_id,
                    json.dumps(
                        self.reshard.state_doc(), sort_keys=True
                    ).encode(),
                )
            )

    def _on_telemetry(self, payload: bytes, send) -> None:
        from mirbft_tpu_torch import fleet as fleet_mod
        from mirbft_tpu_torch.net import telemetry

        try:
            subtype, _node, _clock, body = telemetry.decode(payload)
        except ValueError:
            return  # garbage subframe: drop, never kill the connection
        if subtype == telemetry.TEL_PULL:
            fleet_mod.serve_pull(
                payload,
                send,
                self.group_id,
                self.node_label,
                node_id=self.node_id,
            )
        elif subtype == telemetry.TEL_ANNOUNCE:
            try:
                bindings = telemetry.decode_body(body).get("bindings", [])
            except ValueError:
                return
            for binding in bindings:
                try:
                    client_id, req_no, trace_hex = binding
                    self.node.note_trace(
                        int(client_id), int(req_no), int(trace_hex, 16)
                    )
                except (ValueError, TypeError):
                    continue

    # --- lifecycle ---

    def start(self) -> None:
        self.transport.start(
            self._on_message,
            on_client=self._on_client,
            on_snapshot=self.snapstore.load,
            on_group=(
                self._on_group if self.group_id is not None else None
            ),
            # Always registered: trace announces from peers must never
            # cost a connection, and serving a pull is cheap.
            on_telemetry=self._on_telemetry,
        )
        if self.restarting:
            self.node.restart_processing(tick_interval=0.02)
        else:
            self.node.process_as_new_node(
                self._network_state, b"initial", tick_interval=0.02
            )
            self._marker.write_text("1")

    def snapshot_metrics(self) -> None:
        # Atomic snapshot: readers (the parent) never see a torn file.
        tmp = self.metrics_path.with_suffix(".prom.tmp")
        tmp.write_text(self.node.metrics_text())
        tmp.replace(self.metrics_path)

    def poll_faults(self) -> None:
        if self.injector is None:
            return
        version, plan = _load_fault_plan(self.root, self.node_id)
        if version != self.faults_version:
            self.faults_version = version
            self.injector.reconfigure(plan)

    def err(self):
        return self.node.notifier.err()

    def stop(self) -> None:
        self.node.stop()
        self.transport.stop()
        if self.byz_link is not None:
            self.byz_link.stop()
        if self.recorder is not None:
            try:
                self.recorder.stop()
            except RuntimeError:
                pass  # writer already failed; the log tail is simply torn
        try:
            self.snapshot_metrics()  # final ledger for the doctor
        except Exception:
            pass
        self.app.close()
        try:
            self.wal.close()
            self.request_store.close()
        except Exception:
            pass  # workers drained; a close race is not a node failure


def _child_loop(instances: List[_Instance], stop: threading.Event) -> int:
    """Shared child main loop: metrics snapshots and fault-plan polling
    for every booted instance until SIGTERM (or a node error)."""
    next_snapshot = 0.0
    try:
        while not stop.is_set():
            now = time.monotonic()
            if now >= next_snapshot:
                next_snapshot = now + _METRICS_SNAPSHOT_S
                for inst in instances:
                    inst.snapshot_metrics()
                    err = inst.err()
                    if err is not None:
                        print(
                            f"node {inst.node_id} failed: {err!r}",
                            file=sys.stderr,
                        )
                        stop.set()
            for inst in instances:
                inst.poll_faults()
            stop.wait(_FAULT_POLL_S)
    finally:
        for inst in instances:
            inst.stop()
    return 0


def run_node(root: Path, node_id: int) -> int:
    """Child entry point: node ``node_id`` of the cluster described by
    ``<root>/cluster.json``, serving protocol traffic, client frames, and
    (in sharded deployments) group-plane frames until SIGTERM."""
    inst = _Instance(root, node_id)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    inst.start()
    return _child_loop([inst], stop)


def _build_cohost_plane(n_groups: int, shard: dict):
    """The host's shared crypto plane, or ``None`` when the deployment did
    not ask for it / no CUDA card is present.

    The probe asks torch for a CUDA card and nothing else.  A host pinned
    off the card via ``MIRNET_TORCH_DEVICE`` (any value but "cuda") skips
    the plane, as a CPU-pinned host does in the JAX package.  Either way
    the resolution is recorded in the ``wave_mux_active`` gauge (it lands
    in every co-hosted metrics.prom snapshot), so cohost-vs-disjoint
    comparisons stay apples-to-apples.  ``MIRNET_SHARED_WAVE=force``
    builds the plane on ``MIRNET_TORCH_DEVICE`` (default "cuda") without
    probing: "cpu" runs the kernels' plain PyTorch twins (wiring tests),
    and a "cuda" plane on a host with no card raises here, in the child."""
    from mirbft_tpu_torch import metrics as metrics_mod

    active_gauge = metrics_mod.default_registry.gauge("wave_mux_active")
    if not shard.get("shared_wave"):
        active_gauge.set(0)
        return None
    torch_device = os.environ.get("MIRNET_TORCH_DEVICE", "") or "cuda"
    force = os.environ.get("MIRNET_SHARED_WAVE", "") == "force"
    if not force:
        if torch_device != "cuda":
            active_gauge.set(0)
            return None
        import torch

        if not torch.cuda.is_available():
            active_gauge.set(0)
            return None
    from mirbft_tpu_torch.groups.cohost import CohostCryptoPlane

    plane = CohostCryptoPlane(n_groups, torch_device=torch_device)
    active_gauge.set(1)
    return plane


def run_host(root: Path, host_id: int) -> int:
    """Cohost child: one OS process running node index ``host_id`` of
    *every* group in the shard (shard.json layout "cohost").  The
    co-hosted instances share the client plane: a KIND_CLIENT envelope
    arriving on any of this host's listening ports is dispatched to the
    co-hosted group it names — one client connection multiplexes
    submissions to all of them — and an envelope for a group this host
    does not serve earns a redirect carrying the group map.

    The co-hosted instances share the process-wide metrics registry, so
    their metrics.prom snapshots are a merged view; per-group doctor
    attribution needs the default disjoint layout (docs/SHARDING.md).

    When shard.json sets ``shared_wave`` (the cohost default), the host
    also shares the CRYPTO plane: one ``CohostCryptoPlane`` multiplexes
    every co-hosted group's hash/verify work into shared group-tagged
    fused device waves (docs/SHARDING.md "Cohost"), amortizing the
    per-dispatch overhead that used to be paid once per group.  Without
    an accelerator backend the plane would cost more than it saves, so
    the child degrades to per-group CPU hashers and says so in the
    ``wave_mux_active`` gauge — bench comparisons stay honest
    (``MIRNET_SHARED_WAVE=force`` overrides, for wiring tests)."""
    shard = json.loads(_shard_path(root).read_text())
    instances: Dict[int, _Instance] = {}
    n_groups = int(shard["groups"])

    cohost_plane = _build_cohost_plane(n_groups, shard)

    def router(
        env_group: int,
        body: bytes,
        reply,
        trace_id: int = 0,
        client_id: Optional[int] = None,
    ) -> None:
        inst = instances.get(env_group)
        if inst is None:
            next(iter(instances.values())).redirect(reply)
        else:
            inst.serve_client(
                body, reply, trace_id=trace_id, client_id=client_id
            )

    for g in range(n_groups):
        instances[g] = _Instance(
            _group_dir(root, g), host_id, submit_router=router,
            hasher=(
                cohost_plane.hasher_for(g)
                if cohost_plane is not None
                else None
            ),
        )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    for inst in instances.values():
        inst.start()
    return _child_loop(list(instances.values()), stop)


def run_observer(root: Path, group_id: int, obs_idx: int) -> int:
    """Observer child: non-voting learner tailing group ``group_id`` into
    ``<root>/group-<g>/observer-<idx>/`` — snapshot bootstrap over
    KIND_SNAPSHOT when it starts below the feed's backlog, then committed
    -batch log tailing (docs/SHARDING.md)."""
    from mirbft_tpu_torch import metrics as metrics_mod
    from mirbft_tpu_torch.groups.observer import Observer

    shard = json.loads(_shard_path(root).read_text())
    members = [(h, int(p)) for h, p in shard["map"][str(group_id)]]
    odir = _observer_dir(root, group_id, obs_idx)
    obs = Observer(group_id, members, odir)

    # Fleet mode: observers have no transport listener, so telemetry is
    # served on a dedicated pre-reserved port recorded in shard.json.
    telemetry_server = None
    tel_port = (shard.get("observer_telemetry") or {}).get(
        f"{group_id}:{obs_idx}"
    )
    if shard.get("fleet") and tel_port:
        from mirbft_tpu_torch import tracing
        from mirbft_tpu_torch.fleet import TelemetryServer

        tracing.default_tracer.enabled = True
        telemetry_server = TelemetryServer(
            "127.0.0.1",
            int(tel_port),
            group_id,
            f"g{group_id}obs{obs_idx}",
        )
        telemetry_server.start()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    tail = threading.Thread(
        target=obs.run,
        args=(stop,),
        name=f"observer-{group_id}-{obs_idx}",
        daemon=True,
    )
    tail.start()

    metrics_path = odir / "metrics.prom"

    def snapshot_metrics() -> None:
        tmp = metrics_path.with_suffix(".prom.tmp")
        tmp.write_text(metrics_mod.render_prometheus())
        tmp.replace(metrics_path)

    while not stop.is_set():
        snapshot_metrics()
        stop.wait(_METRICS_SNAPSHOT_S)
    tail.join(timeout=5)
    if telemetry_server is not None:
        telemetry_server.stop()
    try:
        snapshot_metrics()
    except Exception:
        pass
    obs.close()
    return 0


# --------------------------------------------------------------------------
# Parent role: deployment harness
# --------------------------------------------------------------------------


class SocketClient:
    """Real-socket client handle: submits requests as KIND_CLIENT frames
    and waits for the node's acknowledgement on the same connection.

    ``submit`` survives a connection loss mid-request (node restarting,
    partition window closing its TCP link): bounded attempts with jittered
    exponential backoff, reconnecting and **resubmitting the same frame**.
    Resubmission is idempotent by protocol construction — a duplicate
    ``propose`` with an identical (req_no, digest) is a no-op at the node
    — so a reply lost in flight cannot double-commit."""

    def __init__(
        self,
        addr: Tuple[str, int],
        timeout_s: float = 15.0,
        attempts: int = 6,
        backoff_base_s: float = 0.1,
        backoff_max_s: float = 2.0,
    ):
        self.addr = addr
        self.timeout_s = timeout_s
        self.attempts = attempts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._rng = random.Random(addr[1])  # retry jitter only
        self._sock: Optional[socket.socket] = None
        self._decoder = None
        self._pending: List[bytes] = []
        self._connect()  # eager: boot loops catch OSError and retry

    def _connect(self) -> None:
        from mirbft_tpu_torch.net.framing import FrameDecoder

        self._sock = socket.create_connection(self.addr, timeout=self.timeout_s)
        self._decoder = FrameDecoder()
        self._pending = []

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._decoder = None

    def _roundtrip(self, frame: bytes) -> bytes:
        from mirbft_tpu_torch.net.framing import KIND_CLIENT

        self._sock.sendall(frame)
        while not self._pending:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("node closed the client connection")
            for kind, payload in self._decoder.feed(chunk):
                if kind == KIND_CLIENT:
                    self._pending.append(payload)
        return self._pending.pop(0)

    def submit(self, req_no: int, data: bytes) -> bool:
        """Submit and await the ack; True iff the node accepted.  Raises
        ConnectionError only after every attempt failed."""
        from mirbft_tpu_torch.net.framing import KIND_CLIENT, encode_frame

        frame = encode_frame(KIND_CLIENT, _CLIENT_REQ.pack(req_no) + data)
        last_err: Optional[Exception] = None
        for attempt in range(self.attempts):
            if attempt:
                delay = min(
                    self.backoff_max_s,
                    self.backoff_base_s * (2 ** (attempt - 1)),
                )
                time.sleep(delay * (1.0 + 0.3 * self._rng.random()))
            try:
                if self._sock is None:
                    self._connect()
                return self._roundtrip(frame) == CLIENT_OK
            except (OSError, ConnectionError) as err:
                last_err = err
                self._teardown()
        raise ConnectionError(
            f"node at {self.addr} unreachable after {self.attempts} attempts"
        ) from last_err

    def close(self) -> None:
        self._teardown()


def _spawn(root: Path, node_id: int) -> subprocess.Popen:
    log = open(_node_dir(root, node_id) / "stdio.log", "ab")
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "mirbft_tpu_torch.tools.mirnet",
            "--node",
            str(node_id),
            "--dir",
            str(root),
        ],
        stdout=log,
        stderr=log,
    )


def _read_commits(root: Path, node_id: int) -> List[str]:
    path = _node_dir(root, node_id) / "commits.log"
    if not path.exists():
        return []
    return [line for line in path.read_text().splitlines() if line]


def _committed_reqs(lines: List[str]) -> set:
    done = set()
    for line in lines:
        for ref in line.split(" ", 2)[2].split(","):
            if ref:
                client, req_no = ref.split(":")
                done.add((int(client), int(req_no)))
    return done


def _metric_file_value(path: Path, name: str) -> float:
    if not path.exists():
        return 0.0
    total = 0.0
    for line in path.read_text().splitlines():
        if line.startswith(name) and " " in line:
            try:
                total += float(line.rsplit(" ", 1)[1])
            except ValueError:
                pass
    return total


def _metric_value(root: Path, node_id: int, name: str) -> float:
    return _metric_file_value(_node_dir(root, node_id) / "metrics.prom", name)


def _diff_commit_logs(root: Path, node_ids: List[int]) -> List[str]:
    """Bit-identical agreement check: every pair of nodes must agree on
    the common prefix of their commit sequences, byte for byte."""
    logs = {i: _read_commits(root, i) for i in node_ids}
    problems = []
    for i in node_ids:
        for j in node_ids:
            if j <= i:
                continue
            common = min(len(logs[i]), len(logs[j]))
            for k in range(common):
                if logs[i][k] != logs[j][k]:
                    problems.append(
                        f"nodes {i}/{j} diverge at commit {k}: "
                        f"{logs[i][k]!r} vs {logs[j][k]!r}"
                    )
                    break
    return problems


def _agreement_by_seq(root: Path, node_ids: List[int]) -> List[str]:
    """Bit-identical agreement tolerant of catch-up gaps: a node that
    state-transferred over a missed window skips sequence numbers it never
    applied, so logs are compared *by sequence number*, not by line index.
    Every seq committed anywhere must be byte-identical everywhere it
    appears, and each log must be strictly ascending (state transfer skips
    forward, never rewinds or rewrites)."""
    problems: List[str] = []
    per_seq: Dict[int, Tuple[int, str]] = {}
    for i in node_ids:
        last = -1
        for line in _read_commits(root, i):
            try:
                seq = int(line.split(" ", 1)[0])
            except ValueError:
                problems.append(f"node {i} unparseable commit line {line!r}")
                break
            if seq <= last:
                problems.append(
                    f"node {i} commit log not ascending at seq {seq}"
                )
                break
            last = seq
            first = per_seq.setdefault(seq, (i, line))
            if first[1] != line:
                problems.append(
                    f"nodes {first[0]}/{i} diverge at seq {seq}: "
                    f"{first[1]!r} vs {line!r}"
                )
    return problems


def run_deployment(
    root_dir: Optional[str] = None,
    node_count: int = 4,
    reqs: int = 10,
    kill_restart: bool = False,
    timeout_s: float = 90.0,
    client_id: int = 0,
    pipeline: bool = True,
    record_events: bool = True,
) -> dict:
    """Run a real multi-process deployment and return a result summary:
    ``{"commits": {node: n}, "agreement_problems": [...], "reconnects":
    {node: count}, "elapsed_s": ...}``.  Raises on timeout or divergence.
    The flight recorder is on unless ``record_events=False``
    (``--no-flight-recorder``).
    """
    owned_tmp = root_dir is None
    if owned_tmp:
        root_dir = tempfile.mkdtemp(prefix="mirnet-")
    root = Path(root_dir)
    root.mkdir(parents=True, exist_ok=True)
    ports = _reserve_ports(node_count)
    _write_cluster(root, node_count, ports, [client_id],
                   pipeline=pipeline, record_events=record_events)
    for i in range(node_count):
        _node_dir(root, i).mkdir(parents=True, exist_ok=True)

    started = time.monotonic()
    procs: Dict[int, subprocess.Popen] = {
        i: _spawn(root, i) for i in range(node_count)
    }
    victim = node_count - 1 if kill_restart else None
    try:
        # Mid-run drill shape: submit half the load, kill+restart a node,
        # then submit the rest — the surviving client connections to the
        # victim are rebuilt after the restart.
        first_batch = reqs // 2 if kill_restart else reqs
        _submit_range(root, ports, 0, first_batch, timeout_s)

        if kill_restart:
            _kill_restart_drill(root, procs, victim, timeout_s)
            _submit_range(root, ports, first_batch, reqs, timeout_s)

        quorum = node_count - (node_count - 1) // 3  # 2f+1
        _wait_commits(root, procs, range(node_count), client_id, reqs,
                      quorum, timeout_s)
        problems = _diff_commit_logs(root, list(range(node_count)))
        if problems:
            raise AssertionError(
                "commit logs diverged:\n" + "\n".join(problems)
            )
        result = {
            "root": str(root),
            "commits": {
                i: len(_read_commits(root, i)) for i in range(node_count)
            },
            "agreement_problems": problems,
            "reconnects": {
                i: _metric_value(root, i, "net_reconnects_total")
                for i in range(node_count)
            },
            "elapsed_s": time.monotonic() - started,
        }
        if kill_restart:
            survivors = [i for i in range(node_count) if i != victim]
            if not any(result["reconnects"][i] > 0 for i in survivors):
                raise AssertionError(
                    "kill/restart drill: no survivor observed a reconnect "
                    f"({result['reconnects']})"
                )
        return result
    finally:
        for process in procs.values():
            if process.poll() is None:
                process.terminate()
        for process in procs.values():
            try:
                process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                process.kill()
                process.wait(timeout=5)


def _connect_clients(
    root: Path, ports: List[int], timeout_s: float
) -> Dict[int, SocketClient]:
    """One client connection per node, retried while children boot."""
    clients: Dict[int, SocketClient] = {}
    deadline = time.monotonic() + timeout_s
    for i, port in enumerate(ports):
        while True:
            try:
                clients[i] = SocketClient(("127.0.0.1", port))
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"node {i} never started listening")
                time.sleep(0.1)
    return clients


def _submit_range(
    root: Path, ports: List[int], start: int, stop: int, timeout_s: float
) -> None:
    """Propose requests ``[start, stop)`` to every node (the reference
    stress shape: N proposals per request, commit-once enforced by the
    protocol) over fresh client connections."""
    if start >= stop:
        return
    clients = _connect_clients(root, ports, timeout_s)
    try:
        deadline = time.monotonic() + timeout_s
        for req_no in range(start, stop):
            data = b"mirnet-%d" % req_no
            for node_id, client in clients.items():
                while not client.submit(req_no, data):
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"node {node_id} kept refusing request {req_no}"
                        )
                    time.sleep(0.05)
    finally:
        for client in clients.values():
            client.close()


def _wait_commits(
    root: Path,
    procs: Dict[int, subprocess.Popen],
    node_ids,
    client_id: int,
    reqs: int,
    quorum: int,
    timeout_s: float,
    first_req: int = 0,
) -> None:
    expect = {(client_id, r) for r in range(first_req, reqs)}
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        done = sum(
            1
            for i in node_ids
            if expect <= _committed_reqs(_read_commits(root, i))
        )
        if done >= quorum:
            return
        for i, process in procs.items():
            code = process.poll()
            if code not in (None, 0, -signal.SIGKILL, -signal.SIGTERM):
                raise RuntimeError(
                    f"node {i} exited with {code}; see "
                    f"{_node_dir(root, i) / 'stdio.log'}"
                )
        time.sleep(0.2)
    status = {
        i: sorted(_committed_reqs(_read_commits(root, i))) for i in node_ids
    }
    raise TimeoutError(f"quorum never committed all requests: {status}")


def _kill_restart_drill(
    root: Path,
    procs: Dict[int, subprocess.Popen],
    victim: int,
    timeout_s: float,
) -> None:
    """SIGKILL one node, wait for a survivor to observe the outage
    (``net_reconnects_total`` > 0 in its metrics.prom), then restart the
    victim from its durable stores."""
    procs[victim].kill()
    procs[victim].wait(timeout=10)
    survivors = [i for i in procs if i != victim]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if any(
            _metric_value(root, i, "net_reconnects_total") > 0
            for i in survivors
        ):
            break
        time.sleep(0.2)
    else:
        raise TimeoutError("no survivor ever recorded a reconnect")
    procs[victim] = _spawn(root, victim)


# --------------------------------------------------------------------------
# Sharded parent role: S groups behind the routing tier (docs/SHARDING.md)
# --------------------------------------------------------------------------


def _write_shard(
    root: Path,
    groups: int,
    nodes_per_group: int,
    layout: str,
    ports: List[int],
    client_ids: List[int],
    fleet: bool = False,
    observer_telemetry: Optional[Dict[str, int]] = None,
    shared_wave: bool = False,
) -> GroupMap:
    """``shard.json``: the deployment-wide topology file — group count,
    layout, the authoritative group map, each group's home client, and
    (fleet deployments) the observers' telemetry listen ports keyed
    ``"<group>:<obs_idx>"`` (members answer TEL_PULL on their transport
    socket, observers need a dedicated listener).  ``shared_wave`` (cohost
    layout) asks each host process to multiplex its co-hosted groups'
    crypto through one shared fused device wave (groups/cohost.py); the
    child degrades to per-group host hashing when no accelerator backend
    is present and records which way it went in ``wave_mux_active``."""
    gmap = GroupMap(
        {
            g: [
                ("127.0.0.1", ports[g * nodes_per_group + i])
                for i in range(nodes_per_group)
            ]
            for g in range(groups)
        }
    )
    _write_json_atomic(
        _shard_path(root),
        {
            "groups": groups,
            "nodes_per_group": nodes_per_group,
            "layout": layout,
            "map": {
                str(g): [[h, p] for h, p in gmap.members(g)]
                for g in range(groups)
            },
            "client_ids": {str(g): client_ids[g] for g in range(groups)},
            "fleet": bool(fleet),
            "observer_telemetry": dict(observer_telemetry or {}),
            "shared_wave": bool(shared_wave),
        },
    )
    return gmap


def _spawn_host(root: Path, host_id: int) -> subprocess.Popen:
    log = open(root / f"host-{host_id}.log", "ab")
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "mirbft_tpu_torch.tools.mirnet",
            "--host",
            str(host_id),
            "--dir",
            str(root),
        ],
        stdout=log,
        stderr=log,
    )


def _spawn_observer(root: Path, group_id: int, obs_idx: int) -> subprocess.Popen:
    odir = _observer_dir(root, group_id, obs_idx)
    odir.mkdir(parents=True, exist_ok=True)
    log = open(odir / "stdio.log", "ab")
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "mirbft_tpu_torch.tools.mirnet",
            "--observer",
            str(obs_idx),
            "--group",
            str(group_id),
            "--dir",
            str(root),
        ],
        stdout=log,
        stderr=log,
    )


def _connect_routed(
    bootstrap: Tuple[str, int], timeout_s: float
) -> RoutedClient:
    """Route-aware client whose map is *discovered* over MAP_REQUEST from
    a bootstrap node, retried while the children boot."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return RoutedClient(bootstrap=bootstrap)
        except (OSError, ConnectionError):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "sharded cluster never answered MAP_REQUEST"
                )
            time.sleep(0.1)


class _ShardedCluster:
    """Parent-side handle for a multi-group deployment: one full cluster
    directory per group under ``<root>/group-<g>/`` (each a complete
    legacy deployment dir — cluster.json, faults.json, node dirs — so the
    single-group doctor and fault choreography reuse apply per group), a
    ``shard.json`` topology file, and one child process per (group, node)
    in the default **disjoint** layout or per host index in the
    **cohost** layout (one process runs that node index of every group,
    multiplexing the client plane over any of its connections)."""

    def __init__(
        self,
        root,
        *,
        groups: int = 2,
        nodes_per_group: int = 2,
        layout: str = "disjoint",
        seed: int = 0,
        faults: bool = False,
        record_events: bool = True,
        thresholds: Optional[dict] = None,
        node_config: Optional[dict] = None,
        unreachable_after_s: float = 5.0,
        timeout_s: float = 120.0,
        pipeline: bool = True,
        fleet: bool = False,
        fleet_observers: int = 0,
        shared_wave: Optional[bool] = None,
        extra_clients: Optional[Dict[int, List[int]]] = None,
    ):
        if layout not in ("disjoint", "cohost"):
            raise ValueError(f"unknown shard layout {layout!r}")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.groups = groups
        self.nodes_per_group = nodes_per_group
        self.layout = layout
        # Stashed for add_group (a split child provisioned mid-run must
        # boot with the same knobs as the original groups).
        self._seed = seed
        self._record_events = record_events
        self._pipeline = pipeline
        self._unreachable_after_s = unreachable_after_s
        self._node_config = dict(
            _STEADY_CONFIG if node_config is None else node_config
        )
        # Cohost defaults to the shared cross-group wave (the whole point
        # of co-hosting); ``shared_wave=False`` is the escape hatch back
        # to per-group hashers.  Meaningless (and off) for disjoint.
        self.shared_wave = (
            (layout == "cohost") if shared_wave is None
            else bool(shared_wave and layout == "cohost")
        )
        self.timeout_s = timeout_s
        self.fleet = bool(fleet)
        self.collector = None
        # Each group's home client: the smallest id hashing to the group,
        # so disjointness across groups holds by construction.
        self.client_ids = [
            client_for_group(g, groups) for g in range(groups)
        ]
        # Fleet runs reserve one extra port per expected observer: the
        # observer has no transport listener, so TEL_PULL needs a
        # dedicated TelemetryServer port published in shard.json.
        obs_count = groups * fleet_observers if fleet else 0
        ports = _reserve_ports(groups * nodes_per_group + obs_count)
        self.observer_telemetry: Dict[str, int] = {}
        if obs_count:
            obs_ports = ports[groups * nodes_per_group:]
            for g in range(groups):
                for k in range(fleet_observers):
                    self.observer_telemetry[f"{g}:{k}"] = obs_ports[
                        g * fleet_observers + k
                    ]
        self.map = _write_shard(
            self.root, groups, nodes_per_group, layout, ports,
            self.client_ids,
            fleet=self.fleet,
            observer_telemetry=self.observer_telemetry,
            shared_wave=self.shared_wave,
        )
        map_doc = {
            str(g): [[h, p] for h, p in self.map.members(g)]
            for g in range(groups)
        }
        merged_thresholds = dict(_WIRE_THRESHOLDS)
        merged_thresholds.update(thresholds or {})
        self._thresholds = merged_thresholds
        for g in range(groups):
            gdir = _group_dir(self.root, g)
            gdir.mkdir(parents=True, exist_ok=True)
            # Every group's genesis admits the reshard control client —
            # cutover markers (groups/reshard.py) are ordinary committed
            # requests of that client, so it must exist before any plan
            # is staged.  ``extra_clients`` adds scenario-specific client
            # identities (e.g. the to-be-moved client of a split).
            _write_cluster(
                gdir,
                nodes_per_group,
                [p for _h, p in self.map.members(g)],
                [self.client_ids[g], RESHARD_CONTROL_CLIENT]
                + list((extra_clients or {}).get(g, ())),
                seed=seed + g,
                faults=faults,
                record_events=record_events,
                thresholds=merged_thresholds,
                node_config=dict(
                    _STEADY_CONFIG if node_config is None else node_config
                ),
                unreachable_after_s=unreachable_after_s,
                pipeline=pipeline,
                group_id=g,
                num_groups=groups,
                group_map=map_doc,
                fleet=self.fleet,
            )
            if faults:
                _write_json_atomic(
                    _faults_path(gdir), {"version": 0, "plans": {}}
                )
            for i in range(nodes_per_group):
                _node_dir(gdir, i).mkdir(parents=True, exist_ok=True)
        self.procs: Dict[Tuple[str, int, int], subprocess.Popen] = {}
        self._faults_version = {g: 0 for g in range(groups)}
        self._stopped = False

    def __enter__(self) -> "_ShardedCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def start(self) -> None:
        if self.layout == "cohost":
            for h in range(self.nodes_per_group):
                self.procs[("host", h, -1)] = _spawn_host(self.root, h)
        else:
            for g in range(self.groups):
                for i in range(self.nodes_per_group):
                    self.procs[("node", g, i)] = _spawn(
                        _group_dir(self.root, g), i
                    )

    def spawn_observer(self, group_id: int, obs_idx: int = 0) -> None:
        self.procs[("obs", group_id, obs_idx)] = _spawn_observer(
            self.root, group_id, obs_idx
        )

    def add_group(
        self,
        group_id: int,
        ports: List[int],
        client_ids: List[int],
        group_map_doc: dict,
        client_watermarks: Optional[Dict[int, int]] = None,
    ) -> None:
        """Provision and start a new group mid-run — the receiving side
        of a split (docs/SHARDING.md "Elastic resharding").  The caller
        reserved ``ports`` up front: the child's addresses must be known
        *before* the parent's cutover marker commits, because the
        post-cutover map riding in the marker already names them.
        ``group_map_doc`` is the versioned map the children boot with;
        ``client_watermarks`` seeds each moved client's request window
        one past what the parent committed, so retries that straddle the
        cutover dedup instead of double-committing."""
        gdir = _group_dir(self.root, group_id)
        gdir.mkdir(parents=True, exist_ok=True)
        _write_cluster(
            gdir,
            len(ports),
            ports,
            client_ids,
            seed=self._seed + group_id,
            faults=False,
            record_events=self._record_events,
            thresholds=self._thresholds,
            node_config=dict(self._node_config),
            unreachable_after_s=self._unreachable_after_s,
            pipeline=self._pipeline,
            group_id=group_id,
            num_groups=len(group_map_doc.get("groups", group_map_doc)),
            group_map=group_map_doc,
            fleet=self.fleet,
            client_watermarks=client_watermarks,
        )
        for i in range(len(ports)):
            _node_dir(gdir, i).mkdir(parents=True, exist_ok=True)
            self.procs[("node", group_id, i)] = _spawn(gdir, i)

    # --- fleet telemetry ---

    def fleet_endpoints(self) -> List[dict]:
        """Every pullable telemetry endpoint: members answer TEL_PULL on
        their transport port, observers on their dedicated port from
        ``shard.json``."""
        eps = []
        for g in range(self.groups):
            for i, (host, port) in enumerate(self.map.members(g)):
                eps.append(
                    {"group": g, "node": f"g{g}n{i}",
                     "host": host, "port": port}
                )
        for key, port in sorted(self.observer_telemetry.items()):
            g, k = key.split(":")
            eps.append(
                {"group": int(g), "node": f"g{g}obs{k}",
                 "host": "127.0.0.1", "port": port}
            )
        return eps

    def start_collector(self, interval_s: float = 1.0):
        """Start the fleet collector writing ``<root>/fleet/``; no-op
        unless the deployment was created with ``fleet=True``."""
        if not self.fleet or self.collector is not None:
            return self.collector
        from mirbft_tpu_torch import fleet as fleet_mod

        self.collector = fleet_mod.FleetCollector(
            self.root / "fleet",
            self.fleet_endpoints(),
            interval_s=interval_s,
        )
        self.collector.start()
        return self.collector

    def stop_collector(self) -> None:
        if self.collector is not None:
            # One last synchronous pull so the final commits land in the
            # merged trace before the children go away.
            try:
                self.collector.pull_once()
            except Exception:
                pass
            self.collector.stop()
            self.collector = None

    def group_procs(self, g: int) -> Dict[int, subprocess.Popen]:
        if self.layout == "cohost":
            return {
                h: p
                for (kind, h, _x), p in self.procs.items()
                if kind == "host"
            }
        return {
            i: p
            for (kind, gg, i), p in self.procs.items()
            if kind == "node" and gg == g
        }

    # --- traffic ---

    def submit_group(
        self,
        g: int,
        start: int,
        stop: int,
        timeout_s: Optional[float] = None,
        client: Optional[RoutedClient] = None,
    ) -> None:
        """Submit requests ``[start, stop)`` for group ``g``'s home client
        to every group member (the reference stress shape; commit-once is
        enforced by the protocol) through the routing tier."""
        own = client is None
        if own:
            client = RoutedClient(group_map=self.map)
        try:
            deadline = time.monotonic() + (
                timeout_s if timeout_s is not None else self.timeout_s
            )
            cid = self.client_ids[g]
            for req_no in range(start, stop):
                data = b"mirnet-%d" % req_no
                for member in range(self.nodes_per_group):
                    while not client.submit(cid, req_no, data, member=member):
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"group {g} kept refusing request {req_no}"
                            )
                        time.sleep(0.05)
        finally:
            if own:
                client.close()

    def wait_commits(
        self,
        g: int,
        reqs: int,
        quorum: Optional[int] = None,
        timeout_s: Optional[float] = None,
        first_req: int = 0,
    ) -> None:
        npg = self.nodes_per_group
        _wait_commits(
            _group_dir(self.root, g),
            self.group_procs(g),
            list(range(npg)),
            self.client_ids[g],
            reqs,
            quorum if quorum is not None else npg - (npg - 1) // 3,
            timeout_s if timeout_s is not None else self.timeout_s,
            first_req=first_req,
        )

    # --- fault choreography (per group) ---

    def set_group_faults(self, g: int, plans: dict) -> None:
        self._faults_version[g] += 1
        _write_json_atomic(
            _faults_path(_group_dir(self.root, g)),
            {
                "version": self._faults_version[g],
                "plans": {str(i): p.as_dict() for i, p in plans.items()},
            },
        )
        time.sleep(3 * _FAULT_POLL_S)

    def partition_group(self, g: int, victims: Iterable[int]) -> None:
        """Netsplit inside one group: block every link crossing the
        victim/survivor cut, both directions, leaving every other group's
        wire untouched."""
        from mirbft_tpu_torch.net.faults import FaultPlan, FaultProfile

        cut = set(victims)
        plans = {}
        for i in range(self.nodes_per_group):
            links = {}
            for j in range(self.nodes_per_group):
                if j != i and (i in cut) != (j in cut):
                    links[(i, j)] = FaultProfile(partition=True)
            plans[i] = FaultPlan(links=links)
        self.set_group_faults(g, plans)

    def heal_group(self, g: int) -> None:
        self.set_group_faults(g, {})

    # --- observability ---

    def last_seq(self, g: int, node_id: int = 0) -> int:
        lines = _read_commits(_group_dir(self.root, g), node_id)
        return int(lines[-1].split(" ", 1)[0]) if lines else 0

    def head(self, g: int) -> int:
        """The group's commit head: the furthest member's last sequence."""
        return max(
            self.last_seq(g, i) for i in range(self.nodes_per_group)
        )

    def group_metric(self, g: int, name: str) -> float:
        return sum(
            _metric_value(_group_dir(self.root, g), i, name)
            for i in range(self.nodes_per_group)
        )

    def observer_metric(self, g: int, obs_idx: int, name: str) -> float:
        return _metric_file_value(
            _observer_dir(self.root, g, obs_idx) / "metrics.prom", name
        )

    # --- process control ---

    def stop_all(self) -> None:
        """Graceful SIGTERM stop so event recorders flush and final
        metrics snapshots land before judging."""
        if self._stopped:
            return
        self._stopped = True
        self.stop_collector()
        for process in self.procs.values():
            if process.poll() is None:
                process.terminate()
        for process in self.procs.values():
            try:
                process.wait(timeout=15)
            except subprocess.TimeoutExpired:
                process.kill()
                process.wait(timeout=5)

    def shutdown(self) -> None:
        self._stopped = True
        self.stop_collector()
        for process in self.procs.values():
            if process.poll() is None:
                process.terminate()
        for process in self.procs.values():
            try:
                process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    process.kill()
                    process.wait(timeout=5)
                except Exception:
                    pass


def _observer_head(root: Path, g: int, obs_idx: int) -> int:
    """The observer's applied head: max sequence across its journal and
    recorded checkpoints (a fresh bootstrap may have checkpoints only)."""
    head = 0
    for name in ("commits.log", "checkpoints.log"):
        path = _observer_dir(root, g, obs_idx) / name
        if path.exists():
            lines = [ln for ln in path.read_text().splitlines() if ln]
            if lines:
                head = max(head, int(lines[-1].split(" ", 1)[0]))
    return head


def wait_observer_synced(
    root, group_id: int, obs_idx: int, target_seq: int,
    timeout_s: float = 60.0,
) -> None:
    """Block until the observer's applied head reaches ``target_seq``."""
    root = Path(root)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if _observer_head(root, group_id, obs_idx) >= target_seq:
            return
        time.sleep(0.2)
    raise TimeoutError(
        f"observer {group_id}/{obs_idx} stuck at "
        f"{_observer_head(root, group_id, obs_idx)}, wanted {target_seq}"
    )


def observer_identity_problems(root, group_id: int, obs_idx: int) -> List[str]:
    """Bit-identity check for one observer against its group's members:
    every journal line the observer holds must be byte-identical to a
    member's line at the same sequence, and the observer's latest stable
    checkpoint (seq, digest, snapshot body) must match a member's."""
    root = Path(root)
    gdir = _group_dir(root, group_id)
    odir = _observer_dir(root, group_id, obs_idx)
    problems: List[str] = []

    member_lines: Dict[int, str] = {}
    for ndir in sorted(gdir.glob("node-*")):
        node_id = int(ndir.name.split("-", 1)[1])
        for line in _read_commits(gdir, node_id):
            member_lines.setdefault(int(line.split(" ", 1)[0]), line)
    obs_commits = odir / "commits.log"
    if obs_commits.exists():
        for line in obs_commits.read_text().splitlines():
            if not line:
                continue
            seq = int(line.split(" ", 1)[0])
            want = member_lines.get(seq)
            if want is None:
                problems.append(
                    f"observer holds seq {seq} no member committed"
                )
            elif want != line:
                problems.append(
                    f"observer diverges at seq {seq}: "
                    f"{line!r} vs {want!r}"
                )

    obs_ck = odir / "checkpoints.log"
    ck_lines = (
        [ln for ln in obs_ck.read_text().splitlines() if ln]
        if obs_ck.exists()
        else []
    )
    if not ck_lines:
        problems.append("observer recorded no stable checkpoint")
        return problems
    last = ck_lines[-1]
    member_cks = set()
    for ndir in sorted(gdir.glob("node-*")):
        path = ndir / "checkpoints.log"
        if path.exists():
            member_cks.update(
                ln for ln in path.read_text().splitlines() if ln
            )
    if last not in member_cks:
        problems.append(
            f"observer checkpoint {last!r} matches no member checkpoint"
        )
        return problems
    # The snapshot body itself must be on the observer's disk, byte-equal
    # to a member's copy of the same digest.
    digest_hex = last.split(" ", 1)[1]
    obs_snaps = sorted(p for p in (odir / "snaps").glob("*") if p.is_file())
    obs_blob = None
    for p in obs_snaps:
        if digest_hex in p.name:
            obs_blob = p.read_bytes()
    if obs_blob is None:
        problems.append(
            f"observer never persisted snapshot {digest_hex[:12]}"
        )
        return problems
    for ndir in sorted(gdir.glob("node-*")):
        for p in (ndir / "snaps").glob("*"):
            if p.is_file() and digest_hex in p.name:
                if p.read_bytes() != obs_blob:
                    problems.append(
                        f"snapshot {digest_hex[:12]} differs between "
                        f"observer and {ndir.name}"
                    )
                return problems
    problems.append(
        f"no member holds snapshot {digest_hex[:12]} to compare against"
    )
    return problems


def run_sharded_deployment(
    root_dir: Optional[str] = None,
    groups: int = 2,
    nodes_per_group: int = 2,
    reqs_per_group: int = 6,
    layout: str = "disjoint",
    observers_per_group: int = 0,
    timeout_s: float = 120.0,
    pipeline: bool = True,
    probe_redirect: bool = True,
    fleet: bool = False,
    record_events: bool = True,
    shared_wave: Optional[bool] = None,
) -> dict:
    """Run ``groups`` independent consensus groups behind the routing
    tier and return a summary: per-group commit counts, the disjointness
    and exactly-once verdicts, redirect accounting, and (with observers)
    per-observer sync state.  Raises on timeout, divergence, cross-group
    leakage, or duplicate commits.  ``fleet=True`` additionally runs the
    fleet telemetry collector against every child and leaves its rolling
    output under ``<root>/fleet/`` (docs/OBSERVABILITY.md)."""
    owned_tmp = root_dir is None
    if owned_tmp:
        root_dir = tempfile.mkdtemp(prefix="mirnet-sharded-")
    started = time.monotonic()
    redirects_followed = 0
    with _ShardedCluster(
        root_dir,
        groups=groups,
        nodes_per_group=nodes_per_group,
        layout=layout,
        timeout_s=timeout_s,
        pipeline=pipeline,
        fleet=fleet,
        fleet_observers=observers_per_group,
        record_events=record_events,
        shared_wave=shared_wave,
    ) as cluster:
        cluster.start()
        cluster.start_collector()
        # Map discovery over the wire, not hand-delivered configuration.
        client = _connect_routed(cluster.map.members(0)[0], timeout_s)
        try:
            if probe_redirect and groups >= 2 and layout == "disjoint":
                # Aim one group's request at the wrong group's node: the
                # redirect reply must carry a map that heals the client's
                # routing in one round trip.  (A cohost process serves
                # every group, so only the disjoint layout redirects.)
                wrong = GroupMap(
                    {g: cluster.map.members(0) for g in range(groups)}
                )
                probe = RoutedClient(group_map=wrong)
                try:
                    if not probe.submit(
                        cluster.client_ids[1], 0, b"mirnet-0"
                    ):
                        raise AssertionError(
                            "redirected probe was refused after reroute"
                        )
                    redirects_followed = probe.redirects_followed
                finally:
                    probe.close()
                if redirects_followed < 1:
                    raise AssertionError(
                        "misrouted probe was accepted without a redirect"
                    )
            for g in range(groups):
                cluster.submit_group(
                    g, 0, reqs_per_group, client=client
                )
        finally:
            client.close()
        for k in range(observers_per_group):
            for g in range(groups):
                cluster.spawn_observer(g, k)
        for g in range(groups):
            cluster.wait_commits(g, reqs_per_group)
        observer_state: Dict[str, dict] = {}
        total_reqs = reqs_per_group
        if observers_per_group:
            for g in range(groups):
                target = cluster.head(g)
                for k in range(observers_per_group):
                    wait_observer_synced(
                        cluster.root, g, k, target, timeout_s=timeout_s
                    )
            if fleet:
                # A second wave now that the observers tail the feed live:
                # the first wave usually predates their snapshot bootstrap,
                # so these are the batches whose trace trailers reach the
                # observers — the merged fleet trace then carries
                # router → members → observer spans for one request.
                total_reqs = reqs_per_group + 2
                for g in range(groups):
                    cluster.submit_group(g, reqs_per_group, total_reqs)
                for g in range(groups):
                    cluster.wait_commits(g, total_reqs)
            for g in range(groups):
                target = cluster.head(g)
                for k in range(observers_per_group):
                    wait_observer_synced(
                        cluster.root, g, k, target, timeout_s=timeout_s
                    )
                    observer_state[f"{g}/{k}"] = {
                        "head": _observer_head(cluster.root, g, k),
                        "lag": cluster.observer_metric(
                            g, k, "observer_lag_batches"
                        ),
                    }

        problems: List[str] = []
        per_group_commits: Dict[int, int] = {}
        per_group_reqs: Dict[int, set] = {}
        for g in range(groups):
            gdir = _group_dir(cluster.root, g)
            ids = list(range(nodes_per_group))
            problems += [
                f"group {g}: {p}" for p in _agreement_by_seq(gdir, ids)
            ]
            lines = _read_commits(gdir, 0)
            per_group_commits[g] = len(lines)
            committed = _committed_reqs(lines)
            per_group_reqs[g] = committed
            foreign = {c for c, _r in committed} - {cluster.client_ids[g]}
            if foreign:
                problems.append(
                    f"group {g} committed foreign clients {sorted(foreign)}"
                )
            counts: Dict[Tuple[int, int], int] = {}
            for line in lines:
                for ref in line.split(" ", 2)[2].split(","):
                    if ref:
                        c, r = ref.split(":")
                        key = (int(c), int(r))
                        counts[key] = counts.get(key, 0) + 1
            dups = {k: v for k, v in counts.items() if v > 1}
            if dups:
                problems.append(f"group {g} committed duplicates: {dups}")
        for g in range(groups):
            for h in range(g + 1, groups):
                overlap = per_group_reqs[g] & per_group_reqs[h]
                if overlap:
                    problems.append(
                        f"groups {g}/{h} overlap on "
                        f"{sorted(overlap)[:4]}..."
                    )
        if problems:
            raise AssertionError(
                "sharded deployment failed:\n" + "\n".join(problems)
            )
        # Graceful stop first: each child flushes a final metrics
        # snapshot, so the sums below see every commit.  (stop_all runs a
        # final collector pull while the children are still alive.)
        cluster.stop_all()
        result = {
            "root": str(cluster.root),
            "layout": layout,
            "groups": groups,
            "nodes_per_group": nodes_per_group,
            "client_ids": list(cluster.client_ids),
            "per_group_commits": per_group_commits,
            "unique_reqs_total": sum(
                len(s) for s in per_group_reqs.values()
            ),
            "redirects_followed": redirects_followed,
            "router_redirects": sum(
                cluster.group_metric(g, "router_redirects_total")
                for g in range(groups)
            ),
            "group_commits_total": sum(
                cluster.group_metric(g, "group_commits_total")
                for g in range(groups)
            ),
            "observers": observer_state,
            "elapsed_s": time.monotonic() - started,
        }
        if fleet:
            result["fleet_dir"] = str(cluster.root / "fleet")
        return result


# --------------------------------------------------------------------------
# Scenario plane: fault choreography + doctor-judged verdicts
# --------------------------------------------------------------------------


class _Cluster:
    """Parent-side choreography handle for fault scenarios: owns the
    deployment directory, the child processes, and the ``faults.json``
    version counter the children poll (docs/FAULTS.md)."""

    def __init__(
        self,
        root: Path,
        *,
        node_count: int = 4,
        seed: int = 7,
        client_id: int = 0,
        node_config: Optional[dict] = None,
        byzantine: Optional[dict] = None,
        unreachable_after_s: float = 5.0,
        thresholds: Optional[dict] = None,
        initial_plans: Optional[dict] = None,
        timeout_s: float = 60.0,
        pipeline: bool = True,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.node_count = node_count
        self.seed = seed
        self.client_id = client_id
        self.timeout_s = timeout_s
        self.ports = _reserve_ports(node_count)
        merged_thresholds = dict(_WIRE_THRESHOLDS)
        merged_thresholds.update(thresholds or {})
        _write_cluster(
            self.root,
            node_count,
            self.ports,
            [client_id],
            seed=seed,
            faults=True,
            record_events=True,
            thresholds=merged_thresholds,
            node_config=dict(
                _STEADY_CONFIG if node_config is None else node_config
            ),
            byzantine=byzantine,
            unreachable_after_s=unreachable_after_s,
            pipeline=pipeline,
        )
        self._faults_version = 0
        _write_json_atomic(
            _faults_path(self.root),
            {
                "version": 0,
                "plans": {
                    str(i): p.as_dict()
                    for i, p in (initial_plans or {}).items()
                },
            },
        )
        for i in range(node_count):
            _node_dir(self.root, i).mkdir(parents=True, exist_ok=True)
        self.procs: Dict[int, subprocess.Popen] = {}
        self._stopped = False

    def __enter__(self) -> "_Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def start(self) -> None:
        for i in range(self.node_count):
            self.procs[i] = _spawn(self.root, i)

    # --- choreography ---

    def set_faults(self, plans: dict) -> None:
        """Ship ``{node_id: FaultPlan}`` to the children; blocks one poll
        cycle so every child has observed the new version before the
        caller's next move."""
        self._faults_version += 1
        _write_json_atomic(
            _faults_path(self.root),
            {
                "version": self._faults_version,
                "plans": {str(i): p.as_dict() for i, p in plans.items()},
            },
        )
        time.sleep(3 * _FAULT_POLL_S)

    def partition(self, victims: Iterable[int]) -> None:
        """Block every link that crosses the victim/survivor cut, in both
        directions — a real netsplit, not a one-way mute."""
        from mirbft_tpu_torch.net.faults import FaultPlan, FaultProfile

        cut = set(victims)
        plans = {}
        for i in range(self.node_count):
            links = {}
            for j in range(self.node_count):
                if j != i and (i in cut) != (j in cut):
                    links[(i, j)] = FaultProfile(partition=True)
            plans[i] = FaultPlan(seed=self.seed, links=links)
        self.set_faults(plans)

    def heal(self) -> None:
        self.set_faults({})

    # --- traffic ---

    def submit(self, start: int, stop: int,
               timeout_s: Optional[float] = None) -> None:
        _submit_range(self.root, self.ports, start, stop,
                      timeout_s if timeout_s is not None else self.timeout_s)

    def wait_commits(
        self,
        reqs: int,
        quorum: Optional[int] = None,
        node_ids: Optional[List[int]] = None,
        timeout_s: Optional[float] = None,
        first_req: int = 0,
    ) -> None:
        ids = node_ids if node_ids is not None else list(range(self.node_count))
        _wait_commits(
            self.root,
            self.procs,
            ids,
            self.client_id,
            reqs,
            quorum if quorum is not None else len(ids),
            timeout_s if timeout_s is not None else self.timeout_s,
            first_req=first_req,
        )

    # --- observability ---

    def _samples(self, node_id: int, name: str):
        from mirbft_tpu_torch.tools.mircat import parse_prom_samples

        path = _node_dir(self.root, node_id) / "metrics.prom"
        if not path.exists():
            return []
        return parse_prom_samples(path.read_text(), name)

    def injected(self, node_id: int) -> Dict[str, float]:
        """``net_faults_injected_total`` by kind from the node's last
        metrics snapshot."""
        out: Dict[str, float] = {}
        for labels, value in self._samples(node_id, "net_faults_injected_total"):
            kind = labels.get("kind", "")
            out[kind] = out.get(kind, 0.0) + value
        return out

    def faults(self, node_id: int) -> Dict[Tuple[int, str], float]:
        """Live ``peer_faults_total`` ledger keyed ``(peer, kind)``."""
        out: Dict[Tuple[int, str], float] = {}
        for labels, value in self._samples(node_id, "peer_faults_total"):
            if "peer" in labels and "kind" in labels:
                key = (int(labels["peer"]), labels["kind"])
                out[key] = out.get(key, 0.0) + value
        return out

    def reconnects(self, node_id: int) -> float:
        return _metric_value(self.root, node_id, "net_reconnects_total")

    def last_seq(self, node_id: int) -> int:
        """Highest sequence number in the node's commit log (0 if none)."""
        lines = _read_commits(self.root, node_id)
        return int(lines[-1].split(" ", 1)[0]) if lines else 0

    def wait_rejoin(
        self, node_id: int, past_seq: int, timeout_s: float = 30.0
    ) -> None:
        """Block until the node's commit head passes ``past_seq`` — proof
        it crossed an outage window (live replay or state transfer) and is
        tracking the cluster again.  A healed node may legitimately jump
        the exact sequences it missed (state transfer never replays them
        to the app), so head progress, not request presence, is the
        rejoin criterion."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.last_seq(node_id) > past_seq:
                return
            time.sleep(0.2)
        raise TimeoutError(
            f"node {node_id} never advanced past seq {past_seq} "
            f"(stuck at {self.last_seq(node_id)})"
        )

    def wait_fault(
        self,
        observers: Iterable[int],
        peer: int,
        kind: str,
        timeout_s: float = 25.0,
    ) -> None:
        """Block until every observer's live ledger attributes ``kind`` to
        ``peer`` (metrics snapshots lag by up to 0.5s)."""
        obs = list(observers)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(self.faults(i).get((peer, kind), 0.0) > 0 for i in obs):
                return
            time.sleep(0.2)
        raise TimeoutError(
            f"nodes {obs} never attributed {kind!r} to peer {peer}: "
            f"{ {i: self.faults(i) for i in obs} }"
        )

    # --- process control ---

    def kill(self, node_id: int) -> None:
        self.procs[node_id].kill()
        self.procs[node_id].wait(timeout=10)

    def restart(self, node_id: int) -> None:
        self.procs[node_id] = _spawn(self.root, node_id)

    def stop_all(self) -> None:
        """Graceful SIGTERM stop so event recorders flush and the final
        metrics snapshots land before judging."""
        if self._stopped:
            return
        self._stopped = True
        for process in self.procs.values():
            if process.poll() is None:
                process.terminate()
        for process in self.procs.values():
            try:
                process.wait(timeout=15)
            except subprocess.TimeoutExpired:
                process.kill()
                process.wait(timeout=5)

    def shutdown(self) -> None:
        self._stopped = True
        for process in self.procs.values():
            if process.poll() is None:
                process.terminate()
        for process in self.procs.values():
            try:
                process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    process.kill()
                    process.wait(timeout=5)
                except Exception:
                    pass

    # --- judgment ---

    def judge(self) -> dict:
        """Stop everything, then run the full verdict stack: seq-keyed
        bit-identical agreement plus the deployment doctor over event logs
        and live counters."""
        self.stop_all()
        from mirbft_tpu_torch.tools.mircat import doctor_deployment

        node_ids = list(range(self.node_count))
        return {
            "agreement_problems": _agreement_by_seq(self.root, node_ids),
            "doctor": doctor_deployment(self.root),
            "injected": {i: self.injected(i) for i in node_ids},
            "reconnects": {i: self.reconnects(i) for i in node_ids},
        }


def _sum_injected(res: dict) -> Dict[str, float]:
    total: Dict[str, float] = {}
    for kinds in res["injected"].values():
        for kind, value in kinds.items():
            total[kind] = total.get(kind, 0.0) + value
    return total


def _check_anomalies(
    failures: List[str], doctor: dict, node_ids: Iterable[int], allowed: set
) -> None:
    for i in node_ids:
        extra = set(doctor["per_node"][i]["anomaly_kinds"]) - allowed
        if extra:
            failures.append(
                f"node {i} unexpected anomaly kinds {sorted(extra)} "
                f"(allowed: {sorted(allowed)})"
            )


def _verdict(root: Path, name: str, data: dict, failures: List[str]) -> dict:
    """Publish the scenario outcome: the ``scenario_verdict`` gauge
    (1 pass / 0 fail), a ``scenario.json`` verdict file next to the
    deployment, and an AssertionError carrying every failed check."""
    from mirbft_tpu_torch import metrics as metrics_mod

    metrics_mod.default_registry.gauge(
        "scenario_verdict", labels={"scenario": name}
    ).set(0.0 if failures else 1.0)
    doc = {
        "scenario": name,
        "verdict": "fail" if failures else "pass",
        "failures": list(failures),
        "data": data,
    }
    (Path(root) / "scenario.json").write_text(
        json.dumps(doc, indent=2, sort_keys=True, default=str)
    )
    if failures:
        raise AssertionError(
            f"scenario {name} failed:\n" + "\n".join(failures)
        )
    return doc


def _scenario_control(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """Zero-rate control: the injector is wired on every link with all
    rates zero — the run must be indistinguishable from no injector at
    all.  Doctor healthy, zero anomalies, zero peer faults, zero injected
    frames."""
    from mirbft_tpu_torch.net.faults import FaultPlan

    with _Cluster(
        root,
        seed=seed,
        initial_plans={i: FaultPlan(seed=seed) for i in range(4)},
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        cluster.submit(0, 6)
        cluster.wait_commits(6, quorum=4)
        res = cluster.judge()

    failures: List[str] = []
    doctor = res["doctor"]
    if not doctor["healthy"]:
        failures.append(
            f"doctor unhealthy: faults={doctor['faults']} "
            f"anomalies={doctor['anomaly_count']}"
        )
    if doctor["anomaly_count"]:
        failures.append(f"{doctor['anomaly_count']} anomalies in control run")
    if doctor["faults"]:
        failures.append(f"peer faults in control run: {doctor['faults']}")
    for i, kinds in res["injected"].items():
        hot = {k: v for k, v in kinds.items() if v}
        if hot:
            failures.append(
                f"node {i} injected faults under a zero-rate plan: {hot}"
            )
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    # Flight recorder on by default: the divergence audit over the
    # always-on journals must come back clean (mircat --audit exit 0) —
    # the determinism invariant enforced on a real deployment.
    from mirbft_tpu_torch.tools.mircat import audit_deployment

    audit = audit_deployment(root)
    res["audit"] = {
        "clean": audit["clean"],
        "divergence_count": audit["divergence_count"],
        "verdicts": {
            label: node["verdict"]
            for label, node in audit["per_node"].items()
        },
    }
    if not audit["clean"]:
        failures.append(
            f"divergence audit failed: "
            f"{ {l: n['divergences'] for l, n in audit['per_node'].items() if n['divergences']} }"
        )
    if not audit["per_node"]:
        failures.append("audit found no journaled nodes (flight recorder "
                        "should be on by default)")
    for label, node in audit["per_node"].items():
        if node["verdict"] not in ("clean",):
            failures.append(
                f"audit verdict for {label} is {node['verdict']!r}, "
                f"expected clean in a control run"
            )
    return _verdict(root, "control", res, failures)


def _scenario_partition_minority(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """Partition a minority node, wait until every survivor attributes
    ``peer_unreachable`` to it, heal, and require the full cluster (the
    healed node included) to commit fresh traffic.  View changes stay
    enabled: the protocol has no preprepare retransmission, so suspicion
    and a fresh epoch are the only way to refill the victim's bucket
    after its in-flight frames were dropped.  ``peer_unreachable`` may
    only ever target the victim; suspicion votes are legitimate recovery
    (blame diffuses over the epochs walked through during the outage)."""
    survivors, victim = [0, 1, 2], 3
    with _Cluster(
        root,
        seed=seed,
        node_config=dict(_VIEWCHANGE_CONFIG),
        unreachable_after_s=0.8,
        timeout_s=45.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        cluster.submit(0, 4)
        cluster.wait_commits(4, quorum=4)
        cluster.partition({victim})
        cluster.wait_fault(survivors, victim, "peer_unreachable",
                           timeout_s=20.0)
        cluster.heal()
        time.sleep(1.0)  # let reconnects land before fresh traffic
        cluster.submit(4, 8)
        # The victim may state-transfer over the exact seqs carrying the
        # fresh requests, so the full-log bar applies to survivors only;
        # the healed node instead proves rejoin by committing *past* the
        # survivors' head.
        cluster.wait_commits(8, quorum=3, node_ids=survivors, timeout_s=45.0)
        cluster.wait_rejoin(
            victim, max(cluster.last_seq(i) for i in survivors)
        )
        res = cluster.judge()

    failures: List[str] = []
    doctor = res["doctor"]
    for i in survivors:
        node_faults = doctor["per_node"][i]["faults"]
        if node_faults.get(f"{victim}:peer_unreachable", 0) <= 0:
            failures.append(
                f"survivor {i} never attributed peer_unreachable to "
                f"{victim}: {node_faults}"
            )
        # The victim legitimately sees every survivor as unreachable from
        # its side of the cut; survivors must only ever blame the victim.
        innocent = {
            key
            for key in node_faults
            if key.endswith(":peer_unreachable")
            and not key.startswith(f"{victim}:")
        }
        if innocent:
            failures.append(
                f"survivor {i} attributed peer_unreachable to an innocent "
                f"peer: {sorted(innocent)}"
            )
    fault_kinds = {key.split(":", 1)[1] for key in doctor["faults"]}
    if fault_kinds - {"peer_unreachable", "suspicion_vote"}:
        failures.append(
            f"unexpected fault kinds attributed: {sorted(fault_kinds)}"
        )
    _check_anomalies(
        failures, doctor, range(4),
        {"peer_fault", "epoch_thrash", "watermark_stall",
         "checkpoint_stagnation"},
    )
    injected = _sum_injected(res)
    if injected.get("partition", 0) <= 0:
        failures.append("no partition frames were ever injected")
    noise = {k: v for k, v in injected.items() if k != "partition" and v}
    if noise:
        failures.append(f"unexpected injected kinds: {noise}")
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    _check_incident_capture(root, res, failures)
    return _verdict(root, "partition-minority", res, failures)


def _check_incident_capture(
    root: Path, res: dict, failures: List[str]
) -> None:
    """Flight-recorder acceptance for fault scenarios: the injected fault
    must have auto-captured at least one complete incident bundle, the
    bundle's deterministic replay must be byte-stable, and the replayed
    commit stream must show the doctor-flagged outage — an inter-commit
    gap overlapping the bundle window.  (A minority partition stops the
    commit stream for everyone: no client traffic flows during the cut,
    and the outage spans unreachable attribution plus the heal sleep, so
    the replayed gap is well past the 1s stall threshold.)

    Transport-only anomalies (``peer_fault``) never cross the state
    machine, so replay cannot re-derive *them* — the reproduction bar for
    those bundles is the commit gap; replay-visible kinds must also
    reproduce their anomaly kind."""
    from mirbft_tpu_torch.eventlog.incident import replay_incident

    replay_kinds = {
        "watermark_stall",
        "epoch_thrash",
        "checkpoint_stagnation",
        "client_starvation",
        "msg_buffer_growth",
    }
    allowed = replay_kinds | {"peer_fault", "checkpoint_divergence"}
    manifests = sorted(
        (root / "incidents").glob("incident-*/manifest.json")
    )
    reasons: List[str] = []
    for manifest_path in manifests:
        try:
            reasons.append(
                json.loads(manifest_path.read_text()).get("reason", "?")
            )
        except ValueError:
            failures.append(f"unreadable manifest {manifest_path}")
    res["incident_bundles"] = {
        "count": len(manifests),
        "reasons": sorted(reasons),
    }
    if not manifests:
        failures.append(
            "no auto-captured incident bundle (the injected fault's "
            "anomalies should have triggered HealthMonitor.capture_hook)"
        )
        return
    for reason in reasons:
        if reason not in allowed:
            failures.append(
                f"incident bundle captured for unexpected reason "
                f"{reason!r}"
            )
    # Deep-check one bundle (they all carry every node's journal).
    bundle = manifests[0].parent
    manifest = json.loads(manifests[0].read_text())
    first = replay_incident(bundle)
    second = replay_incident(bundle)
    if first != second:
        failures.append(f"bundle {bundle.name} replay is not deterministic")
    if not first["timeline"]:
        failures.append(
            f"bundle {bundle.name} replay produced an empty timeline"
        )
    window = manifest["window_ms"]
    if not any(
        s["until_ms"] >= window[0] and s["since_ms"] <= window[1]
        for s in first["stalls"]
    ):
        failures.append(
            f"bundle {bundle.name} replay shows no commit stall "
            f"overlapping the captured window {window} "
            f"(stalls={first['stalls']})"
        )
    if (
        manifest["reason"] in replay_kinds
        and manifest["reason"] not in first["anomaly_kinds"]
    ):
        failures.append(
            f"bundle {bundle.name} replay did not reproduce the "
            f"capturing anomaly {manifest['reason']!r} "
            f"(got {first['anomaly_kinds']})"
        )


def _scenario_partition_leader(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """Partition the current primary (the genesis epoch activates as
    epoch 1, so the steady-state primary is node 1): the survivors must
    suspect it — attributing ``suspicion_vote`` to the *correct* node —
    move past its epoch, and keep committing without it; after the heal
    the old primary rejoins and the whole cluster converges."""
    victim, survivors = 1, [0, 2, 3]
    with _Cluster(
        root,
        seed=seed,
        node_config=dict(_VIEWCHANGE_CONFIG),
        unreachable_after_s=0.8,
        timeout_s=60.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        cluster.submit(0, 4)
        cluster.wait_commits(4, quorum=4)
        cluster.partition({victim})
        cluster.wait_fault(survivors, victim, "peer_unreachable",
                           timeout_s=20.0)
        cluster.submit(4, 8)
        # The 3-node majority is exactly 2f+1: it must commit alone.
        cluster.wait_commits(8, quorum=3, node_ids=survivors, timeout_s=60.0)
        cluster.heal()
        # The demoted primary proves rejoin by committing past the
        # survivors' head (it may state-transfer over what it missed).
        cluster.wait_rejoin(
            victim, max(cluster.last_seq(i) for i in survivors)
        )
        res = cluster.judge()

    failures: List[str] = []
    doctor = res["doctor"]
    suspecting = sum(
        1
        for i in survivors
        if doctor["per_node"][i]["faults"].get(f"{victim}:suspicion_vote", 0)
        > 0
    )
    if suspecting < 2:
        failures.append(
            f"only {suspecting} survivors attributed suspicion_vote to the "
            f"partitioned primary {victim}"
        )
    for i in survivors:
        if doctor["per_node"][i]["faults"].get(
            f"{victim}:peer_unreachable", 0
        ) <= 0:
            failures.append(
                f"survivor {i} never attributed peer_unreachable to {victim}"
            )
        if doctor["per_node"][i]["max_epoch"] < 2:
            failures.append(
                f"survivor {i} never left the partitioned primary's epoch"
            )
        # Suspicion blame diffuses over the epochs walked through while
        # the primary is dark, so only non-suspicion kinds must stay
        # pinned on the victim.
        bad_peer = {
            key
            for key in doctor["per_node"][i]["faults"]
            if not key.startswith(f"{victim}:")
            and not key.endswith(":suspicion_vote")
        }
        if bad_peer:
            failures.append(
                f"survivor {i} blamed an innocent peer: {sorted(bad_peer)}"
            )
    _check_anomalies(
        failures, doctor, survivors,
        {"peer_fault", "epoch_thrash", "watermark_stall",
         "checkpoint_stagnation"},
    )
    if _sum_injected(res).get("partition", 0) <= 0:
        failures.append("no partition frames were ever injected")
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    return _verdict(root, "partition-leader", res, failures)


def _scenario_flap(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """Link flapping: three short partition/heal pulses against one node,
    each well below the unreachable threshold.  Reconnects happen, and
    dropped in-flight frames may force suspicion-based recovery (the
    protocol never retransmits consensus traffic), but no flap may ever
    be escalated to a ``peer_unreachable`` outage — and the cluster must
    then commit fresh traffic, the flapped node rejoining past the
    others' head (it may state-transfer over the frames it lost)."""
    victim = 2
    with _Cluster(
        root,
        seed=seed,
        node_config=dict(_VIEWCHANGE_CONFIG),
        # Whole flap phase < 10s: cumulative outage can never cross it.
        unreachable_after_s=10.0,
        timeout_s=60.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        cluster.submit(0, 3)
        cluster.wait_commits(3, quorum=4)
        for _ in range(3):
            cluster.partition({victim})
            time.sleep(0.7)
            cluster.heal()
            time.sleep(1.3)  # poll cycle + reconnect before the next pulse
        cluster.submit(3, 8)
        steady = [i for i in range(4) if i != victim]
        cluster.wait_commits(8, quorum=3, node_ids=steady, timeout_s=60.0)
        cluster.wait_rejoin(
            victim, max(cluster.last_seq(i) for i in steady)
        )
        res = cluster.judge()

    failures: List[str] = []
    doctor = res["doctor"]
    unreachable = [
        key for key in doctor["faults"] if key.endswith(":peer_unreachable")
    ]
    if unreachable:
        failures.append(
            "flaps below the unreachable threshold must never be "
            f"attributed as an outage: {sorted(unreachable)}"
        )
    fault_kinds = {key.split(":", 1)[1] for key in doctor["faults"]}
    if fault_kinds - {"suspicion_vote"}:
        failures.append(
            f"flaps attributed unexpected fault kinds: {sorted(fault_kinds)}"
        )
    _check_anomalies(
        failures, doctor, range(4),
        {"peer_fault", "epoch_thrash", "watermark_stall",
         "checkpoint_stagnation"},
    )
    injected = _sum_injected(res)
    if injected.get("partition", 0) <= 0:
        failures.append("no partition frames were ever injected")
    noise = {k: v for k, v in injected.items() if k != "partition" and v}
    if noise:
        failures.append(f"unexpected injected kinds: {noise}")
    if not any(v > 0 for v in res["reconnects"].values()):
        failures.append("no node ever reconnected across three flaps")
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    return _verdict(root, "flap", res, failures)


def _scenario_lossy_wan(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """Every link degraded at once — latency, jitter, drops, duplicates,
    reorders, corruption, truncation — netem's lossy-WAN shape.  The
    protocol may ride through view changes (suspicion is legitimate
    recovery under loss), but corruption must stay at the framing layer:
    no invalid_digest / ingress_reject attribution, and the logs agree."""
    from mirbft_tpu_torch.net.faults import FaultPlan, FaultProfile

    wan = FaultProfile(
        delay_ms=10.0,
        jitter_ms=10.0,
        drop_pct=2.0,
        duplicate_pct=2.0,
        reorder_pct=2.0,
        corrupt_pct=0.5,
        truncate_pct=0.5,
    )
    with _Cluster(
        root,
        seed=seed,
        node_config={"suspect_ticks": 100, "new_epoch_timeout_ticks": 200},
        thresholds={
            "stall_observations": 400,
            "checkpoint_stalled_observations": 400,
            "starvation_observations": 500,
        },
        initial_plans={
            i: FaultPlan(seed=seed + i, default=wan) for i in range(4)
        },
        timeout_s=90.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        cluster.submit(0, 8, timeout_s=90.0)
        cluster.wait_commits(8, quorum=4, timeout_s=90.0)
        res = cluster.judge()

    failures: List[str] = []
    doctor = res["doctor"]
    injected = _sum_injected(res)
    for kind in ("drop", "delay", "duplicate", "reorder", "corrupt",
                 "truncate"):
        if injected.get(kind, 0) <= 0:
            failures.append(f"lossy-WAN profile never injected {kind!r}")
    corrupted = sum(
        _metric_value(Path(res["doctor"]["root"]), i,
                      "net_frames_corrupted_total")
        for i in range(4)
    )
    if corrupted <= 0:
        failures.append("net_frames_corrupted_total never moved")
    fault_kinds = {
        key.split(":", 1)[1] for key in doctor["faults"]
    }
    forbidden = fault_kinds - {"suspicion_vote", "peer_unreachable"}
    if forbidden:
        failures.append(
            "corruption leaked past the framing layer: "
            f"{sorted(forbidden)} (CRC must reject before the protocol "
            "ever sees a damaged byte)"
        )
    _check_anomalies(
        failures, doctor, range(4),
        {"peer_fault", "watermark_stall", "checkpoint_stagnation",
         "epoch_thrash"},
    )
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    return _verdict(root, "lossy-wan", res, failures)


def _scenario_byzantine_leader(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """The current primary actively lies (the genesis epoch activates as
    epoch 1, primary node 1): every epoch-1 Preprepare it sends is
    rewritten with a different protocol-invalid batch per destination
    (equivocation), and its Suspect/EpochChange messages are replayed
    stale.  Honest nodes must demote it — Suspect + attribution, never a
    crash — move to a new epoch, and commit everything with bit-identical
    logs; nothing poisoned can ever reach quorum because no two honest
    nodes even saw the same lie."""
    from mirbft_tpu_torch.net.byzantine import ByzantineBehaviors

    byz, honest = 1, [0, 2, 3]
    behaviors = ByzantineBehaviors(
        equivocate_epoch=1,
        replay_kinds=("Suspect", "EpochChange"),
        replay_ms=150.0,
        replay_copies=2,
    )
    with _Cluster(
        root,
        seed=seed,
        node_config=dict(_VIEWCHANGE_CONFIG),
        byzantine={byz: behaviors.as_dict()},
        timeout_s=60.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        cluster.submit(0, 6, timeout_s=60.0)
        cluster.wait_commits(6, quorum=3, node_ids=honest, timeout_s=60.0)
        cluster.wait_commits(6, quorum=4, timeout_s=60.0)
        res = cluster.judge()

    failures: List[str] = []
    doctor = res["doctor"]
    byz_injected = res["injected"].get(byz, {})
    if byz_injected.get("equivocate", 0) <= 0:
        failures.append("byzantine node never equivocated")
    if byz_injected.get("replay", 0) <= 0:
        failures.append("byzantine node never replayed a stale message")
    suspecting = sum(
        1
        for i in honest
        if doctor["per_node"][i]["faults"].get(f"{byz}:suspicion_vote", 0) > 0
    )
    if suspecting < 2:
        failures.append(
            f"only {suspecting} honest nodes attributed suspicion_vote to "
            f"the byzantine leader {byz}"
        )
    for i in honest:
        if doctor["per_node"][i]["max_epoch"] < 2:
            failures.append(f"honest node {i} never left the poisoned epoch")
        innocent = {
            key
            for key in doctor["per_node"][i]["faults"]
            if not key.startswith(f"{byz}:")
            and not key.endswith(":suspicion_vote")
        }
        if innocent:
            failures.append(
                f"honest node {i} blamed an innocent peer: {sorted(innocent)}"
            )
    _check_anomalies(
        failures, doctor, honest,
        {"peer_fault", "epoch_thrash", "watermark_stall",
         "checkpoint_stagnation"},
    )
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    return _verdict(root, "byzantine-leader", res, failures)


def _scenario_rolling_kill(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """Soak: SIGKILL each non-zero node in turn, wait for the survivors to
    attribute the outage, restart it from its durable stores, and keep
    committing.  Every victim must be attributed ``peer_unreachable``;
    suspicion votes are legitimate recovery (a kill drops in-flight
    frames, and only a view change can refill the gap); torn event logs
    from the SIGKILLs are tolerated by the doctor, never fatal."""
    with _Cluster(
        root,
        seed=seed,
        node_config=dict(_VIEWCHANGE_CONFIG),
        unreachable_after_s=0.6,
        timeout_s=60.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        cluster.submit(0, 2)
        cluster.wait_commits(2, quorum=4)
        reqs = 2
        for victim in (1, 2, 3):
            survivors = [i for i in range(4) if i != victim]
            cluster.kill(victim)
            cluster.wait_fault(survivors, victim, "peer_unreachable",
                               timeout_s=25.0)
            cluster.restart(victim)
            cluster.submit(reqs, reqs + 2, timeout_s=60.0)
            reqs += 2
            # Any rebooted node may have state-transferred over reqs it
            # missed while down, so each cycle only demands its own
            # requests of the survivors; the fresh victim proves rejoin
            # by committing past their head.
            cluster.wait_commits(reqs, quorum=3, node_ids=survivors,
                                 timeout_s=60.0, first_req=reqs - 2)
            cluster.wait_rejoin(
                victim, max(cluster.last_seq(i) for i in survivors)
            )
        res = cluster.judge()

    failures: List[str] = []
    doctor = res["doctor"]
    for victim in (1, 2, 3):
        if doctor["faults"].get(f"{victim}:peer_unreachable", 0) <= 0:
            failures.append(
                f"victim {victim} was never attributed peer_unreachable"
            )
        if doctor["per_node"][victim]["boots"] < 2:
            failures.append(
                f"victim {victim} recorded "
                f"{doctor['per_node'][victim]['boots']} boots, expected >= 2"
            )
    fault_kinds = {key.split(":", 1)[1] for key in doctor["faults"]}
    if fault_kinds - {"peer_unreachable", "suspicion_vote"}:
        failures.append(
            f"rolling kills attributed unexpected kinds: {sorted(fault_kinds)}"
        )
    _check_anomalies(
        failures, doctor, range(4),
        {"peer_fault", "watermark_stall", "epoch_thrash",
         "checkpoint_stagnation"},
    )
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    return _verdict(root, "rolling-kill", res, failures)


def _scenario_kill_under_write(root: Path, seed: int, *, pipeline: bool = True) -> dict:
    """Crash-recovery drill for the storage engine: SIGKILL one node under
    sustained client write load, have the survivors commit far past what
    the victim's WAL can replay (multiple checkpoint intervals), restart
    it, and require it to rejoin **via snapshot state transfer fetched
    over KIND_SNAPSHOT frames** — proven by a nonzero
    ``snapshot_transfer_bytes_total`` on the victim — with seq-keyed
    bit-identical commit logs across all four nodes."""
    victim = 3
    survivors = [0, 1, 2]
    # checkpoint_interval is 5·N = 20 for 4 nodes; pushing the survivors
    # ≥ 2 intervals past the victim's crash head guarantees its replayed
    # log ends below the cluster's stable checkpoint, forcing transfer.
    outrun_seqs = 45
    with _Cluster(
        root,
        seed=seed,
        node_config=dict(_VIEWCHANGE_CONFIG),
        unreachable_after_s=0.6,
        timeout_s=120.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        # Warm up with the full cluster so the victim dies with real
        # committed state in its WAL, not a fresh directory.
        cluster.submit(0, 4)
        cluster.wait_commits(4, quorum=4)

        # Sustained write load against the survivors only (the victim is
        # about to die; a connection to it would only buy retry latency).
        stop_load = threading.Event()
        progress = {"submitted": 4}
        load_errors: List[str] = []

        def load() -> None:
            clients = {
                i: SocketClient(("127.0.0.1", cluster.ports[i]))
                for i in survivors
            }
            try:
                req_no = 4
                while not stop_load.is_set():
                    data = b"mirnet-%d" % req_no
                    for client in clients.values():
                        while not client.submit(req_no, data):
                            if stop_load.is_set():
                                return
                            time.sleep(0.05)
                    req_no += 1
                    progress["submitted"] = req_no
            except (ConnectionError, OSError) as err:
                load_errors.append(f"load generator died: {err!r}")
            finally:
                for client in clients.values():
                    client.close()

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        try:
            time.sleep(0.5)  # the SIGKILL lands mid-write, not in a lull
            head_kill = max(cluster.last_seq(i) for i in survivors)
            cluster.kill(victim)
            cluster.wait_fault(survivors, victim, "peer_unreachable",
                               timeout_s=25.0)

            target = head_kill + outrun_seqs
            deadline = time.monotonic() + 120.0
            while min(cluster.last_seq(i) for i in survivors) < target:
                if load_errors or time.monotonic() > deadline:
                    raise TimeoutError(
                        f"survivors never outran the victim to seq {target} "
                        f"(heads: "
                        f"{[cluster.last_seq(i) for i in survivors]}, "
                        f"load errors: {load_errors})"
                    )
                time.sleep(0.2)

            cluster.restart(victim)
            rejoin_head = max(cluster.last_seq(i) for i in survivors)
            # Keep writing while the victim catches up: checkpoint
            # traffic is what tells it how far behind it is.
            cluster.wait_rejoin(victim, rejoin_head, timeout_s=60.0)
        finally:
            stop_load.set()
            loader.join(timeout=30)

        submitted = progress["submitted"]
        cluster.wait_commits(submitted, quorum=3, node_ids=survivors,
                             timeout_s=120.0)
        res = cluster.judge()
        transfer_bytes = _metric_value(
            cluster.root, victim, "snapshot_transfer_bytes_total"
        )

    failures: List[str] = list(load_errors)
    doctor = res["doctor"]
    if transfer_bytes <= 0:
        failures.append(
            "victim rejoined without fetching a snapshot over the socket "
            "plane (snapshot_transfer_bytes_total == 0)"
        )
    if doctor["faults"].get(f"{victim}:peer_unreachable", 0) <= 0:
        failures.append("victim was never attributed peer_unreachable")
    if doctor["per_node"][victim]["boots"] < 2:
        failures.append(
            f"victim recorded {doctor['per_node'][victim]['boots']} boots, "
            f"expected >= 2"
        )
    fault_kinds = {key.split(":", 1)[1] for key in doctor["faults"]}
    if fault_kinds - {"peer_unreachable", "suspicion_vote"}:
        failures.append(
            f"kill-under-write attributed unexpected kinds: "
            f"{sorted(fault_kinds)}"
        )
    _check_anomalies(
        failures, doctor, range(4),
        {"peer_fault", "watermark_stall", "epoch_thrash",
         "checkpoint_stagnation"},
    )
    if res["agreement_problems"]:
        failures.append("; ".join(res["agreement_problems"]))
    verdict = _verdict(root, "kill-under-write", res, failures)
    verdict["snapshot_transfer_bytes"] = transfer_bytes
    return verdict


def _scenario_cross_group_partition(
    root: Path, seed: int, *, pipeline: bool = True
) -> dict:
    """Blast-radius isolation across groups: partition one node of group
    0 (a 2-node group needs both members for quorum, so group 0's commit
    head freezes) and prove group 1 keeps committing *throughout* the
    window — its head must advance across repeated samples while group
    0's stands still — then heal and require group 0 to resume.  Judged
    per group: the unpartitioned group's doctor must be clean; the
    partitioned group may attribute exactly the injected outage."""
    groups, npg = 2, 2
    with _ShardedCluster(
        root,
        groups=groups,
        nodes_per_group=npg,
        seed=seed,
        faults=True,
        record_events=True,
        node_config=dict(_VIEWCHANGE_CONFIG),
        unreachable_after_s=0.8,
        timeout_s=90.0,
        pipeline=pipeline,
    ) as cluster:
        cluster.start()
        client = _connect_routed(cluster.map.members(0)[0], 60.0)
        samples: List[dict] = []
        try:
            for g in range(groups):
                cluster.submit_group(g, 0, 3, client=client)
            for g in range(groups):
                cluster.wait_commits(g, 3)

            cluster.partition_group(0, {1})
            time.sleep(1.0)  # drain in-flight commits before the baseline
            frozen = cluster.head(0)
            advancing = 0
            prev = cluster.head(1)
            for step in range(4):
                cluster.submit_group(
                    1, 3 + step, 4 + step, client=client
                )
                cluster.wait_commits(
                    1, 4 + step, first_req=3 + step, timeout_s=30.0
                )
                cur = cluster.head(1)
                if cur > prev:
                    advancing += 1
                prev = cur
                samples.append(
                    {"group0": cluster.head(0), "group1": cur}
                )
            frozen_after = cluster.head(0)

            cluster.heal_group(0)
            time.sleep(1.0)  # let reconnects land before fresh traffic
            cluster.submit_group(0, 3, 5, client=client, timeout_s=60.0)
            cluster.wait_commits(0, 5, first_req=3, timeout_s=60.0)
            resumed = cluster.head(0)
        finally:
            client.close()
        cluster.stop_all()

        from mirbft_tpu_torch.tools.mircat import doctor_deployment

        doctors = {
            g: doctor_deployment(_group_dir(cluster.root, g))
            for g in range(groups)
        }
        agreement = {
            g: _agreement_by_seq(_group_dir(cluster.root, g),
                                 list(range(npg)))
            for g in range(groups)
        }

    failures: List[str] = []
    if advancing < 3:
        failures.append(
            f"group 1's head advanced in only {advancing}/4 windows while "
            f"group 0 was partitioned: {samples}"
        )
    if frozen_after > frozen + 1:
        failures.append(
            f"partitioned group 0 kept committing ({frozen} -> "
            f"{frozen_after}) with its quorum cut"
        )
    if resumed <= frozen_after:
        failures.append(
            f"group 0 never resumed after the heal (head {resumed})"
        )
    clean = doctors[1]
    if not clean["healthy"]:
        failures.append(
            f"unpartitioned group 1 doctor unhealthy: "
            f"faults={clean['faults']} anomalies={clean['anomaly_count']}"
        )
    hurt_kinds = {
        key.split(":", 1)[1] for key in doctors[0]["faults"]
    }
    if hurt_kinds - {"peer_unreachable", "suspicion_vote"}:
        failures.append(
            f"group 0 attributed unexpected fault kinds: "
            f"{sorted(hurt_kinds)}"
        )
    for g in range(groups):
        if agreement[g]:
            failures.append(f"group {g}: " + "; ".join(agreement[g]))
    res = {
        "samples": samples,
        "frozen_head": frozen,
        "advancing_windows": advancing,
        "resumed_head": resumed,
        "doctor": doctors,
    }
    return _verdict(root, "cross-group-partition", res, failures)


# --------------------------------------------------------------------------
# Elastic resharding choreography (docs/SHARDING.md "Elastic resharding")
# --------------------------------------------------------------------------


def _group_rpc(addr: Tuple[str, int], payload: bytes,
               timeout_s: float = 10.0) -> bytes:
    """One KIND_GROUP request/reply round trip against a group member."""
    from mirbft_tpu_torch.net.framing import KIND_GROUP, FrameDecoder, encode_frame

    with socket.create_connection(addr, timeout=timeout_s) as sock:
        sock.settimeout(timeout_s)
        sock.sendall(encode_frame(KIND_GROUP, payload))
        decoder = FrameDecoder()
        while True:
            data = sock.recv(65536)
            if not data:
                raise ConnectionError(f"{addr} closed before replying")
            for kind, reply in decoder.feed(data):
                if kind == KIND_GROUP:
                    return reply


def _stage_plan(members: List[Tuple[str, int]], plan) -> None:
    """Stage one ReshardPlan on *every* member before its marker is
    submitted — the plan carries the cutover semantics (batches circulate
    as digests), so a member without it could not act on the marker.
    Raises if any member rejects the plan."""
    from mirbft_tpu_torch.groups import ship

    payload = ship.encode_reshard_plan(
        plan.group_id, plan.marker_req_no, plan.to_json_bytes()
    )
    for addr in members:
        subtype, _g, _s, body = ship.decode(_group_rpc(addr, payload))
        doc = json.loads(body.decode())
        if subtype != ship.RESHARD_STATE or doc.get("error"):
            raise RuntimeError(f"{addr} rejected reshard plan: {doc}")


def _reshard_state(addr: Tuple[str, int], group_id: int) -> dict:
    from mirbft_tpu_torch.groups import ship

    reply = _group_rpc(addr, ship.encode_reshard_query(group_id))
    _sub, _g, _s, body = ship.decode(reply)
    return json.loads(body.decode())


def _submit_control(addr: Tuple[str, int], group_id: int, req_no: int,
                    timeout_s: float = 30.0) -> None:
    """Commit one request of the reserved control client on ``group_id``
    via ``addr`` (cutover markers and the drain pump).  Control requests
    are addressed by the envelope group and exempt from client-routing,
    so they land exactly where the harness points them."""
    from mirbft_tpu_torch.net.framing import (
        KIND_CLIENT,
        FrameDecoder,
        encode_client_envelope,
        encode_frame,
    )

    body = _CLIENT_REQ.pack(req_no) + b"reshard-marker"
    frame = encode_frame(
        KIND_CLIENT,
        encode_client_envelope(
            group_id, body, client_id=RESHARD_CONTROL_CLIENT
        ),
    )
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(addr, timeout=10.0) as sock:
                sock.settimeout(10.0)
                sock.sendall(frame)
                decoder = FrameDecoder()
                status = b""
                while not status:
                    data = sock.recv(65536)
                    if not data:
                        raise ConnectionError("closed mid-reply")
                    for kind, payload in decoder.feed(data):
                        if kind == KIND_CLIENT:
                            status = payload[:1]
                            break
            if status == CLIENT_OK:
                return
        except (OSError, ConnectionError):
            pass
        time.sleep(0.2)
    raise TimeoutError(
        f"group {group_id} never accepted control request {req_no}"
    )


def _wait_reshard_done(addr: Tuple[str, int], group_id: int,
                       timeout_s: float = 90.0,
                       pump_next_ctrl: Optional[int] = None) -> dict:
    """Poll RESHARD_QUERY until the coordinator reports DONE; returns the
    final state document.  ``pump_next_ctrl`` drives the group's sequence
    space forward with control-client commits — a *drained* group has no
    organic traffic left, and reconfigurations only apply at checkpoint
    boundaries, so someone must keep the log moving."""
    from mirbft_tpu_torch.groups import reshard as reshard_mod

    deadline = time.monotonic() + timeout_s
    ctrl = pump_next_ctrl
    last: dict = {}
    while time.monotonic() < deadline:
        try:
            last = _reshard_state(addr, group_id)
        except (OSError, ConnectionError):
            time.sleep(0.2)
            continue
        if last.get("phase") == reshard_mod.DONE:
            return last
        if ctrl is not None:
            _submit_control(addr, group_id, ctrl, timeout_s=10.0)
            ctrl += 1
        time.sleep(0.2)
    raise TimeoutError(f"group {group_id} reshard stuck at {last}")


def _client_with_residue(modulus: int, residue: int, avoid=(),
                         start: int = 1) -> int:
    """Smallest client id >= ``start`` whose routing hash has the given
    residue — how the scenarios pick the "staying" and "moved" clients of
    a split of the dense ``(2, 1)`` route into ``(4, 1)`` + ``(4, 3)``."""
    cid = start
    while client_hash(cid) % modulus != residue or cid in avoid:
        cid += 1
        if cid - start > 200_000:
            raise RuntimeError(
                f"no client id with hash residue {residue} (mod {modulus})"
            )
    return cid


class _ReshardLoad(threading.Thread):
    """One client's continuous, strictly sequential submission stream,
    kept running *across* cutovers.  Redirect chases, BUSY backpressure,
    refused stale-map downgrades, and connection failures (mid-split the
    child group's members are not even listening yet) are all survivable:
    the thread retries the same req_no until it acks, so ``acked`` is the
    exactly-once floor the verdict checks against."""

    def __init__(self, group_map: GroupMap, client_id: int,
                 stop: threading.Event, pace_s: float = 0.02):
        super().__init__(daemon=True)
        self.client_id = client_id
        self._halt = stop
        self.pace_s = pace_s
        self.client = RoutedClient(group_map=group_map)
        self.acked = 0
        self.errors = 0

    def run(self) -> None:
        req_no = 0
        while not self._halt.is_set():
            try:
                ok = self.client.submit(
                    self.client_id, req_no, b"reshard-%d" % req_no
                )
            except (OSError, ConnectionError):
                self.errors += 1
                time.sleep(0.1)
                continue
            if ok:
                req_no += 1
                self.acked = req_no
                time.sleep(self.pace_s)
            else:
                time.sleep(0.05)
        self.client.close()


def _wait_load(threads, target: int, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(t.acked >= target for t in threads):
            return
        time.sleep(0.1)
    raise TimeoutError(
        "load threads stuck: " + ", ".join(
            f"client {t.client_id}: {t.acked}/{target} "
            f"(errors {t.errors})"
            for t in threads
        )
    )


def _wait_client_commits(gdir: Path, node_ids, client_id: int, reqs,
                         timeout_s: float) -> None:
    """Block until every node in ``node_ids`` has committed all of
    ``reqs`` for ``client_id``."""
    from mirbft_tpu_torch.groups import reshard as reshard_mod

    want = set(reqs)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(
            want <= reshard_mod.committed_requests_of(
                _read_commits(gdir, i), client_id
            )
            for i in node_ids
        ):
            return
        time.sleep(0.2)
    raise TimeoutError(
        f"client {client_id} requests never all committed in {gdir}"
    )


def _observer_backlog_problems(root: Path, group_id: int, obs_idx: int,
                               moved: int, parent_lines: List[str],
                               ceiling: int) -> List[str]:
    """Bootstrap-observer identity check: every commit line the observer
    holds must be byte-identical to the parent's at the same sequence,
    and from its first applied sequence up to ``ceiling`` (the split
    cutover checkpoint it was confirmed synced through before being
    promoted) it must hold *every* parent line carrying the moved client
    (its half of the backlog).  The ceiling matters in the merge run:
    the moved client re-enters the parent long after the observers were
    promoted away, and those later commits are not backlog."""
    from mirbft_tpu_torch.groups import reshard as reshard_mod

    obs_path = _observer_dir(root, group_id, obs_idx) / "commits.log"
    obs_lines = (
        [ln for ln in obs_path.read_text().splitlines() if ln]
        if obs_path.exists()
        else []
    )
    if not obs_lines:
        return [f"observer {obs_idx} applied nothing"]
    problems: List[str] = []
    by_seq = {int(ln.split(" ", 1)[0]): ln for ln in parent_lines}
    floor = int(obs_lines[0].split(" ", 1)[0])
    for line in obs_lines:
        seq = int(line.split(" ", 1)[0])
        if by_seq.get(seq) != line:
            problems.append(
                f"observer {obs_idx} diverges from parent at seq {seq}"
            )
    have = {
        (reshard_mod.parse_commit_line(ln)[0], rno)
        for ln in obs_lines
        for cid, rno in reshard_mod.parse_commit_line(ln)[1]
        if cid == moved
    }
    missing = {
        (seq, rno)
        for ln in parent_lines
        for seq, pairs in [reshard_mod.parse_commit_line(ln)]
        for cid, rno in pairs
        if cid == moved and floor <= seq <= ceiling
    } - have
    if missing:
        problems.append(
            f"observer {obs_idx} backlog misses moved-client commits "
            f"{sorted(missing)[:8]}"
        )
    return problems


def _run_reshard(root: Path, seed: int, *, pipeline: bool = True,
                 merge: bool = False) -> dict:
    """Shared split(+merge) choreography.  Split: group 1's dense
    ``(2, 1)`` route refines into parent ``(4, 1)`` + child group 3 at
    ``(4, 3)``; the child's members bootstrap as observers of the parent,
    the parent commits the marker, and the moved client's stream heals
    onto the child with requests below the transfer watermark deduped.
    Merge reverses it: the child drains the client back behind a second
    marker and the parent re-admits it at the child's watermark —
    crossing a deliberate stale-redirect window while the parent still
    serves the older map."""
    from mirbft_tpu_torch.config import DEFAULT_CLIENT_WIDTH
    from mirbft_tpu_torch.groups import reshard as reshard_mod
    from mirbft_tpu_torch.tools.mircat import doctor_deployment

    groups, npg = 2, 2
    ci = 5 * npg  # standard_initial_network_state checkpoint interval
    parent, child = 1, 3  # child id skips 2: exercises sparse group ids
    staying = _client_with_residue(4, 1)
    moved = _client_with_residue(4, 3, avoid={staying})
    name = "reshard-merge" if merge else "reshard-split"
    res: dict = {
        "staying_client": staying,
        "moved_client": moved,
    }
    failures: List[str] = []
    with _ShardedCluster(
        root,
        groups=groups,
        nodes_per_group=npg,
        seed=seed,
        record_events=True,
        timeout_s=120.0,
        pipeline=pipeline,
        extra_clients={parent: [staying, moved]},
    ) as cluster:
        cluster.start()
        home0 = cluster.client_ids[0]
        parent_members = cluster.map.members(parent)
        _connect_routed(cluster.map.members(0)[0], 60.0).close()
        # Child members bootstrap as observers of the parent over the
        # ship feed + KIND_SNAPSHOT plane — spawned before any load so
        # their committed prefix starts at genesis.
        cluster.spawn_observer(parent, 0)
        cluster.spawn_observer(parent, 1)

        stop = threading.Event()
        loads = {
            "home0": _ReshardLoad(cluster.map, home0, stop),
            "staying": _ReshardLoad(cluster.map, staying, stop),
            "moved": _ReshardLoad(cluster.map, moved, stop),
        }
        try:
            for t in loads.values():
                t.start()
            _wait_load(loads.values(), 5, timeout_s=90.0)

            # --- split ---
            child_ports = _reserve_ports(npg)
            child_members = [("127.0.0.1", p) for p in child_ports]
            v1 = cluster.map.split_group(parent, child, child_members)
            v1_doc = json.loads(v1.to_json_bytes().decode())
            split_plan = reshard_mod.ReshardPlan(
                plan_id=f"split-{seed}",
                action=reshard_mod.ACTION_SPLIT,
                group_id=parent,
                moved_client=moved,
                moved_client_width=DEFAULT_CLIENT_WIDTH,
                map_doc=v1_doc,
                marker_req_no=0,
            )
            _stage_plan(parent_members, split_plan)
            head0_at_marker = cluster.head(0)
            _submit_control(parent_members[0], parent, 0)
            split_state = _wait_reshard_done(parent_members[0], parent)
            head0_at_done = cluster.head(0)

            # The parent's moved-client commits are final once the
            # removal applied; sync the bootstrapping observers past the
            # reconfiguration checkpoint, then promote them: stop the
            # learners and boot the child group's voters on the
            # pre-reserved addresses the v1 map already names.
            for k in (0, 1):
                wait_observer_synced(
                    root, parent, k, split_state["cutover_seq"],
                    timeout_s=60.0,
                )
                proc = cluster.procs.pop(("obs", parent, k))
                proc.terminate()
                proc.wait(timeout=15)
            parent_lines_mid = _read_commits(_group_dir(root, parent), 0)
            w0 = reshard_mod.low_watermark_after(parent_lines_mid, moved)
            backlog = reshard_mod.backlog_lines(parent_lines_mid, moved)
            child_gdir = _group_dir(root, child)
            child_gdir.mkdir(parents=True, exist_ok=True)
            (child_gdir / "backlog.log").write_text(
                "".join(line + "\n" for line in backlog)
            )
            cluster.add_group(
                child,
                child_ports,
                [moved, RESHARD_CONTROL_CLIENT],
                v1_doc,
                client_watermarks={moved: w0},
            )
            moved_at_cutover = loads["moved"].acked
            _wait_load([loads["moved"]], moved_at_cutover + 5,
                       timeout_s=90.0)
            base = {k: t.acked for k, t in loads.items()}
            _wait_load(loads.values(), max(base.values()) + 3,
                       timeout_s=90.0)
            res.update(
                w0=w0,
                split_state=split_state,
                moved_at_cutover=moved_at_cutover,
                head0_at_marker=head0_at_marker,
                head0_at_done=head0_at_done,
            )

            if merge:
                # --- merge: drain the child back into the parent ---
                v2 = v1.merge_group(child, parent)
                v2_doc = json.loads(v2.to_json_bytes().decode())
                drain_plan = reshard_mod.ReshardPlan(
                    plan_id=f"drain-{seed}",
                    action=reshard_mod.ACTION_MERGE_DRAIN,
                    group_id=child,
                    moved_client=moved,
                    moved_client_width=DEFAULT_CLIENT_WIDTH,
                    map_doc=v2_doc,
                    marker_req_no=0,
                )
                _stage_plan(child_members, drain_plan)
                _submit_control(child_members[0], child, 0)
                drain_state = _wait_reshard_done(
                    child_members[0], child, pump_next_ctrl=1
                )
                # Deliberate stale-redirect window: the parent still
                # serves map v1 and redirects the moved client with it;
                # the router must refuse the downgrade (and count it)
                # rather than bounce between epochs.
                time.sleep(1.5)
                w1 = reshard_mod.low_watermark_after(
                    _read_commits(child_gdir, 0), moved
                )
                merge_plan = reshard_mod.ReshardPlan(
                    plan_id=f"merge-{seed}",
                    action=reshard_mod.ACTION_MERGE_COMMIT,
                    group_id=parent,
                    moved_client=moved,
                    moved_client_width=DEFAULT_CLIENT_WIDTH,
                    map_doc=v2_doc,
                    marker_req_no=1,
                    low_watermark=w1,
                )
                _stage_plan(parent_members, merge_plan)
                _submit_control(parent_members[0], parent, 1)
                merge_state = _wait_reshard_done(
                    parent_members[0], parent
                )
                moved_at_merge = loads["moved"].acked
                _wait_load([loads["moved"]], moved_at_merge + 3,
                           timeout_s=90.0)
                final_client = _connect_routed(parent_members[0], 30.0)
                final_map = final_client.map
                final_client.close()
                res.update(
                    w1=w1,
                    drain_state=drain_state,
                    merge_state=merge_state,
                    stale_redirects=loads["moved"].client.stale_redirects,
                    final_map_version=final_map.map_version,
                    final_routes={
                        g: list(r) for g, r in final_map.routes.items()
                    },
                    final_addrs_match=(
                        final_map.addrs
                        == {g: cluster.map.addrs[g] for g in (0, 1)}
                    ),
                )
        finally:
            stop.set()
            for t in loads.values():
                t.join(timeout=30.0)
        totals = {k: t.acked for k, t in loads.items()}
        res["acked"] = totals

        # Everything acked must land on disk before judging.
        _wait_client_commits(
            _group_dir(root, 0), range(npg), home0,
            range(totals["home0"]), timeout_s=60.0,
        )
        _wait_client_commits(
            _group_dir(root, parent), range(npg), staying,
            range(totals["staying"]), timeout_s=60.0,
        )
        moved_home = _group_dir(root, parent if merge else child)
        _wait_client_commits(
            moved_home, range(npg), moved,
            range(res["w1"] if merge else w0, totals["moved"]),
            timeout_s=60.0,
        )
        cluster.stop_all()

        # --- judgement ---
        parent_lines = _read_commits(_group_dir(root, parent), 0)
        child_lines = _read_commits(child_gdir, 0)
        group0_lines = _read_commits(_group_dir(root, 0), 0)
        parent_moved = reshard_mod.committed_requests_of(
            parent_lines, moved
        )
        child_moved = reshard_mod.committed_requests_of(
            child_lines, moved
        )
        union = parent_moved | child_moved
        n_top = (max(union) + 1) if union else 0
        res["moved_committed"] = {
            "parent": len(parent_moved),
            "child": len(child_moved),
        }
        if parent_moved & child_moved:
            failures.append(
                f"moved client committed twice: "
                f"{sorted(parent_moved & child_moved)[:8]}"
            )
        if not union >= set(range(totals["moved"])):
            failures.append(
                f"moved client lost acked requests: "
                f"{sorted(set(range(totals['moved'])) - union)[:8]}"
            )
        if union != set(range(n_top)):
            failures.append(
                f"moved client commit range has gaps: "
                f"{sorted(set(range(n_top)) - union)[:8]}"
            )
        if merge:
            w1 = res["w1"]
            if child_moved != set(range(w0, w1)):
                failures.append(
                    f"child committed outside its [{w0}, {w1}) span"
                )
            expect_parent = set(range(w0)) | set(range(w1, n_top))
            if parent_moved != expect_parent:
                failures.append(
                    f"parent moved-client commits not "
                    f"[0, {w0}) + [{w1}, {n_top})"
                )
            if res["stale_redirects"] < 1:
                failures.append(
                    "moved client never saw a refused stale-map redirect "
                    "across the merge window"
                )
            if res["final_map_version"] != 2:
                failures.append(
                    f"final map version {res['final_map_version']}, "
                    f"expected 2"
                )
            # Pre-split routes restored (modulo map_version): the same
            # two groups, the same members, the dense route shape.
            if res["final_routes"] != {0: [2, 0], 1: [2, 1]}:
                failures.append(
                    f"merge did not restore the dense routes: "
                    f"{res['final_routes']}"
                )
            if not res["final_addrs_match"]:
                failures.append(
                    "merge did not restore the pre-split membership"
                )
            state2 = merge_state
            if (
                state2["cutover_seq"] - state2["marker_seq"] > 2 * ci
            ):
                failures.append(
                    f"merge cutover stalled the parent "
                    f"{state2['cutover_seq'] - state2['marker_seq']} seqs "
                    f"(> {2 * ci})"
                )
        else:
            if parent_moved != set(range(w0)):
                failures.append(
                    f"parent moved-client commits not exactly [0, {w0})"
                )
            if child_moved and min(child_moved) < w0:
                failures.append(
                    f"child committed below the watermark {w0}"
                )
        if reshard_mod.committed_requests_of(child_lines, staying):
            failures.append("staying client leaked into the child group")
        if reshard_mod.committed_requests_of(group0_lines, moved):
            failures.append("moved client leaked into group 0")
        state1 = split_state
        if state1["cutover_seq"] - state1["marker_seq"] > 2 * ci:
            failures.append(
                f"split cutover stalled the parent "
                f"{state1['cutover_seq'] - state1['marker_seq']} seqs "
                f"(> {2 * ci})"
            )
        if head0_at_done <= head0_at_marker:
            failures.append(
                "group 0's head stood still across the split cutover "
                f"({head0_at_marker} -> {head0_at_done})"
            )
        for g in (0, parent, child):
            problems = _agreement_by_seq(
                _group_dir(root, g), list(range(npg))
            )
            if problems:
                failures.append(f"group {g}: " + "; ".join(problems))
        for k in (0, 1):
            for problem in _observer_backlog_problems(
                root, parent, k, moved, parent_lines,
                split_state["cutover_seq"]
            ):
                failures.append(problem)
        doctors = {
            g: doctor_deployment(_group_dir(root, g))
            for g in (0, parent, child)
        }
        res["doctor"] = {
            g: {"healthy": d["healthy"], "faults": d["faults"]}
            for g, d in doctors.items()
        }
        # A cutover ends the epoch at the reconfiguration checkpoint
        # (machine._complete_pending_reconfiguration): every tracker
        # reinitializes and the epoch-tracker's resume path deliberately
        # self-suspects, so the doctor attributes ``suspicion_vote`` to
        # the epoch primary and may log a transient ``watermark_stall``
        # in the groups that cut over.  Tolerate exactly those kinds
        # there — the sequence-space stall bound above already caps the
        # pause — and hold every uninvolved group to strict health
        # ("zero stall in uninvolved groups").
        cutover_groups = {parent, child} if merge else {parent}
        for g, d in doctors.items():
            if d["healthy"]:
                continue
            if g in cutover_groups:
                kinds = {k.split(":", 1)[1] for k in d["faults"]}
                anomalies = {
                    kind
                    for node in d["per_node"].values()
                    for kind in node["anomaly_kinds"]
                }
                if not kinds - {"suspicion_vote"} and not anomalies - {
                    "peer_fault",
                    "watermark_stall",
                }:
                    continue
            failures.append(
                f"group {g} doctor unhealthy: faults={d['faults']} "
                f"anomalies={d['anomaly_count']}"
            )
        want_version = 2 if merge else 1
        res["metrics"] = {
            "parent_map_version": cluster.group_metric(
                parent, "map_version"
            ),
            "parent_reshard_state": cluster.group_metric(
                parent, "reshard_state"
            ),
            "parent_cutover_seconds": cluster.group_metric(
                parent, "reshard_cutover_seconds"
            ),
            "child_map_version": cluster.group_metric(
                child, "map_version"
            ),
        }
        if res["metrics"]["parent_map_version"] != npg * want_version:
            failures.append(
                f"parent map_version gauges sum to "
                f"{res['metrics']['parent_map_version']}, expected "
                f"{npg * want_version}"
            )
        if res["metrics"]["parent_cutover_seconds"] <= 0:
            failures.append("reshard_cutover_seconds never observed")
    return _verdict(root, name, res, failures)


def _scenario_reshard_split(root: Path, seed: int, *,
                            pipeline: bool = True) -> dict:
    """Live split: group 1 sheds its ``(4, 3)`` residue clients to a new
    group 3 bootstrapped from observers, behind a consensus-ordered
    cutover marker — clients keep submitting throughout; judged on
    exactly-once across the cutover, byte-identical logs within every
    group, a bounded parent stall, and an untouched group 0."""
    return _run_reshard(root, seed, pipeline=pipeline, merge=False)


def _scenario_reshard_merge(root: Path, seed: int, *,
                            pipeline: bool = True) -> dict:
    """Split, then merge back: the child drains the moved client behind
    its own marker, the parent re-admits it at the child's watermark, and
    the fleet returns to the pre-split routes (modulo ``map_version``) —
    with the moved client deliberately crossing a stale-redirect window
    that the router must refuse to downgrade through."""
    return _run_reshard(root, seed, pipeline=pipeline, merge=True)


SCENARIOS = {
    "control": _scenario_control,
    "cross-group-partition": _scenario_cross_group_partition,
    "partition-minority": _scenario_partition_minority,
    "partition-leader": _scenario_partition_leader,
    "flap": _scenario_flap,
    "lossy-wan": _scenario_lossy_wan,
    "byzantine-leader": _scenario_byzantine_leader,
    "rolling-kill": _scenario_rolling_kill,
    "kill-under-write": _scenario_kill_under_write,
    "reshard-split": _scenario_reshard_split,
    "reshard-merge": _scenario_reshard_merge,
}


def run_scenario(name: str, root_dir: Optional[str] = None,
                 seed: int = 7, pipeline: bool = True) -> dict:
    """Run one choreographed fault scenario; returns the verdict document
    (also written to ``<dir>/scenario.json``) or raises AssertionError
    listing every failed check.  ``pipeline=True`` runs every node on the
    staged pipeline scheduler instead of the classic depth-1 schedule."""
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r} "
            f"(have: {', '.join(sorted(SCENARIOS))})"
        )
    if root_dir is None:
        root_dir = tempfile.mkdtemp(prefix=f"mirnet-{name}-")
    return SCENARIOS[name](Path(root_dir), seed, pipeline=pipeline)


def _resolve_fleet_dir(path) -> Path:
    """Accept either the deployment root or the ``fleet/`` dir itself."""
    root = Path(path)
    if (root / "fleet" / "latest.json").exists():
        return root / "fleet"
    return root


def render_top(fleet_dir) -> str:
    """One ``--top`` screen: the cross-group SLO table, per-node vitals,
    and any trend findings, from the collector's rolling output."""
    from mirbft_tpu_torch import fleet as fleet_mod

    doc = fleet_mod.load_fleet(fleet_dir)
    lines = [f"mirnet --top  {fleet_dir}  {time.strftime('%H:%M:%S')}"]
    rows = fleet_mod.slo_rows(doc["history"])
    if rows:
        lines.append(
            f"{'group':>5} {'p50 ms':>8} {'p99 ms':>8} {'obs lag':>8} "
            f"{'stall p99':>10} {'lock p99':>10} {'fsync %':>8}"
        )
        for row in rows:
            def fmt(v):
                return "-" if v is None else f"{v:g}"
            lines.append(
                f"{row['group']:>5} {fmt(row['commit_p50_ms']):>8} "
                f"{fmt(row['commit_p99_ms']):>8} "
                f"{fmt(row['observer_lag']):>8} "
                f"{fmt(row['admission_stall_p99_ms']):>10} "
                f"{fmt(row['send_lock_wait_p99_ms']):>10} "
                f"{fmt(row['wal_fsync_share_pct']):>8}"
            )
    else:
        lines.append("(no history yet)")
    nodes = (doc["latest"] or {}).get("nodes") or {}
    if nodes:
        lines.append("")
        lines.append(
            f"{'node':>10} {'group':>5} {'rss kB':>9} {'fds':>5} "
            f"{'offset us':>10} {'rtt us':>8} {'ok':>3}"
        )
        for label in sorted(nodes):
            node = nodes[label]
            lines.append(
                f"{label:>10} {node.get('group', '-'):>5} "
                f"{node.get('rss_kb') or '-':>9} "
                f"{node.get('open_fds') or '-':>5} "
                f"{node.get('offset_us', 0.0):>10.0f} "
                f"{node.get('rtt_us', 0.0):>8.0f} "
                f"{'y' if node.get('reachable') else 'n':>3}"
            )
    for finding in fleet_mod.detect_trends(doc["history"]):
        lines.append(
            f"trend: {finding['node']} {finding['kind']}: "
            f"{finding['detail']}"
        )
    return "\n".join(lines)


def run_top(
    fleet_dir, interval_s: float = 1.0, iterations: Optional[int] = None
) -> int:
    """Live fleet view: redraw :func:`render_top` every ``interval_s``
    until Ctrl-C (or ``iterations`` screens, for tests)."""
    fleet_dir = _resolve_fleet_dir(fleet_dir)
    count = 0
    try:
        while iterations is None or count < iterations:
            # ANSI home+clear keeps the screen stable without curses.
            sys.stdout.write("\x1b[H\x1b[2J" + render_top(fleet_dir) + "\n")
            sys.stdout.flush()
            count += 1
            if iterations is not None and count >= iterations:
                break
            time.sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="mirnet", description=__doc__.split("\n", 1)[0]
    )
    parser.add_argument("--node", type=int, default=None,
                        help="(internal) run as node process with this id")
    parser.add_argument("--host", type=int, default=None,
                        help="(internal) run as a cohost process serving "
                             "this node index of every group")
    parser.add_argument("--observer", type=int, default=None,
                        help="(internal) run as observer child with this "
                             "index (requires --group)")
    parser.add_argument("--group", type=int, default=None,
                        help="(internal) group id for --observer")
    parser.add_argument("--dir", default=None,
                        help="deployment directory (default: fresh tempdir)")
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--groups", type=int, default=None,
                        help="run a sharded deployment with this many "
                             "consensus groups behind the routing tier")
    parser.add_argument("--nodes-per-group", type=int, default=2)
    parser.add_argument("--layout", choices=("disjoint", "cohost"),
                        default="disjoint",
                        help="sharded process packaging: one process per "
                             "(group, node) or one per host index")
    parser.add_argument("--no-shared-wave", action="store_true",
                        help="cohost layout: keep per-group hashers "
                             "instead of multiplexing all co-hosted "
                             "groups' crypto through one shared fused "
                             "device wave (the cohost default)")
    parser.add_argument("--observers", type=int, default=0,
                        help="observers per group for --groups runs")
    parser.add_argument("--reqs", type=int, default=10)
    parser.add_argument("--kill-restart", action="store_true",
                        help="SIGKILL+restart one node mid-run")
    parser.add_argument("--timeout", type=float, default=90.0)
    parser.add_argument("--scenario", default=None,
                        help="run a choreographed fault scenario "
                             "(see --list-scenarios)")
    parser.add_argument("--seed", type=int, default=7,
                        help="fault-injection seed for --scenario")
    parser.add_argument("--pipeline", action="store_true",
                        help="run nodes on the staged pipeline scheduler "
                             "(processor/pipeline.py) — the default; kept "
                             "as an explicit flag for scripts")
    parser.add_argument("--classic", action="store_true",
                        help="run nodes on the classic depth-1 reference "
                             "schedule instead of the pipelined default")
    parser.add_argument("--fleet", action="store_true",
                        help="run the fleet telemetry collector against "
                             "the deployment; its rolling output lands "
                             "under <dir>/fleet/ (--groups runs only)")
    parser.add_argument("--no-flight-recorder", action="store_true",
                        help="disable the always-on event journal "
                             "(node-<i>/journal/); escape hatch for "
                             "measuring raw throughput without the "
                             "recorder")
    parser.add_argument("--top", action="store_true",
                        help="live fleet view over an existing --fleet "
                             "run's output (requires --dir; Ctrl-C exits)")
    parser.add_argument("--list-scenarios", action="store_true")
    args = parser.parse_args(argv)

    if args.list_scenarios:
        for name in sorted(SCENARIOS):
            print(name)
        return 0

    if args.pipeline and args.classic:
        parser.error("--pipeline and --classic are mutually exclusive")
    pipeline = not args.classic

    if args.top:
        if args.dir is None:
            parser.error("--top requires --dir")
        return run_top(args.dir)

    if args.node is not None:
        if args.dir is None:
            parser.error("--node requires --dir")
        return run_node(Path(args.dir), args.node)

    if args.host is not None:
        if args.dir is None:
            parser.error("--host requires --dir")
        return run_host(Path(args.dir), args.host)

    if args.observer is not None:
        if args.dir is None or args.group is None:
            parser.error("--observer requires --dir and --group")
        return run_observer(Path(args.dir), args.group, args.observer)

    if args.fleet and args.groups is None:
        parser.error("--fleet requires --groups (the fleet plane is "
                     "the sharded deployment's observability surface)")

    if args.groups is not None:
        result = run_sharded_deployment(
            root_dir=args.dir,
            groups=args.groups,
            nodes_per_group=args.nodes_per_group,
            reqs_per_group=args.reqs,
            layout=args.layout,
            observers_per_group=args.observers,
            timeout_s=args.timeout,
            pipeline=pipeline,
            fleet=args.fleet,
            record_events=not args.no_flight_recorder,
            shared_wave=False if args.no_shared_wave else None,
        )
        print(json.dumps(result, indent=2, sort_keys=True))
        print(
            f"mirnet: {args.groups} groups x {args.nodes_per_group} nodes "
            f"({args.layout}) committed {result['unique_reqs_total']} "
            f"unique requests in {result['elapsed_s']:.1f}s",
            file=sys.stderr,
        )
        return 0

    if args.scenario is not None:
        try:
            doc = run_scenario(args.scenario, root_dir=args.dir,
                               seed=args.seed, pipeline=pipeline)
        except AssertionError as err:
            print(str(err), file=sys.stderr)
            return 1
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
        return 0

    result = run_deployment(
        root_dir=args.dir,
        node_count=args.nodes,
        reqs=args.reqs,
        kill_restart=args.kill_restart,
        timeout_s=args.timeout,
        pipeline=pipeline,
        record_events=not args.no_flight_recorder,
    )
    print(json.dumps(result, indent=2, sort_keys=True))
    print(
        f"mirnet: {args.nodes} processes agreed on "
        f"{min(result['commits'].values())}+ commits in "
        f"{result['elapsed_s']:.1f}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
