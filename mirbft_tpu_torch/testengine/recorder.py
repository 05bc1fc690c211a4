"""Simulated nodes, in-memory fakes, and the single-threaded scheduler.

Rebuild of reference ``pkg/testengine/recorder.go``: in-memory WAL/request
store, a Link that enqueues MsgReceived with latency, a hashing NodeState app
with snapshot chaining + reconfig points + state-transfer log, the
per-category latency model, and ``Recording.step()`` replicating the
concurrency rules of the node runtime single-threadedly (one in-flight batch
per work category).  ``drain_clients`` runs the simulation until every
client's requests commit on every node.

Ported from the JAX package's ``testengine/recorder.py``: the device hash
and auth planes and the fused pipeline run the port's CUDA kernels
(``CryptoConfig.torch_device``), and the parts later slices port (the shared
wave mux, mesh sharding) raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .. import processor as proc
from .. import status as status_mod
from .. import tracing
from .. import wire
from ..health import DivergenceDetector, HealthConfig, HealthMonitor
from ..config import standard_initial_network_state
from ..messages import (
    CEntry,
    EpochConfig,
    FEntry,
    NetworkState,
    Persistent,
    QEntry,
    Reconfiguration,
    RequestAck,
)
from ..state import Event, EventInitialParameters
from ..statemachine.actions import Actions, Events
from ..statemachine.machine import StateMachine
from .crypto import NOT_PORTED, DeviceAuthPlane, DeviceHashPlane
from .queue import EventQueue


def _u64(value: int) -> bytes:
    return value.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# In-memory fakes (reference recorder.go:39-201).
# ---------------------------------------------------------------------------


class SimLink:
    """Enqueues MsgReceived with link latency (reference recorder.go:39-47).

    ``delay_to`` (optional, one entry per destination node) overrides the
    scalar ``delay`` per directed link — the WAN topologies use it for
    intra-region vs inter-region latency, and the PDES engine derives its
    per-partition-pair lookahead windows from the same matrix."""

    def __init__(
        self,
        source: int,
        event_queue: EventQueue,
        delay: int,
        delay_to: Optional[Tuple[int, ...]] = None,
    ):
        self.source = source
        self.event_queue = event_queue
        self.delay = delay
        self.delay_to = delay_to

    def send(self, dest: int, msg) -> None:
        delay = self.delay if self.delay_to is None else self.delay_to[dest]
        self.event_queue.insert_msg_received(dest, self.source, msg, delay)


class SimReqStore:
    """Map-backed request store (reference recorder.go:87-124)."""

    def __init__(self):
        self.requests: Dict[RequestAck, bytes] = {}
        self.allocations: Dict[Tuple[int, int], bytes] = {}

    def put_request(self, ack: RequestAck, data: bytes) -> None:
        self.requests[ack] = data

    def get_request(self, ack: RequestAck) -> Optional[bytes]:
        return self.requests.get(ack)

    def put_allocation(self, client_id: int, req_no: int, digest: bytes) -> None:
        self.allocations[(client_id, req_no)] = digest

    def get_allocation(self, client_id: int, req_no: int) -> Optional[bytes]:
        return self.allocations.get((client_id, req_no))

    def sync(self) -> None:
        pass


# One plane for the whole process in CPU mode (cross-NODE and cross-run
# digest sharing: digests are pure functions of content).  Device-enabled
# recordings build their own plane (see CryptoConfig).
_SHARED_CPU_PLANE = DeviceHashPlane(device=False)

# Requests a client pipelines to a node within one simulation event.
_PROPOSAL_CHUNK = 32


class SimWAL:
    """List-backed WAL with strict index accounting
    (reference recorder.go:126-201)."""

    def __init__(self, initial_state: NetworkState, initial_cp: bytes):
        self.low_index = 1
        self.entries: List[Persistent] = [
            CEntry(
                seq_no=0,
                checkpoint_value=initial_cp,
                network_state=initial_state,
            ),
            FEntry(
                ends_epoch_config=EpochConfig(
                    number=0,
                    leaders=initial_state.config.nodes,
                    planned_expiration=0,
                )
            ),
        ]

    def write(self, index: int, entry: Persistent) -> None:
        expected = self.low_index + len(self.entries)
        if index != expected:
            raise AssertionError(
                f"WAL out of order: expected next index {expected}, got {index}"
            )
        self.entries.append(entry)

    def truncate(self, index: int) -> None:
        if index < self.low_index:
            raise AssertionError(
                f"truncate to {index} below low index {self.low_index}"
            )
        to_remove = index - self.low_index
        if to_remove >= len(self.entries):
            raise AssertionError(
                f"truncate to {index} beyond highest index "
                f"{self.low_index + len(self.entries)}"
            )
        del self.entries[:to_remove]
        self.low_index = index

    def load_all(self, for_each: Callable[[int, Persistent], None]) -> None:
        for i, entry in enumerate(self.entries):
            for_each(self.low_index + i, entry)

    def sync(self) -> None:
        pass


class NodeState:
    """The simulated replicated app: hash-chained commit log with snapshot
    values encoding the network state (reference recorder.go:272-359)."""

    def __init__(self, req_store: SimReqStore, reconfig_points: List["ReconfigPoint"]):
        self.req_store = req_store
        self.reconfig_points = list(reconfig_points)
        self.pending_reconfigurations: List[Reconfiguration] = []
        self.last_seq_no = 0
        self.active_hash = hashlib.sha256()
        self.checkpoint_seq_no = 0
        self.checkpoint_hash = b""
        self.checkpoint_state: Optional[NetworkState] = None
        self.state_transfers: List[int] = []  # for test assertions
        # App-level fault injection: the next N transfer_to calls raise
        # (e.g. the chosen snapshot source is unavailable), exercising the
        # machine's failed-transfer retry path.  Complements the network
        # manglers, which cannot fail the app boundary.
        self.fail_transfers = 0
        self.transfer_failures: List[int] = []  # seq_nos of failed attempts
        # App-level fault injection: the next N snapshots report a flipped
        # checkpoint fingerprint to introspection while consensus continues
        # on the honest value — the silent-divergence shape the health
        # plane's DivergenceDetector exists to catch (a replica whose app
        # state no longer matches what it voted for).
        self.corrupt_snapshots = 0
        # Optional sim-clock tap (tests wire it to the event queue) so
        # retry spacing — the backoff — is assertable, not just retry count.
        self.time_source: Optional[Callable[[], int]] = None
        self.transfer_attempt_times: List[int] = []
        # Highest applied req_no + 1 per client — survives the client's
        # removal by reconfiguration, unlike the checkpoint state.
        self.committed_reqs: Dict[int, int] = {}

    def snap(self, network_config, client_states):
        pending = tuple(self.pending_reconfigurations)
        self.pending_reconfigurations = []

        self.checkpoint_seq_no = self.last_seq_no
        self.checkpoint_state = NetworkState(
            config=network_config,
            clients=tuple(client_states),
            pending_reconfigurations=pending,
        )
        self.checkpoint_hash = self.active_hash.digest()
        self.active_hash = hashlib.sha256()
        self.active_hash.update(self.checkpoint_hash)

        # Test convenience (as in the reference): the value carries the full
        # network state so state transfer needs no cross-node lookup.
        value = self.checkpoint_hash + wire.encode(self.checkpoint_state)
        if self.corrupt_snapshots > 0:
            self.corrupt_snapshots -= 1
            self.checkpoint_hash = bytes(
                b ^ 0xFF for b in self.checkpoint_hash
            )
        return value, pending

    def transfer_to(self, seq_no: int, snap: bytes) -> NetworkState:
        if self.time_source is not None:
            self.transfer_attempt_times.append(self.time_source())
        if self.fail_transfers > 0:
            self.fail_transfers -= 1
            self.transfer_failures.append(seq_no)
            raise RuntimeError("injected state-transfer failure")
        self.state_transfers.append(seq_no)
        network_state = wire.decode(snap[32:])
        if not isinstance(network_state, NetworkState):
            raise ValueError("snapshot does not encode a NetworkState")
        self.last_seq_no = seq_no
        self.checkpoint_seq_no = seq_no
        self.checkpoint_state = network_state
        self.checkpoint_hash = snap[:32]
        self.active_hash = hashlib.sha256()
        self.active_hash.update(self.checkpoint_hash)
        return network_state

    def apply(self, batch: QEntry) -> None:
        self.last_seq_no += 1
        if batch.seq_no != self.last_seq_no:
            raise AssertionError(
                f"out-of-order commit: expected {self.last_seq_no}, got "
                f"{batch.seq_no}"
            )
        for request in batch.requests:
            data = self.req_store.get_request(request)
            if data is None:
                raise AssertionError(
                    "reqstore must have a request we are committing"
                )
            self.active_hash.update(request.digest)
            prev = self.committed_reqs.get(request.client_id, 0)
            if request.req_no + 1 > prev:
                self.committed_reqs[request.client_id] = request.req_no + 1
            for point in self.reconfig_points:
                if (
                    point.client_id == request.client_id
                    and point.req_no == request.req_no
                ):
                    self.pending_reconfigurations.append(point.reconfiguration)


# ---------------------------------------------------------------------------
# Configuration (reference recorder.go:49-65, 361-385, 725-790).
# ---------------------------------------------------------------------------


@dataclass
class RuntimeParameters:
    """Per-category simulated latencies (reference recorder.go:54-65)."""

    tick_interval: int = 500
    link_latency: int = 100
    # Optional per-destination link-latency row (one entry per node,
    # self-entry ignored); None means the scalar applies to every link.
    link_latency_to: Optional[Tuple[int, ...]] = None
    process_wal_latency: int = 100
    process_net_latency: int = 15
    process_hash_latency: int = 25
    process_client_latency: int = 15
    process_app_latency: int = 30
    process_req_store_latency: int = 150
    process_events_latency: int = 10


@dataclass
class NodeConfig:
    init_parms: EventInitialParameters
    runtime_parms: RuntimeParameters
    # Simulated-clock delay before the node first initializes; a large value
    # models a late-started replica that must state-transfer to catch up
    # (reference integration_test.go "late-start" scenario).
    start_delay: int = 0


@dataclass
class ClientConfig:
    """Reference recorder.go:361-385 (its dead ``MaxInFlight`` knob is
    dropped: proposals are sequential per node in both implementations).

    ``signed`` enables the extended Ed25519-signed-request mode (BASELINE
    configs 2-5, no reference counterpart): the client signs every request
    and replicas authenticate before persisting/acking.

    ``corrupt`` models a byzantine signer (BASELINE config 5): every
    envelope carries a garbage signature, so honest replicas must reject
    each proposal at the authentication gate and none of the client's
    requests ever commit."""

    id: int
    total: int
    ignore_nodes: Tuple[int, ...] = ()
    signed: bool = False
    corrupt: bool = False

    def should_skip(self, node_id: int) -> bool:
        return node_id in self.ignore_nodes


@dataclass
class ReconfigPoint:
    client_id: int
    req_no: int
    reconfiguration: Reconfiguration


@dataclass
class CryptoConfig:
    """Crypto-plane knobs (see ``testengine/crypto.py``).

    ``device=True`` routes wave-aggregated SHA-256 hashing and Ed25519
    verification through asynchronous kernel launches on ``torch_device``
    ("cuda", the default, or "cpu" for the kernels' plain twins); ``False``
    (default) keeps the memoized host paths.  Digests/verdicts are
    bit-identical either way and the simulation's event schedule is
    unaffected."""

    device: bool = False
    hash_wave: int = 192
    hash_floor: int = 64
    auth_wave: int = 128
    auth_floor: int = 16
    lookahead: int = 128
    # sha256 kernel: "auto" (measured crossover, ops/crossover.py) |
    # "scan" | "pallas" (both the batch-major kernel) | "lanes"
    kernel: str = "auto"
    # Adaptive wave sizing (testengine.crypto.WaveController): hash_wave is
    # the starting size; the controller grows/shrinks it from observed
    # queue depth and dispatch latency.  False pins the size.
    adaptive_wave: bool = True
    # Route waves through the fused hash→verify→quorum pipeline
    # (ops/fused.py): one device dispatch and one collect per wave instead
    # of three.  Digests and verdicts stay bit-identical.
    fused: bool = False
    # > 0: build a jax.sharding.Mesh over this many devices and route BOTH
    # crypto planes' waves through the batch-sharded multi-chip kernels
    # (parallel.sharded_ed25519_verify for verify waves, sharded_sha256 for
    # hash waves) — consensus traffic then transits the mesh.  Digests and
    # verdicts stay bit-identical to single-device.
    mesh_devices: int = 0
    # Re-schedule (in sim time) hash events whose device dispatch is still
    # in flight rather than blocking the host loop.  Step counts become
    # wall-clock-dependent, and on a single-core host the re-scheduled
    # events spin faster than the device round-trip elapses — opt in only
    # when the host has spare cores to burn during device waits.
    defer_unready: bool = False
    # Co-hosted multi-group mode: attach this recording's crypto planes to
    # a shared cross-group SharedWaveMux (testengine/crypto.py) as tenant
    # ``mux_group`` instead of building a private fused pipeline.  Every
    # recording sharing the mux rides the same fused device waves;
    # digests/verdicts stay bit-identical (tests/test_wave_mux.py).
    mux: object = None
    mux_group: int = 0
    # Where the planes' waves run: "cuda" launches the CUDA kernels, "cpu"
    # their plain PyTorch twins.
    torch_device: str = "cuda"


class SimClient:
    """Deterministic request generator (reference recorder.go:246-263).
    In signed mode each request is sealed with a deterministic per-client
    Ed25519 key (``processor.verify`` envelope format)."""

    def __init__(self, config: ClientConfig):
        self.config = config
        self._keys = None
        self._sealed: Dict[int, bytes] = {}

    def _keypair(self):
        if self._keys is None:
            from ..ops.ed25519 import keypair_from_seed

            seed = hashlib.sha256(
                b"mirbft-tpu-sim-client-" + _u64(self.config.id)
            ).digest()
            self._keys = keypair_from_seed(seed)
        return self._keys

    def public_key(self) -> bytes:
        return self._keypair()[0]

    def request_by_req_no(self, req_no: int) -> Optional[bytes]:
        if req_no >= self.config.total:
            return None
        payload = _u64(self.config.id) + b"-" + _u64(req_no)
        if not self.config.signed:
            return payload
        sealed = self._sealed.get(req_no)
        if sealed is None:
            from ..processor.verify import seal, signing_payload

            if self.config.corrupt:
                # Byzantine signer: deterministic garbage in place of a
                # valid signature (fails verification at every replica).
                signature = hashlib.sha512(
                    b"corrupt-" + _u64(self.config.id) + _u64(req_no)
                ).digest()
            else:
                signature = self._keypair()[1](
                    signing_payload(self.config.id, req_no, payload)
                )
            sealed = seal(payload, signature)
            self._sealed[req_no] = sealed
        return sealed


# ---------------------------------------------------------------------------
# Node + Recording (reference recorder.go:203-244, 387-723).
# ---------------------------------------------------------------------------


class SimNode:
    def __init__(
        self,
        node_id: int,
        config: NodeConfig,
        wal: SimWAL,
        link: SimLink,
        req_store: SimReqStore,
        state: NodeState,
        interceptor=None,
        authenticator=None,
        hasher=None,
        logger=None,
        forwarding: bool = False,
    ):
        self.id = node_id
        self.config = config
        self.wal = wal
        self.link = link
        self.req_store = req_store
        self.state = state
        self.interceptor = interceptor
        self.authenticator = authenticator
        self.hasher = hasher if hasher is not None else _SHARED_CPU_PLANE
        self.logger = logger
        # Request forwarding is off by default in the sim: the native fast
        # engine still drops ActionForwardRequest (fastengine.cpp), so the
        # differential suite would diverge on fetch-path scenarios.  Tests
        # of the forwarding round trip opt in via Recorder.forwarding.
        self.forwarding = forwarding
        self.work_items: Optional[proc.WorkItems] = None
        self.clients: Optional[proc.Clients] = None
        self.state_machine: Optional[StateMachine] = None
        self.pending: Dict[str, bool] = {}

    def initialize(self, init_parms: EventInitialParameters) -> None:
        """(Re)boot the node from its WAL (reference recorder.go:222-244)."""
        self.work_items = proc.WorkItems(forwarding=self.forwarding)
        self.clients = proc.Clients(self.hasher, self.req_store)
        self.state_machine = StateMachine(self.logger)
        self.pending = {}
        events = proc.recover_wal_for_existing_node(self.wal, init_parms)
        self.work_items.result_events.concat(events)


class Recorder:
    """Builds Recordings (reference recorder.go:387-470)."""

    def __init__(
        self,
        network_state: NetworkState,
        node_configs: List[NodeConfig],
        client_configs: List[ClientConfig],
        reconfig_points: Optional[List[ReconfigPoint]] = None,
        mangler=None,
        random_seed: int = 0,
        event_log_writer=None,
        crypto: Optional[CryptoConfig] = None,
        logger=None,
    ):
        self.network_state = network_state
        self.node_configs = node_configs
        self.client_configs = client_configs
        self.reconfig_points = reconfig_points or []
        self.mangler = mangler
        self.random_seed = random_seed
        self.event_log_writer = event_log_writer
        self.crypto = crypto or CryptoConfig()
        self.logger = logger
        # Enable the request-forwarding round trip (work.py routing +
        # ingress ingestion).  Default False: bit-identical to the native
        # fast engine, which still drops forwards (see SimNode).
        self.forwarding = False
        # Optional sim-domain Tracer (set before recording(), like
        # event_log_writer): its clock is bound to the event queue's virtual
        # fake_time and per-node commit-span trackers feed it during step().
        self.tracer: Optional[tracing.Tracer] = None
        # Optional health plane (set before recording(), same pattern): a
        # HealthConfig attaches per-node HealthMonitors — fed from the event
        # stream plus one status snapshot per tick — and a cross-replica
        # DivergenceDetector fingerprinting checkpoint values each interval
        # (docs/OBSERVABILITY.md "Health plane").
        self.health: Optional[HealthConfig] = None
        # Optional pipelined host scheduling (set before recording(), same
        # pattern): a processor.pipeline.PipelineConfig attaches a
        # SimStagePipeline — bounded stall-metered crypto prefetch with
        # autotuned depths.  The simulated schedule is bit-identical with
        # or without it (the driver only touches the hash plane).
        self.pipeline = None
        # Optional per-node interceptor factory (set before recording(),
        # same pattern): called with the node index, returns an
        # EventInterceptor (e.g. eventlog.JournalRecorder) attached to that
        # SimNode.  event_log_writer wins when both are set — it carries
        # the sim-clock annotation the replay tooling depends on.
        self.interceptor_factory = None

    def recording(self) -> "Recording":
        event_queue = EventQueue(seed=self.random_seed, mangler=self.mangler)

        clients = {cc.id: SimClient(cc) for cc in self.client_configs}
        signed_pubs = {
            cc.id: clients[cc.id].public_key()
            for cc in self.client_configs
            if cc.signed
        }

        crypto = self.crypto
        if crypto.mesh_devices:
            raise NotImplementedError(NOT_PORTED["mesh"])
        if crypto.device and crypto.mux is not None:
            raise NotImplementedError(NOT_PORTED["mux"])
        if crypto.device:
            hash_plane = DeviceHashPlane(
                device=True,
                wave_size=crypto.hash_wave,
                device_floor=crypto.hash_floor,
                kernel=crypto.kernel,
                defer_unready=crypto.defer_unready,
                adaptive=crypto.adaptive_wave,
                torch_device=crypto.torch_device,
            )
        else:
            hash_plane = _SHARED_CPU_PLANE

        auth_plane = None
        if signed_pubs:

            def chunk_provider(client_id: int, start_req: int, _clients=clients):
                client = _clients.get(client_id)
                if client is None:
                    return []
                out = []
                req_no = start_req
                while len(out) < crypto.lookahead:
                    data = client.request_by_req_no(req_no)
                    if data is None:
                        break
                    out.append((req_no, data))
                    req_no += 1
                return out

            auth_plane = DeviceAuthPlane(
                chunk_provider,
                device=crypto.device,
                wave_size=crypto.auth_wave,
                device_floor=crypto.auth_floor,
                lookahead=crypto.lookahead,
                mesh_devices=crypto.mesh_devices,
                torch_device=crypto.torch_device,
            )
            for client_id, pub in signed_pubs.items():
                auth_plane.register(client_id, pub)

        if crypto.fused and crypto.device:
            from ..ops.fused import FusedCryptoPipeline

            hash_plane.attach_fused(
                FusedCryptoPipeline(kernel=crypto.kernel, device=crypto.torch_device),
                auth_plane,
            )

        nodes = []
        for i, node_config in enumerate(self.node_configs):
            req_store = SimReqStore()
            node_state = NodeState(req_store, self.reconfig_points)
            checkpoint_value, _ = node_state.snap(
                self.network_state.config, self.network_state.clients
            )
            wal = SimWAL(self.network_state, checkpoint_value)
            link = SimLink(
                i, event_queue, node_config.runtime_parms.link_latency,
                node_config.runtime_parms.link_latency_to,
            )

            interceptor = None
            if self.event_log_writer is not None:
                writer = self.event_log_writer
                interceptor = _Interceptor(i, event_queue, writer)
            elif self.interceptor_factory is not None:
                interceptor = self.interceptor_factory(i)

            node_logger = None
            if self.logger is not None:
                from ..logger import PrefixLogger

                node_logger = PrefixLogger(self.logger, node=i)
            nodes.append(
                SimNode(
                    i,
                    node_config,
                    wal,
                    link,
                    req_store,
                    node_state,
                    interceptor,
                    auth_plane,
                    hash_plane,
                    node_logger,
                    forwarding=self.forwarding,
                )
            )
            event_queue.insert_initialize(
                i, node_config.init_parms, node_config.start_delay
            )

        recording = Recording(
            event_queue, nodes, clients, hash_plane=hash_plane, auth_plane=auth_plane
        )
        if self.pipeline is not None:
            from .sched import SimStagePipeline

            recording.scheduler = SimStagePipeline(
                hash_plane, event_queue, config=self.pipeline
            )
        if self.tracer is not None:
            tracer = self.tracer
            tracer.clock = lambda: float(event_queue.fake_time)
            tracer.clock_domain = "sim"
            recording.tracer = tracer
            for node in nodes:
                tracer.name_process(node.id, f"node{node.id}")
                recording.span_trackers[node.id] = tracing.CommitSpanTracker(
                    tracer, node.id
                )
        if self.health is not None:
            health = self.health
            sim_clock = lambda: float(event_queue.fake_time)  # noqa: E731
            recording.health_config = health
            for node in nodes:
                recording.health_monitors[node.id] = HealthMonitor(
                    node.id,
                    tracer=self.tracer,
                    logger=node.logger,
                    clock=sim_clock,
                    thresholds=health.thresholds,
                    num_nodes=len(nodes),
                )
            recording.divergence = DivergenceDetector(
                tracer=self.tracer, logger=self.logger
            )
        return recording


class _Interceptor:
    def __init__(self, node_id: int, event_queue: EventQueue, writer):
        self.node_id = node_id
        self.event_queue = event_queue
        self.writer = writer

    def intercept(self, event: Event) -> None:
        from ..state import RecordedEvent

        wire.write_framed(
            self.writer,
            RecordedEvent(
                node_id=self.node_id,
                time=self.event_queue.fake_time,
                state_event=event,
            ),
        )


class Recording:
    """Reference recorder.go:472-723."""

    def __init__(
        self,
        event_queue: EventQueue,
        nodes: List[SimNode],
        clients: Dict[int, SimClient],
        hash_plane: Optional[DeviceHashPlane] = None,
        auth_plane: Optional[DeviceAuthPlane] = None,
    ):
        self.event_queue = event_queue
        self.nodes = nodes
        self.clients = clients  # by client id (ids need not be dense)
        self.hash_plane = hash_plane
        self.auth_plane = auth_plane
        # Sim-domain tracing (wired by Recorder.recording() when a tracer
        # is attached): per-node commit-span trackers fed during step().
        self.tracer: Optional[tracing.Tracer] = None
        self.span_trackers: Dict[int, tracing.CommitSpanTracker] = {}
        # Health plane (wired by Recorder.recording() when Recorder.health
        # is set): per-node monitors observe events during step() and a
        # snapshot per tick; the divergence detector sweeps every node's
        # checkpoint fingerprint each interval.
        self.health_config: Optional[HealthConfig] = None
        self.health_monitors: Dict[int, HealthMonitor] = {}
        self.divergence: Optional[DivergenceDetector] = None
        self._next_divergence_check = 0
        # Pipelined host scheduling (wired by Recorder.recording() when
        # Recorder.pipeline is set): the shared stage-graph driver for
        # crypto prefetch — see testengine/sched.SimStagePipeline.
        self.scheduler = None

    def _schedule_proposal(
        self, node_id: int, client_id: int, req_no: int, data: bytes, delay: int
    ) -> None:
        """Schedule a client proposal, telling the auth plane so signed
        envelopes start verifying (asynchronously) before the event fires."""
        self.event_queue.insert_client_proposal(
            node_id, client_id, req_no, data, delay
        )
        if self.auth_plane is not None and self.clients[client_id].config.signed:
            self.auth_plane.note(client_id, req_no)

    def step(self) -> None:
        """Consume one simulation event, replicating the scheduling rules of
        the concurrent node runtime single-threadedly
        (reference recorder.go:484-677)."""
        if not len(self.event_queue):
            raise AssertionError("event queue is empty, nothing to do")

        event = self.event_queue.consume()
        node = self.nodes[event.target]
        parms = node.config.runtime_parms
        queue = self.event_queue

        if event.initialize is not None:
            # Restart: clear any outstanding events for this node first.
            queue.remove_events_for(node.id)
            if self.scheduler is not None:
                # Dropped events include any scheduled hash batches whose
                # prefetch slots must be returned.
                self.scheduler.on_node_reset(node.id)
            node.initialize(event.initialize)
            queue.insert_tick(node.id, parms.tick_interval)
            # Schedule proposals for every configured client, not just those
            # in the checkpoint state: a client a pending reconfiguration is
            # about to add has no window yet, and its proposals spin in the
            # ClientNotExist retry path until the new config activates.
            state_clients = {
                cs.id: cs for cs in node.state.checkpoint_state.clients
            }
            for client in self.clients.values():
                if client.config.should_skip(node.id):
                    continue
                client_state = state_clients.get(client.config.id)
                start_req = (
                    client_state.low_watermark if client_state is not None else 0
                )
                data = client.request_by_req_no(start_req)
                if data is not None:
                    self._schedule_proposal(
                        node.id,
                        client.config.id,
                        start_req,
                        data,
                        parms.process_client_latency,
                    )
        elif event.msg_received is not None:
            if node.state_machine is not None:
                source, msg = event.msg_received
                # ForwardRequests never enter the state machine: intercept
                # (including inside MsgBatch envelopes) and ingest through
                # the client store, with the resulting RequestPersisted
                # events crossing the request-store durability barrier —
                # the sim mirror of Node._ingest_forward.
                msg, forwards = proc.split_forward_requests(msg)
                for forward in forwards:
                    events = node.clients.ingest_forwarded(forward)
                    if events is None:
                        monitor = self.health_monitors.get(node.id)
                        if monitor is not None:
                            monitor.record_fault(
                                source,
                                "invalid_digest",
                                client_id=forward.request_ack.client_id,
                                req_no=forward.request_ack.req_no,
                            )
                    elif events:
                        node.work_items.add_client_results(events)
                if msg is not None:
                    node.work_items.result_events.step(source, msg)
        elif event.client_proposal is not None:
            # One event proposes a PIPELINE of up to _PROPOSAL_CHUNK requests
            # from this client to this node (real clients stream requests;
            # scheduling one simulation event per request made proposal
            # delivery the dominant event class at 64+ replicas).  Each
            # item's semantics are identical to a single-proposal event; the
            # chain re-schedules itself exactly as before on window gaps,
            # unallocated clients, and chunk exhaustion.
            client_id, req_no, data = event.client_proposal
            client = node.clients.client(client_id)
            sim_client = self.clients[client_id]
            if sim_client.config.should_skip(node.id):
                raise AssertionError(
                    f"node {node.id} should be skipped by client {client_id}"
                )
            for _ in range(_PROPOSAL_CHUNK):
                try:
                    next_req_no = client.next_req_no_value()
                except proc.clients.ClientNotExistError:
                    # Client window not allocated yet; retry later.
                    self._schedule_proposal(
                        node.id,
                        client_id,
                        req_no,
                        data,
                        parms.process_client_latency * 100,
                    )
                    break
                if next_req_no != req_no:
                    next_data = sim_client.request_by_req_no(next_req_no)
                    if next_data is not None:
                        self._schedule_proposal(
                            node.id,
                            client_id,
                            next_req_no,
                            next_data,
                            parms.process_client_latency,
                        )
                    break
                if sim_client.config.signed and not (
                    node.authenticator is not None
                    and node.authenticator.authenticate(client_id, req_no, data)
                ):
                    # Forged or corrupt proposal: reject before it can be
                    # persisted or acked.  The legitimate client's own
                    # proposal chain is scheduled independently.
                    monitor = self.health_monitors.get(node.id)
                    if monitor is not None:
                        monitor.record_fault(
                            client_id, "ingress_reject", req_no=req_no
                        )
                    return
                events = client.propose(req_no, data)
                node.work_items.add_client_results(events)
                req_no += 1
                data = sim_client.request_by_req_no(req_no)
                if data is None:
                    break  # no more requests from this client
            else:
                self._schedule_proposal(
                    node.id,
                    client_id,
                    req_no,
                    data,
                    parms.process_client_latency,
                )
        elif event.tick:
            node.work_items.result_events.tick_elapsed()
            queue.insert_tick(node.id, parms.tick_interval)
            if self.scheduler is not None and event.target == 0:
                # One autotune observation per tick round (node 0's tick),
                # matching the Node runtime's tick-driven cadence.
                self.scheduler.on_tick()
            if self.health_monitors:
                monitor = self.health_monitors.get(node.id)
                if monitor is not None and node.state_machine is not None:
                    monitor.observe_snapshot(
                        status_mod.snapshot(node.state_machine),
                        now=float(queue.fake_time),
                    )
                if (
                    self.divergence is not None
                    and queue.fake_time >= self._next_divergence_check
                ):
                    self._next_divergence_check = (
                        queue.fake_time
                        + self.health_config.divergence_check_interval
                    )
                    self.divergence.observe(
                        {
                            n.id: (
                                n.state.checkpoint_seq_no,
                                n.state.checkpoint_hash,
                            )
                            for n in self.nodes
                        },
                        now=float(queue.fake_time),
                    )
        elif event.process_req_store_events is not None:
            node.work_items.add_req_store_results(
                proc.process_reqstore_events(
                    node.req_store, event.process_req_store_events
                )
            )
            node.pending["req_store"] = False
        elif event.process_result_events is not None:
            actions = proc.process_state_machine_events(
                node.state_machine, node.interceptor, event.process_result_events
            )
            tracker = self.span_trackers.get(node.id)
            if tracker is not None:
                tracker.observe(event.process_result_events, actions)
            if self.health_monitors:
                monitor = self.health_monitors.get(node.id)
                if monitor is not None:
                    monitor.observe_events(event.process_result_events, actions)
            node.work_items.add_state_machine_results(actions)
            node.pending["result"] = False
        elif event.process_wal_actions is not None:
            node.work_items.add_wal_results(
                proc.process_wal_actions(node.wal, event.process_wal_actions)
            )
            node.pending["wal"] = False
        elif event.process_net_actions is not None:
            node.work_items.add_net_results(
                proc.process_net_actions(
                    node.id,
                    node.link,
                    event.process_net_actions,
                    request_store=node.req_store,
                )
            )
            node.pending["net"] = False
        elif event.process_hash_actions is not None:
            hash_plane = self.hash_plane
            if (
                hash_plane is not None
                and hash_plane.device
                and hash_plane.defer_unready
                and not hash_plane.poll(
                    [a.data for a in event.process_hash_actions]
                )
            ):
                # The device dispatch for this batch is still in flight:
                # model the extra device latency in simulated time instead
                # of stalling the host loop on a blocking collect.
                if self.scheduler is not None:
                    self.scheduler.on_hash_deferred()
                queue.insert_process(
                    node.id,
                    "process_hash_actions",
                    event.process_hash_actions,
                    parms.process_hash_latency,
                )
                return  # pending["hash"] stays set; nothing new to schedule
            sched = self.scheduler
            if sched is not None:
                sched.before_hash_fire(event.process_hash_actions)
            node.work_items.add_hash_results(
                proc.process_hash_actions(node.hasher, event.process_hash_actions)
            )
            if sched is not None:
                sched.after_hash_fire(event.process_hash_actions)
            node.pending["hash"] = False
        elif event.process_client_actions is not None:
            node.work_items.add_client_results(
                node.clients.process_client_actions(event.process_client_actions)
            )
            node.pending["client"] = False
        elif event.process_app_actions is not None:
            node.work_items.add_app_results(
                proc.process_app_actions(node.state, event.process_app_actions)
            )
            node.pending["app"] = False
        else:
            raise AssertionError("unknown simulation event")

        if node.work_items is None:
            return

        # Schedule processing for any non-empty work category with no batch
        # already in flight (reference recorder.go:616-677).
        work = node.work_items
        for key, attr, event_field, latency, empty in (
            ("wal", "wal_actions", "process_wal_actions", parms.process_wal_latency, Actions),
            ("net", "net_actions", "process_net_actions", parms.process_net_latency, Actions),
            ("client", "client_actions", "process_client_actions", parms.process_client_latency, Actions),
            ("hash", "hash_actions", "process_hash_actions", parms.process_hash_latency, Actions),
            ("app", "app_actions", "process_app_actions", parms.process_app_latency, Actions),
            ("req_store", "req_store_events", "process_req_store_events", parms.process_req_store_latency, Events),
            ("result", "result_events", "process_result_events", parms.process_events_latency, Events),
        ):
            batch = getattr(work, attr)
            if not node.pending.get(key) and len(batch) > 0:
                node.pending[key] = True
                queue.insert_process(node.id, event_field, batch, latency)
                setattr(work, attr, empty())
                if key == "hash" and self.hash_plane is not None:
                    if self.scheduler is not None:
                        # One scheduler: the prefetch rides the shared hash
                        # stage's depth budget (refusals are stall-metered;
                        # the simulated schedule is untouched either way).
                        self.scheduler.on_hash_scheduled(node.id, batch)
                    else:
                        # Start the device working on this batch (async)
                        # while the simulated hash latency elapses.
                        self.hash_plane.enqueue([a.data for a in batch])

    def health_report(self) -> dict:
        """Aggregate health report: per-node monitor reports plus the
        cross-replica divergence sweep (requires ``Recorder.health``)."""
        per_node = {
            str(node_id): monitor.report()
            for node_id, monitor in sorted(self.health_monitors.items())
        }
        divergence = self.divergence
        anomalies = [
            a for report in per_node.values() for a in report["anomalies"]
        ]
        if divergence is not None:
            anomalies.extend(a.as_dict() for a in divergence.anomalies)
        return {
            "anomaly_count": len(anomalies),
            "healthy": not anomalies,
            "anomalies": anomalies,
            "divergence_checks": (
                divergence.checks if divergence is not None else 0
            ),
            "per_node": per_node,
        }

    def drain_clients(self, timeout: int) -> int:
        """Run until every client's requests commit on every node
        (reference recorder.go:682-723).  Returns the step count."""
        # Corrupt (byzantine-signer) clients are rejected at the
        # authentication gate, so nothing of theirs ever commits: their
        # drain target is zero.
        target_reqs = {
            c.config.id: 0 if c.config.corrupt else c.config.total
            for c in self.clients.values()
        }
        count = 0
        while True:
            count += 1
            self.step()

            # Done when (a) every client still in the network state is at its
            # target watermark on every node, and (b) every configured client's
            # full request set was applied by at least one node — (b) covers
            # clients a reconfiguration removed (absent from the checkpoint
            # state) or has not yet added (never present in it).
            all_done = True
            for node in self.nodes:
                for client_state in node.state.checkpoint_state.clients:
                    # Clients with no simulated driver (e.g. added by a
                    # reconfiguration the test never proposes for) are skipped.
                    target = target_reqs.get(client_state.id)
                    if target is not None and target != client_state.low_watermark:
                        all_done = False
                        break
                if not all_done:
                    break
            if all_done:
                finished = {
                    cid
                    for cid, total in target_reqs.items()
                    if total == 0
                    or any(
                        node.state.committed_reqs.get(cid, 0) >= total
                        for node in self.nodes
                    )
                }
                if finished >= set(target_reqs):
                    return count

            if count > timeout:
                details = []
                for node in self.nodes:
                    for cs in node.state.checkpoint_state.clients:
                        target = target_reqs.get(cs.id)
                        if target is not None and target != cs.low_watermark:
                            details.append(
                                f"node{node.id} client {cs.id} at "
                                f"{cs.low_watermark}/{target}"
                            )
                for cid, total in sorted(target_reqs.items()):
                    if total > 0 and not any(
                        node.state.committed_reqs.get(cid, 0) >= total
                        for node in self.nodes
                    ):
                        details.append(f"client {cid} never reached its target")
                raise TimeoutError(
                    f"timed out after {count} steps: {'; '.join(details)}"
                )


# ---------------------------------------------------------------------------
# Spec: convenience constructor (reference recorder.go:725-790).
# ---------------------------------------------------------------------------


@dataclass
class Spec:
    node_count: int
    client_count: int
    reqs_per_client: int
    batch_size: int = 1
    client_width: int = 100  # per-client watermark window (reference default)
    clients_ignore: Tuple[int, ...] = ()
    signed_requests: bool = False
    crypto: Optional[CryptoConfig] = None  # None -> host paths (CryptoConfig())
    # Pipelined host scheduling: True -> PipelineConfig() defaults, or an
    # explicit processor.pipeline.PipelineConfig.  Schedule-preserving —
    # step counts and commit streams are bit-identical either way.
    pipeline: object = None
    tweak_recorder: Optional[Callable[[Recorder], None]] = None

    def recorder(self) -> Recorder:
        node_configs = [
            NodeConfig(
                init_parms=EventInitialParameters(
                    id=i,
                    heartbeat_ticks=2,
                    suspect_ticks=4,
                    new_epoch_timeout_ticks=8,
                    buffer_size=5 * 1024 * 1024,
                    batch_size=self.batch_size,
                ),
                runtime_parms=RuntimeParameters(),
            )
            for i in range(self.node_count)
        ]

        network_state = standard_initial_network_state(
            self.node_count,
            *range(self.client_count),
            client_width=self.client_width,
        )

        client_configs = [
            ClientConfig(
                id=client.id,
                total=self.reqs_per_client,
                ignore_nodes=self.clients_ignore,
                signed=self.signed_requests,
            )
            for client in network_state.clients
        ]

        recorder = Recorder(
            network_state=network_state,
            node_configs=node_configs,
            client_configs=client_configs,
            crypto=self.crypto,
        )
        if self.pipeline:
            if self.pipeline is True:
                from ..processor.pipeline import PipelineConfig

                recorder.pipeline = PipelineConfig()
            else:
                recorder.pipeline = self.pipeline
        if self.tweak_recorder is not None:
            self.tweak_recorder(recorder)
        return recorder
