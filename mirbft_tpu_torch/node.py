"""L3 node runtime: the concurrent production event loop.

Rebuild of reference ``mirbft.go``: one worker thread per work category
(WAL / client / hash / net / app / reqstore / state-machine) connected to a
central coordinator that owns the ``WorkItems`` router — the same
one-in-flight-batch-per-category scheduling the deterministic test engine
replicates single-threadedly.  The hash worker is the TPU dispatch path:
batches leave the coordinator, run on device, and return as events without
ever blocking the event loop.

The loop itself lives in ``processor/pipeline.py``: the
``PipelineScheduler`` generalizes the reference coordinator into a staged
pipeline with bounded per-stage depth.  A ``Node`` built without a
``pipeline`` config runs the classic schedule (depth 1 everywhere, the
synchronous WAL barrier, the one-call hash stage — bit-equivalent to the
reference); passing ``PipelineConfig()`` enables the pipelined mode that
overlaps WAL fsyncs, in-flight crypto waves and net sends with
backpressure from the slowest stage back to ``Client.propose`` admission.

Concurrency translation (Go → Python): channels/select become per-worker
handoff queues plus one coordinator inbox; the ``workErrNotifier`` failure
latch becomes an event + status snapshot.  Backpressure is preserved: a
category with its depth budget in flight accumulates further work in
``WorkItems`` until a worker returns.  Every hand-off is event-driven
(blocking gets, sentinel shutdown) — there are no polling timeouts, so an
idle node wakes in scheduler latency, not a 50 ms floor.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import health as health_mod
from . import metrics as metrics_mod
from . import processor as proc
from . import status as status_mod
from . import tracing
from .config import Config
from .messages import Msg, NetworkState
from .processor.pipeline import PipelineConfig, PipelineScheduler
from .statemachine.actions import Actions, Events
from .statemachine.machine import StateMachine


class StoppedError(RuntimeError):
    """Raised when the node was stopped at the caller's request."""


@dataclass
class ProcessorConfig:
    """Pluggable processor backends (reference mirbft.go:407-414).

    ``authenticator`` is the embedder-side request-authentication gate
    (``processor.verify.RequestAuthenticator``): when set, every client
    proposal is signature-checked before it can be persisted or
    acknowledged — the signed-request mode of BASELINE configs 2-5 on the
    real (threaded) runtime, matching the testengine's ingress gate."""

    link: proc.Link
    hasher: proc.Hasher
    app: proc.App
    wal: proc.WAL
    request_store: proc.RequestStore
    interceptor: Optional[proc.EventInterceptor] = None
    authenticator: Optional[object] = None


class _WorkErrNotifier:
    """Failure latch shared by the workers (reference mirbft.go:572-624)."""

    def __init__(self):
        # The latch guards a single write-once error slot; every access
        # is inside this class's two short methods, which take the lock.
        # mirlint: allow(lock-map)
        self._lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self.exit_event = threading.Event()
        self.exit_status_event = threading.Event()
        self.exit_status = None

    def err(self) -> Optional[BaseException]:
        with self._lock:
            return self._err

    def fail(self, err: BaseException) -> None:
        with self._lock:
            if self._err is None:
                self._err = err
        self.exit_event.set()

    def set_exit_status(self, status) -> None:
        self.exit_status = status
        self.exit_status_event.set()


class AuthenticationError(ValueError):
    """A proposal failed signature verification at the ingress gate."""


class Client:
    """Thread-safe proposal handle (reference mirbft.go:44-69)."""

    def __init__(
        self,
        client: proc.Client,
        inbox: "queue.Queue",
        notifier: _WorkErrNotifier,
        client_id: int = -1,
        authenticator=None,
        health_monitor=None,
        admission=None,
    ):
        self._client = client
        self._inbox = inbox
        self._notifier = notifier
        self._client_id = client_id
        self._authenticator = authenticator
        self._health_monitor = health_monitor
        self._admission = admission

    def next_req_no(self) -> int:
        return self._client.next_req_no_value()

    def propose(self, req_no: int, data: bytes) -> None:
        # Scalar gate: one verification per propose (pure-Python below the
        # verifier's device floor).  Embedders driving high signed-request
        # rates should verify in bulk via
        # ``RequestAuthenticator.authenticate_batch`` ahead of proposing —
        # the per-call path is the correctness gate, not the fast path.
        if self._authenticator is not None and not self._authenticator.authenticate(
            self._client_id, req_no, data
        ):
            # Forged/corrupt envelope: rejected before it can be persisted
            # or acked (the testengine's ingress gate, on the real runtime).
            if self._health_monitor is not None:
                self._health_monitor.record_fault(
                    self._client_id, "ingress_reject", req_no=req_no
                )
            raise AuthenticationError(
                f"client {self._client_id} req {req_no}: signature rejected"
            )
        if self._admission is not None:
            # End-to-end backpressure: block while the admission window is
            # full (freed as the result stage observes commits).
            self._admission.admit((self._client_id, req_no))
        events = self._client.propose(req_no, data)
        if self._notifier.exit_event.is_set():
            raise self._notifier.err() or StoppedError()
        if events:
            # "client_ingress", not "client_results": this thread never
            # acquired the client stage, so it must not release it.
            self._inbox.put(("client_ingress", events))


class Node:
    """Reference mirbft.go:75-176."""

    def __init__(
        self,
        node_id: int,
        config: Config,
        processor_config: ProcessorConfig,
        pipeline: Optional[PipelineConfig] = None,
    ):
        self.id = node_id
        self.config = config
        self.processor_config = processor_config
        self.pipeline = pipeline
        self.state_machine = StateMachine(config.logger)
        self.work_items = proc.WorkItems()
        self.clients = proc.Clients(
            processor_config.hasher, processor_config.request_store
        )
        self.replicas = proc.Replicas(on_forward=self._ingest_forward)
        self.notifier = _WorkErrNotifier()
        self._tick_thread: Optional[threading.Thread] = None
        self._started = False
        # Wall-clock commit spans: derived from the event/action stream on
        # the result worker (the only thread touching the state machine), so
        # no extra synchronization is needed.  Feeds the per-node
        # commit_latency_seconds histogram; span records go to the process
        # default tracer only while it is enabled.
        self.span_tracker = tracing.CommitSpanTracker(
            tracing.default_tracer, node_id
        )
        # Fleet trace-id bindings (docs/OBSERVABILITY.md "Fleet plane"):
        # (client_id, req_no) -> u64 id, learned from traced client
        # envelopes served locally or TEL_ANNOUNCE pushes from peers.
        # Bounded LRU-ish: oldest binding evicted past the cap.  Writers
        # are transport reader threads and readers the result worker; dict
        # ops are atomic under the GIL and a stale miss only costs one
        # span its trace tag, so no lock.
        self._trace_bindings: "OrderedDict[Tuple[int, int], int]" = (
            OrderedDict()
        )
        self._trace_bindings_total = metrics_mod.counter(
            "trace_bindings_total"
        )
        self.span_tracker.trace_resolver = self.trace_id_of
        # Flight recorder (docs/OBSERVABILITY.md "Flight recorder"): an
        # interceptor exposing an unbound ``trace_lookup`` slot (the
        # eventlog JournalRecorder) gets the same binding LRU, so recorded
        # EventSteps join the fleet causal graph.
        interceptor = processor_config.interceptor
        if (
            interceptor is not None
            and getattr(interceptor, "trace_lookup", False) is None
        ):
            interceptor.trace_lookup = self.trace_id_of
        # Protocol health plane (docs/OBSERVABILITY.md): the event stream
        # feeds it on the result worker, periodic status snapshots on the
        # coordinator (every tick, whenever no state-machine batch is in
        # flight — the same constraint status() obeys).
        self.health_monitor = health_mod.HealthMonitor(
            node_id, logger=config.logger
        )
        # The event loop: classic (reference-equivalent) schedule unless a
        # pipeline config was passed.
        self.scheduler = PipelineScheduler(
            node_id,
            self.work_items,
            self._handlers(),
            self.notifier,
            snapshot_fn=lambda: status_mod.snapshot(self.state_machine),
            config=pipeline if pipeline is not None else PipelineConfig.classic(),
            on_snapshot=self.health_monitor.observe_snapshot,
            wal=processor_config.wal,
            request_store=processor_config.request_store,
            hasher=processor_config.hasher,
        )
        # Coordinator inbox: tagged results/ingress/control messages.
        self.inbox = self.scheduler.inbox

    @property
    def schedule(self) -> str:
        """The active schedule name — what deployment tooling records in
        ``cluster.json`` and health reports: ``"pipelined"`` when a
        pipeline config was passed, ``"classic"`` for the reference
        coordinator."""
        return "classic" if self.pipeline is None else "pipelined"

    @property
    def _threads(self) -> List[threading.Thread]:
        return self.scheduler.threads

    # --- boot (reference mirbft.go:436-464) ---

    def process_as_new_node(
        self,
        initial_network_state: NetworkState,
        initial_checkpoint_value: bytes,
        tick_interval: Optional[float] = None,
    ) -> None:
        """Seed a fresh WAL with genesis entries and start processing."""
        events = proc.initialize_wal_for_new_node(
            self.processor_config.wal,
            self.config.initial_parameters(),
            initial_network_state,
            initial_checkpoint_value,
        )
        self.work_items.result_events.concat(events)
        self._start(tick_interval)

    def restart_processing(self, tick_interval: Optional[float] = None) -> None:
        """Replay the existing WAL and resume processing."""
        events = proc.recover_wal_for_existing_node(
            self.processor_config.wal, self.config.initial_parameters()
        )
        self.work_items.result_events.concat(events)
        self._start(tick_interval)

    # --- ingress (reference mirbft.go:205-229) ---

    def step(self, source: int, msg: Msg) -> None:
        """Validated network ingress; thread-safe."""
        events = self.replicas.replica(source).step(msg)
        if self.notifier.exit_event.is_set():
            raise self.notifier.err() or StoppedError()
        if events:
            self.inbox.put(("step_events", events))

    def _ingest_forward(self, source: int, msg) -> None:
        """Inbound ForwardRequest (a peer answering our FetchRequest),
        intercepted at replica ingress.  Verified + stored via the client
        store; the RequestPersisted events take the client_ingress inbox
        path so they cross the request-store durability barrier before the
        state machine sees them — the same ordering ``propose`` gets."""
        events = self.clients.ingest_forwarded(msg)
        if events is None:
            # Body does not hash to the claimed digest: peer-controlled
            # garbage, attributed to the sender.
            self.health_monitor.record_fault(
                source,
                "invalid_digest",
                client_id=msg.request_ack.client_id,
                req_no=msg.request_ack.req_no,
            )
            return
        if events:
            self.inbox.put(("client_ingress", events))

    def client(self, client_id: int) -> Client:
        return Client(
            self.clients.client(client_id),
            self.inbox,
            self.notifier,
            client_id=client_id,
            authenticator=self.processor_config.authenticator,
            health_monitor=self.health_monitor,
            admission=self.scheduler.admission,
        )

    def has_client(self, client_id: int) -> bool:
        """Whether the consensused client set currently admits
        ``client_id`` — i.e. a propose would be accepted rather than
        raise ClientNotExistError.  Routers use this to distinguish "not
        yet reconfigured in" (busy, retry) from "routed to the wrong
        group" (redirect) during a reshard (groups/reshard.py)."""
        return bool(self.clients.client(client_id).requests)

    # --- fleet trace bindings (docs/OBSERVABILITY.md "Fleet plane") ---

    _TRACE_BINDINGS_CAP = 8192

    def note_trace(self, client_id: int, req_no: int, trace_id: int) -> None:
        """Record a ``(client, req) -> trace id`` binding so the commit
        span this node eventually emits carries the fleet trace id."""
        if not trace_id:
            return
        key = (client_id, req_no)
        if key not in self._trace_bindings:
            self._trace_bindings_total.inc()
        self._trace_bindings[key] = trace_id
        while len(self._trace_bindings) > self._TRACE_BINDINGS_CAP:
            try:
                self._trace_bindings.popitem(last=False)
            except KeyError:
                break

    def trace_id_of(self, client_id: int, req_no: int) -> Optional[int]:
        return self._trace_bindings.get((client_id, req_no))

    def tick(self) -> None:
        self.inbox.put(("tick", None))

    def status(self, timeout: float = 5.0):
        """Snapshot of the state machine, taken on the coordinator thread."""
        if self.notifier.exit_status_event.is_set():
            return self.notifier.exit_status
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self.inbox.put(("status", reply))
        try:
            return reply.get(timeout=timeout)
        except queue.Empty:
            if self.notifier.exit_status_event.is_set():
                return self.notifier.exit_status
            raise

    def stop(self) -> None:
        self.notifier.fail(StoppedError())
        self.inbox.put(("stop", None))
        for thread in self._threads:
            thread.join(timeout=5)
        # A hasher with device waves still in flight (the cohost shared
        # wave, or any plane-backed hasher) must drain them before the
        # runtime is torn down — an uncollected wave would pin its pooled
        # packing lease and, on a shared mux, leave a dead tenant's rows
        # in other groups' waves.
        flush = getattr(self.processor_config.hasher, "flush_inflight", None)
        if flush is not None:
            try:
                flush()
            except Exception:
                pass  # best-effort: shutdown must not fail on a flush race
        if not self.notifier.exit_status_event.is_set():
            self.notifier.set_exit_status(
                status_mod.snapshot(self.state_machine)
            )

    # --- stage handlers (reference mirbft.go:231-434) ---

    def _handlers(self) -> Dict[str, Callable]:
        pc = self.processor_config
        return {
            "wal": lambda actions: proc.process_wal_actions(
                pc.wal, actions, request_store=pc.request_store
            ),
            "net": lambda actions: proc.process_net_actions(
                self.id, pc.link, actions, request_store=pc.request_store
            ),
            "hash": lambda actions: proc.process_hash_actions(pc.hasher, actions),
            "client": lambda actions: self.clients.process_client_actions(actions),
            "app": lambda actions: proc.process_app_actions(pc.app, actions),
            "req_store": lambda events: proc.process_reqstore_events(
                pc.request_store, events
            ),
            "result": self._process_result_events,
        }

    def _process_result_events(self, events: Events) -> Actions:
        actions = proc.process_state_machine_events(
            self.state_machine, self.processor_config.interceptor, events
        )
        self.span_tracker.observe(events, actions)
        self.health_monitor.observe_events(events, actions)
        self.scheduler.observe_result_actions(actions)
        return actions

    def metrics_text(self, registry=None) -> str:
        """Prometheus text exposition of the metrics registry, labeled with
        this node's id — the scrape surface an embedder serves over HTTP
        (docs/OBSERVABILITY.md)."""
        return metrics_mod.render_prometheus(
            registry, extra_labels={"node": str(self.id)}
        )

    def health(self) -> dict:
        """JSON-ready health report: anomalies, stall windows, and the
        per-peer fault ledger (docs/OBSERVABILITY.md "Health plane").
        Pure read of detector state — observation happens on the node's
        own tick, so polling this cannot perturb the detectors."""
        return self.health_monitor.report()

    # --- startup ---

    def _start(self, tick_interval: Optional[float]) -> None:
        if self._started:
            raise AssertionError("node already started")
        self._started = True
        self.scheduler.start()

        if tick_interval is not None:
            def ticker():
                # Event-driven: wait() returns True the instant the node
                # stops — no shutdown polling between ticks.
                while not self.notifier.exit_event.wait(tick_interval):
                    self.inbox.put(("tick", None))

            self._tick_thread = threading.Thread(
                target=ticker, name=f"node{self.id}-tick", daemon=True
            )
            self._tick_thread.start()
