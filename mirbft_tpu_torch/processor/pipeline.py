"""Admission-to-commit pipeline scheduler (L3).

Generalizes the node runtime's category-worker/coordinator loop into a
staged pipeline with bounded per-stage depth: the seven work categories of
``node.py`` become pipeline stages, each with its own worker thread and an
in-flight budget, so while batch k's WAL fsync is on disk, batch k+1's
crypto wave is on-device and batch k+2's sends are draining into the
per-peer queues — instead of the strictly sequential one-batch-per-category
round trip.  At ``depth == 1`` everywhere with the synchronous WAL handler
and the unsplit hash handler this IS the classic coordinator;
``PipelineConfig()`` (the default ``Node`` mode) enables the pipelined
mode.

This module is also the **one scheduler contract** shared by all three
engines: ``StageGraph`` (stages + bounded depths + ``BARRIER_EDGES``) plus
``DepthAutotuner`` (stall-driven depth control) carry no threads of their
own, so the same stage model drives three implementations:

* the threaded ``PipelineScheduler`` below (the ``Node`` runtime client);
* ``testengine/sched.SimStagePipeline`` — the ``EventQueue``/``Recording``
  driver, which prefetches simulated hash work into device waves under the
  hash stage's budget without touching the simulated schedule;
* ``testengine/sched.FastStageDriver`` — the fastengine adapter, which
  surfaces the native engine's step loop as scheduler stages (the engine
  slice is the pinned ``result`` stage; host crypto waves ride the hash
  stage's rolling window).

The two reference ordering barriers survive as **explicit stage edges**,
not global serialization (serial.py module docstring):

* **WAL-before-send** — WAL batches run their writes on the WAL stage and
  register an fsync ticket (``GroupCommitWAL.sync_begin``); a dedicated
  release thread waits tickets strictly in batch order and only then posts
  the batch's WAL-dependent Sends to the net stage.  No send of batch k
  can reach the link before batch k's fsync completes, yet batch k+1's
  writes overlap batch k's fsync.
* **reqstore-sync-before-ack** — client results still route through the
  req_store stage, whose handler syncs the request store before its
  events reach the state machine (unchanged from the serial processor).

**Backpressure** propagates from the slowest stage to admission: a stage
at full depth accumulates work in ``WorkItems`` (the classic
one-in-flight-batch rule, widened to N), the state-machine stage stops
consuming when downstream stages are saturated, and ``Client.propose``
blocks in the ``AdmissionWindow`` once the configured number of proposals
is in flight end-to-end.  ``pipeline_depth{stage}`` gauges show per-stage
occupancy and ``pipeline_stall_seconds{stage}`` counts the time each stage
spent as the bottleneck (work ready, depth exhausted), so the slowest
stage is visible at a glance (docs/OBSERVABILITY.md).

All hand-offs are event-driven: blocking ``queue.Queue`` gets woken by a
sentinel on shutdown — no polling timeouts anywhere, so stage hand-off
latency is scheduler latency, not a 50 ms floor.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics
from .. import state as st
from ..statemachine.actions import Events
from . import serial

# Stage handed a sentinel (or companion queue handed one) → exit cleanly.
_SENTINEL = object()
# Handler return value meaning "a companion thread will post the result".
_DEFERRED = object()

# (work-items attribute, stage tag) — the seven categories of the
# reference coordinator, in dispatch-priority order.
STAGES: Tuple[Tuple[str, str], ...] = (
    ("wal_actions", "wal"),
    ("net_actions", "net"),
    ("hash_actions", "hash"),
    ("client_actions", "client"),
    ("app_actions", "app"),
    ("req_store_events", "req_store"),
    ("result_events", "result"),
)

# Pipelined-mode depths: WAL and hash are the stages with real in-flight
# latency (fsync, device round trip) so they get the deepest windows; the
# state machine stays serial (depth 1 — ``status()`` correctness and the
# reference's single-threaded machine both require it).
_PIPELINED_DEPTH: Dict[str, int] = {
    "wal": 4,
    "net": 2,
    "hash": 4,
    "client": 1,
    "app": 2,
    "req_store": 2,
    "result": 1,
}

# The two reference ordering barriers as data — (upstream, downstream)
# stage pairs whose hand-off must stay strictly batch-ordered regardless
# of stage depth.  Every scheduler implementation shares this tuple; the
# autotuner never relaxes a barrier because barriers are ordering
# constraints enforced by the release paths, not depths.
BARRIER_EDGES: Tuple[Tuple[str, str], ...] = (
    ("wal", "net"),  # WAL-before-send (fsync ticket release order)
    ("req_store", "result"),  # reqstore-sync-before-ack
)

# Ceiling for autotuned stage depths.  Past ~16 the admission window, not
# stage depth, is the binding constraint, and unbounded growth would just
# hide a stage that is genuinely too slow.
MAX_STAGE_DEPTH = 16

# Lock discipline (docs/STATIC_ANALYSIS.md): the admission set is touched
# by proposer threads (admit), the result worker (complete) and the
# coordinator (close) — always under the window's condition.
MIRLINT_SHARED_STATE = {
    "AdmissionWindow._outstanding": "_cond",
    "AdmissionWindow._closed": "_cond",
}


@dataclass
class PipelineConfig:
    """Pipeline scheduler tuning.  The zero-arg constructor is the
    pipelined mode; ``PipelineConfig.classic()`` reproduces the reference
    coordinator exactly (depth 1 everywhere, synchronous WAL barrier,
    unsplit hash stage, unbounded admission)."""

    depth: Dict[str, int] = field(
        default_factory=lambda: dict(_PIPELINED_DEPTH)
    )
    # Max proposals admitted but not yet observed committing; None = off.
    admission_window: Optional[int] = 1024
    # Liveness guard: a proposer blocked this long admits anyway (its
    # request may have been superseded and will never commit locally).
    admission_timeout_s: float = 5.0
    # Overlap WAL writes with the previous batch's fsync (requires a WAL
    # exposing ``sync_begin``; degrades to the blocking barrier otherwise).
    async_wal: bool = True
    # Split the hash stage into dispatch + collect threads (requires a
    # hasher exposing ``dispatch_batches``/``collect_batches``; degrades
    # to the one-call ``hash_batches`` handler otherwise).
    split_hash: bool = True
    # Stall-driven depth autotuning (``DepthAutotuner``): the configured
    # depths become starting points; the deepest-stalling stage grows and
    # idle stages shrink, bounded by ``max_depth``.
    autotune: bool = True
    max_depth: int = MAX_STAGE_DEPTH

    @classmethod
    def classic(cls) -> "PipelineConfig":
        return cls(
            depth={tag: 1 for _, tag in STAGES},
            admission_window=None,
            async_wal=False,
            split_hash=False,
            autotune=False,
        )

    def depth_of(self, tag: str) -> int:
        if tag == "result":
            # The deterministic state machine is serial, and status
            # snapshots require no batch in flight.
            return 1
        return max(1, int(self.depth.get(tag, 1)))

    def graph_limit(self) -> int:
        """Depth ceiling for the StageGraph: ``max_depth`` when the
        autotuner may grow stages, otherwise the configured maximum (so
        classic mode keeps exact depth-1 queues)."""
        if self.autotune:
            return max(1, int(self.max_depth))
        return max(self.depth_of(tag) for _, tag in STAGES)


class StageGraph:
    """The shared scheduler state: per-stage depth budgets, in-flight
    occupancy, and stall accounting.  Thread-free and clock-injectable —
    the threaded ``PipelineScheduler`` and both simulation-engine drivers
    (``testengine/sched.py``) run the same graph.

    Invariant every client preserves: a stage's in-flight count only moves
    through ``try_acquire``/``release``, so occupancy never exceeds the
    current depth and depth never exceeds ``limit``.  Queue capacities are
    sized at ``limit`` so the autotuner can grow a depth without resizing
    queues.
    """

    def __init__(
        self,
        depth: Dict[str, int],
        limit: int = MAX_STAGE_DEPTH,
        pinned: Tuple[str, ...] = ("result",),
    ):
        self.stages: Tuple[str, ...] = tuple(tag for _, tag in STAGES)
        self.edges = BARRIER_EDGES
        self.pinned = frozenset(pinned)
        self.limit = max(1, int(limit))
        self._depth = {
            tag: min(max(1, int(depth.get(tag, 1))), self.limit)
            for tag in self.stages
        }
        self._inflight = {tag: 0 for tag in self.stages}
        self._stall_total = {tag: 0.0 for tag in self.stages}
        # tag -> perf_counter() when the stage first had ready work it
        # could not take (depth exhausted); cleared on dispatch.
        self._stalled_since: Dict[str, float] = {}
        self._depth_gauges = {
            tag: metrics.gauge("pipeline_depth", labels={"stage": tag})
            for tag in self.stages
        }
        self._limit_gauges = {
            tag: metrics.gauge("pipeline_depth_limit", labels={"stage": tag})
            for tag in self.stages
        }
        for tag in self.stages:
            self._limit_gauges[tag].set(self._depth[tag])
        self._stall_counters = {
            tag: metrics.counter(
                "pipeline_stall_seconds", labels={"stage": tag}
            )
            for tag in self.stages
        }

    def depth_of(self, tag: str) -> int:
        return self._depth[tag]

    def occupancy(self, tag: str) -> int:
        return self._inflight[tag]

    def try_acquire(self, tag: str, now: Optional[float] = None) -> bool:
        """Take one in-flight slot on ``tag``; on refusal the stage is
        marked stalling (ready work, depth exhausted) until the next
        successful acquire or explicit ``clear_stall``."""
        if self._inflight[tag] >= self._depth[tag]:
            self.note_stalled(tag, now)
            return False
        self._inflight[tag] += 1
        self._depth_gauges[tag].set(self._inflight[tag])
        self.clear_stall(tag, now)
        return True

    def release(self, tag: str) -> None:
        self._inflight[tag] -= 1
        self._depth_gauges[tag].set(self._inflight[tag])

    def note_stalled(self, tag: str, now: Optional[float] = None) -> None:
        if tag not in self._stalled_since:
            self._stalled_since[tag] = (
                time.perf_counter() if now is None else now
            )

    def clear_stall(self, tag: str, now: Optional[float] = None) -> None:
        started = self._stalled_since.pop(tag, None)
        if started is not None:
            if now is None:
                now = time.perf_counter()
            waited = max(0.0, now - started)
            self._stall_total[tag] += waited
            self._stall_counters[tag].inc(waited)

    def stall_seconds(self, tag: str, now: Optional[float] = None) -> float:
        """Cumulative stall time for ``tag``, including any ongoing stall
        (the autotuner reads this; an ongoing stall must count or a stage
        that never un-stalls would never be grown)."""
        total = self._stall_total[tag]
        started = self._stalled_since.get(tag)
        if started is not None:
            if now is None:
                now = time.perf_counter()
            total += max(0.0, now - started)
        return total

    def set_depth(self, tag: str, value: int) -> int:
        """Adjust a stage's depth budget, clamped to [1, limit]; pinned
        stages (the serial state machine) are refused.  Returns the depth
        actually in effect."""
        if tag in self.pinned:
            return self._depth[tag]
        new = min(max(1, int(value)), self.limit)
        self._depth[tag] = new
        self._limit_gauges[tag].set(new)
        return new


class DepthAutotuner:
    """Stall-driven depth control with WaveController-style hysteresis
    (testengine/crypto.py): each ``observe`` reads per-stage stall deltas
    since the previous observation, grows the deepest-stalling stage (×2,
    up to ``graph.limit``) once its delta crosses ``grow_threshold_s``,
    shrinks a stage (÷2) only after ``idle_rounds`` consecutive quiet
    observations, and sleeps ``cooldown_rounds`` after any adjustment so a
    single burst cannot thrash the depths.  Pinned stages are never
    touched, and barriers are unaffected by construction: ``set_depth``
    changes budgets only — the WAL release thread and req_store handler
    keep their strict orderings at any depth."""

    def __init__(
        self,
        graph: StageGraph,
        grow_threshold_s: float = 0.002,
        idle_rounds: int = 4,
        cooldown_rounds: int = 2,
    ):
        self.graph = graph
        self.grow_threshold_s = grow_threshold_s
        self.idle_rounds = idle_rounds
        self.cooldown_rounds = cooldown_rounds
        self._last = {tag: 0.0 for tag in graph.stages}
        self._idle = {tag: 0 for tag in graph.stages}
        self._cooldown = 0
        self._adjust = {
            (tag, direction): metrics.counter(
                "pipeline_autotune_adjustments_total",
                labels={"stage": tag, "direction": direction},
            )
            for tag in graph.stages
            for direction in ("grow", "shrink")
        }

    def observe(
        self, now: Optional[float] = None
    ) -> Optional[Tuple[str, int, int]]:
        """One control step (call on the tick cadence).  Returns the
        adjustment made as ``(stage, old_depth, new_depth)``, or None."""
        graph = self.graph
        deltas: Dict[str, float] = {}
        for tag in graph.stages:
            total = graph.stall_seconds(tag, now)
            deltas[tag] = total - self._last[tag]
            self._last[tag] = total
            # Idle bookkeeping runs every observation, cooldown or not —
            # hysteresis counts real quiet time, not control-enabled time.
            if deltas[tag] <= 0.0 and graph.occupancy(tag) == 0:
                self._idle[tag] += 1
            else:
                self._idle[tag] = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        grow = [
            tag
            for tag in graph.stages
            if tag not in graph.pinned
            and deltas[tag] >= self.grow_threshold_s
            and graph.depth_of(tag) < graph.limit
        ]
        if grow:
            tag = max(grow, key=lambda t: deltas[t])
            old = graph.depth_of(tag)
            new = graph.set_depth(tag, old * 2)
            if new != old:
                self._adjust[(tag, "grow")].inc()
                self._cooldown = self.cooldown_rounds
                self._idle[tag] = 0
                return (tag, old, new)
        for tag in graph.stages:
            if tag in graph.pinned or graph.depth_of(tag) <= 1:
                continue
            if self._idle[tag] >= self.idle_rounds:
                old = graph.depth_of(tag)
                new = graph.set_depth(tag, old // 2)
                self._adjust[(tag, "shrink")].inc()
                self._cooldown = self.cooldown_rounds
                self._idle[tag] = 0
                return (tag, old, new)
        return None


class AdmissionWindow:
    """Bounded end-to-end admission: ``Client.propose`` occupies one slot
    per (client_id, req_no) and the result stage frees slots as their
    commits are observed, so ingress throttles to the slowest pipeline
    stage instead of queueing unboundedly ahead of it."""

    def __init__(self, limit: int, timeout_s: float = 5.0):
        self.limit = max(1, int(limit))
        self.timeout_s = timeout_s
        self._cond = threading.Condition()
        self._outstanding: set = set()
        self._closed = False
        metrics.gauge("admission_window_size").set(self.limit)
        self._occupancy = metrics.gauge("admission_window_outstanding")
        self._stall = metrics.counter(
            "pipeline_stall_seconds", labels={"stage": "admission"}
        )
        self._stall_hist = metrics.histogram(
            "pipeline_admission_stall_seconds"
        )
        self._overflow = metrics.counter("admission_window_overflow_total")

    def admit(self, key) -> None:
        """Block while the window is full; returns once ``key`` occupies a
        slot (or immediately when the window is closed / the wait timed
        out — admission must never cost liveness)."""
        start: Optional[float] = None
        with self._cond:
            while len(self._outstanding) >= self.limit and not self._closed:
                now = time.perf_counter()
                if start is None:
                    start = now
                elif now - start >= self.timeout_s:
                    self._overflow.inc()
                    break
                self._cond.wait(self.timeout_s - (now - start))
            if not self._closed:
                self._outstanding.add(key)
                self._occupancy.set(len(self._outstanding))
        if start is not None:
            waited = time.perf_counter() - start
            self._stall.inc(waited)
            self._stall_hist.observe(waited)

    def complete(self, keys) -> None:
        with self._cond:
            before = len(self._outstanding)
            self._outstanding.difference_update(keys)
            if len(self._outstanding) != before:
                self._occupancy.set(len(self._outstanding))
                self._cond.notify_all()

    def observe_actions(self, actions) -> None:
        """Free the slots of every request committing in this action
        batch (called from the result stage, the only thread that sees
        the action stream)."""
        keys = [
            (req.client_id, req.req_no)
            for action in actions
            if isinstance(action, st.ActionCommit)
            for req in action.batch.requests
        ]
        if keys:
            self.complete(keys)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._outstanding.clear()
            self._occupancy.set(0)
            self._cond.notify_all()


class PipelineScheduler:
    """The generalized coordinator: owns the stage queues, the per-stage
    in-flight accounting, and the WAL-release / hash-collect companion
    threads.  ``Node`` delegates its event loop here."""

    def __init__(
        self,
        node_id: int,
        work_items,
        handlers: Dict[str, Callable],
        notifier,
        snapshot_fn: Callable,
        config: Optional[PipelineConfig] = None,
        on_snapshot: Optional[Callable] = None,
        wal=None,
        request_store=None,
        hasher=None,
    ):
        self.config = config if config is not None else PipelineConfig.classic()
        self.work_items = work_items
        self.notifier = notifier
        self.snapshot_fn = snapshot_fn
        self.on_snapshot = on_snapshot
        self.inbox: "queue.Queue" = queue.Queue()
        self.threads: List[threading.Thread] = []
        self._name = f"node{node_id}"
        self._handlers = dict(handlers)
        self.graph = StageGraph(
            depth={tag: self.config.depth_of(tag) for _, tag in STAGES},
            limit=self.config.graph_limit(),
        )
        self.autotuner: Optional[DepthAutotuner] = (
            DepthAutotuner(self.graph) if self.config.autotune else None
        )
        # Queues are sized at the graph limit, not the starting depth, so
        # the autotuner can widen a stage without resizing; dispatch depth
        # is governed solely by graph.try_acquire.
        self._queues: Dict[str, "queue.Queue"] = {
            tag: queue.Queue(maxsize=self.graph.limit) for _, tag in STAGES
        }

        self.admission: Optional[AdmissionWindow] = None
        if self.config.admission_window:
            self.admission = AdmissionWindow(
                self.config.admission_window,
                self.config.admission_timeout_s,
            )

        self._wal = wal
        self._request_store = request_store
        self._hasher = hasher
        self.wal_async = bool(
            self.config.async_wal
            and wal is not None
            and hasattr(wal, "sync_begin")
        )
        self._wal_release_q: Optional["queue.Queue"] = None
        if self.wal_async:
            self._wal_release_q = queue.Queue(maxsize=self.graph.limit)
            self._handlers["wal"] = self._wal_stage
        self.hash_split = bool(
            self.config.split_hash
            and hasher is not None
            and hasattr(hasher, "dispatch_batches")
            and hasattr(hasher, "collect_batches")
        )
        self._hash_collect_q: Optional["queue.Queue"] = None
        if self.hash_split:
            self._hash_collect_q = queue.Queue(maxsize=self.graph.limit)
            self._handlers["hash"] = self._hash_stage

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for _, tag in STAGES:
            self._spawn(f"{tag}", self._worker, tag, self._handlers[tag])
        if self._wal_release_q is not None:
            self._spawn("wal-release", self._wal_releaser)
        if self._hash_collect_q is not None:
            self._spawn("hash-collect", self._hash_collector)
        self._spawn("coord", self.run)

    def _spawn(self, suffix: str, target: Callable, *args) -> None:
        thread = threading.Thread(
            target=target,
            args=args,
            name=f"{self._name}-{suffix}",
            daemon=True,
        )
        thread.start()
        self.threads.append(thread)

    def observe_result_actions(self, actions) -> None:
        """Result-stage hook: free admission slots for observed commits."""
        if self.admission is not None:
            self.admission.observe_actions(actions)

    # -- stage workers ------------------------------------------------------

    def _worker(self, tag: str, handler: Callable) -> None:
        q = self._queues[tag]
        while True:
            batch = q.get()
            if batch is _SENTINEL or self.notifier.exit_event.is_set():
                return
            try:
                result = handler(batch)
            except BaseException as e:
                self._stage_failed(tag, e)
                return
            if result is not _DEFERRED:
                self.inbox.put((f"{tag}_results", result))

    def _stage_failed(self, tag: str, err: BaseException) -> None:
        if tag == "result":
            self.notifier.set_exit_status(self.snapshot_fn())
        self.notifier.fail(err)
        # Wake the coordinator (blocking get) so shutdown propagates.
        self.inbox.put(("worker_failed", None))

    # Async WAL stage: writes now, fsync ticket waits on the release
    # thread, so the stage worker is immediately free for the next batch.
    def _wal_stage(self, actions):
        net_actions, truncated_at = serial.apply_wal_actions(
            self._wal, actions, request_store=self._request_store
        )
        ticket = self._wal.sync_begin()
        self._wal_release_q.put((ticket, net_actions, truncated_at))
        return _DEFERRED

    def _wal_releaser(self) -> None:
        """Waits fsync tickets strictly in batch order and only then
        releases each batch's WAL-dependent Sends — the WAL-before-send
        barrier as a stage edge."""
        q = self._wal_release_q
        gc = getattr(self._request_store, "gc", None)
        while True:
            item = q.get()
            if item is _SENTINEL or self.notifier.exit_event.is_set():
                return
            ticket, net_actions, truncated_at = item
            try:
                ticket.wait()
                if gc is not None and truncated_at is not None:
                    gc(truncated_at)
            except BaseException as e:
                self._stage_failed("wal", e)
                return
            self.inbox.put(("wal_results", net_actions))

    # Split hash stage: the worker only dispatches (async device enqueue);
    # the collect thread blocks on materialization, so up to ``depth``
    # crypto waves stay in flight.
    def _hash_stage(self, actions):
        hash_actions = []
        for action in actions:
            if not isinstance(action, st.ActionHashRequest):
                raise AssertionError(
                    f"unexpected Hash action type {type(action).__name__}"
                )
            hash_actions.append(action)
        if not hash_actions:
            return Events()
        metrics.histogram("hash_batch_size").observe(len(hash_actions))
        with metrics.timer("hash_dispatch_seconds"):
            handle = self._hasher.dispatch_batches(
                [action.data for action in hash_actions]
            )
        self._hash_collect_q.put((handle, hash_actions))
        return _DEFERRED

    def _hash_collector(self) -> None:
        q = self._hash_collect_q
        while True:
            item = q.get()
            if item is _SENTINEL or self.notifier.exit_event.is_set():
                return
            handle, hash_actions = item
            try:
                digests = self._hasher.collect_batches(handle)
            except BaseException as e:
                self._stage_failed("hash", e)
                return
            if len(digests) != len(hash_actions):
                self._stage_failed(
                    "hash",
                    AssertionError("hasher returned wrong number of digests"),
                )
                return
            events = Events()
            for action, digest in zip(hash_actions, digests):
                events.hash_result(digest, action.origin)
            self.inbox.put(("hash_results", events))

    # -- coordinator --------------------------------------------------------

    def _dispatch_ready(self) -> None:
        """Hand every non-empty category with spare depth to its stage
        (the nil-able-channel pattern, widened from one-in-flight to a
        per-stage budget).  A stage at full depth with ready work is
        *stalling* — the bottleneck — and its stall time is metered."""
        work = self.work_items
        for attr, tag in STAGES:
            batch = getattr(work, attr)
            if len(batch) == 0:
                continue
            if self.graph.try_acquire(tag):
                setattr(work, attr, type(batch)())
                # Never blocks: queued batches <= in-flight <= depth <=
                # graph.limit == queue capacity.
                self._queues[tag].put(batch)

    def run(self) -> None:
        work = self.work_items
        add_result = {
            "wal_results": work.add_wal_results,
            "net_results": work.add_net_results,
            "hash_results": work.add_hash_results,
            "client_results": work.add_client_results,
            "app_results": work.add_app_results,
            "req_store_results": work.add_req_store_results,
            "result_results": work.add_state_machine_results,
        }
        waiting_status: List["queue.Queue"] = []
        health_due = False
        try:
            while True:
                # Status may only be taken while no state-machine batch is
                # in flight: the result worker mutates the machine
                # off-thread.
                if (
                    (waiting_status or health_due)
                    and self.graph.occupancy("result") == 0
                ):
                    snap = self.snapshot_fn()
                    for reply in waiting_status:
                        reply.put(snap)
                    waiting_status.clear()
                    if health_due:
                        health_due = False
                        if self.on_snapshot is not None:
                            self.on_snapshot(snap)
                self._dispatch_ready()
                tag, payload = self.inbox.get()
                if tag == "stop" or self.notifier.exit_event.is_set():
                    return
                if tag == "tick":
                    work.result_events.tick_elapsed()
                    health_due = True
                    if self.autotuner is not None:
                        self.autotuner.observe()
                elif tag == "status":
                    waiting_status.append(payload)
                elif tag == "step_events":
                    work.result_events.concat(payload)
                elif tag == "client_ingress":
                    # Client events injected from outside the pipeline
                    # (propose threads, forwarded-request ingress): same
                    # durability routing as client stage results, but no
                    # stage slot was acquired so none is released —
                    # occupancy would go negative and blind the
                    # autotuner's idle detection.
                    work.add_client_results(payload)
                elif tag in add_result:
                    base = tag[: -len("_results")]
                    add_result[tag](payload)
                    self.graph.release(base)
                else:
                    raise AssertionError(f"unknown inbox tag {tag}")
        except BaseException as e:
            self.notifier.fail(e)
        finally:
            self._shutdown()

    def _shutdown(self) -> None:
        """Wake every blocked thread: close the admission window and drop
        a sentinel in each stage/companion queue.  put_nowait is safe — a
        full queue means its consumer has work ahead of the sentinel, and
        exit_event (already set) stops it at the next item."""
        if self.admission is not None:
            self.admission.close()
        sinks = [self._queues[tag] for _, tag in STAGES]
        sinks.extend(
            q for q in (self._wal_release_q, self._hash_collect_q)
            if q is not None
        )
        for q in sinks:
            try:
                q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
