"""Scheduler drivers for the two simulation engines (L2).

``processor/pipeline.py`` defines the one scheduler contract — the
``StageGraph`` (stages + bounded depths + ``BARRIER_EDGES``) and the
stall-driven ``DepthAutotuner``.  The threaded ``Node`` runtime implements
it with worker threads; this module implements it twice more for the
engines whose step loops are single-threaded:

* ``SimStagePipeline`` drives the testengine ``EventQueue``/``Recording``
  loop.  The **simulated schedule is never touched** — event insertion
  order, latencies, and step counts stay bit-identical to the serial
  driver (the differential suite asserts it).  What the pipeline governs
  is HOST execution: how many scheduled-but-unfired hash batches may
  prefetch into device waves (the hash stage's depth budget), when a
  partial wave launches early (a strictly-future next event means the
  host has sim-time the device can use), and how long fire-time collects
  block on the device (metered as ``pipeline_stall_seconds{stage=hash}``
  and fed back to the autotuner).

* ``FastStageDriver`` surfaces the native engine's step loop as scheduler
  stages.  The engine slice is the pinned serial ``result`` stage; the
  device hash-mirror waves ride the shared hash stage as a **rolling
  window**: at most ``depth_of("hash")`` waves stay un-collected, and the
  oldest wave collects (and digest-verifies) as the window slides —
  incremental verification instead of one trailing collect-all, with the
  blocked collect time metered as the hash stage's stall.

Neither driver owns threads; both run on the caller's loop, which is why
the shared graph needs no locks here (single-threaded access per driver,
matching the ``StageGraph`` acquire/release discipline).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..processor.pipeline import (
    STAGES,
    DepthAutotuner,
    PipelineConfig,
    StageGraph,
)


def _build_graph(config: PipelineConfig) -> StageGraph:
    return StageGraph(
        depth={tag: config.depth_of(tag) for _, tag in STAGES},
        limit=config.graph_limit(),
    )


class SimStagePipeline:
    """Stage-graph driver for ``Recording.step()``: bounded, stall-metered
    crypto prefetch over the shared hash stage, schedule-preserving by
    construction (hooks only ever touch the hash plane and the graph,
    never the event queue)."""

    def __init__(
        self,
        hash_plane,
        event_queue,
        config: Optional[PipelineConfig] = None,
    ):
        self.config = config if config is not None else PipelineConfig()
        self.graph = _build_graph(self.config)
        self.autotuner: Optional[DepthAutotuner] = (
            DepthAutotuner(self.graph) if self.config.autotune else None
        )
        self.plane = hash_plane
        self.queue = event_queue
        # id(batch) -> node_id for batches holding a hash-stage slot
        # between schedule time and fire time.  The Actions object is
        # pinned by its pending SimEvent for exactly that interval, so the
        # id cannot be reused while tracked.
        self._held: Dict[int, int] = {}

    # -- schedule-time (the dispatch half) ----------------------------------

    def on_hash_scheduled(self, node_id: int, batch) -> None:
        """A hash batch was scheduled (its process event is in the queue).
        Prefetch it into the device wave if the hash stage has spare
        depth; otherwise the refusal is metered as a stall and the batch
        simply hashes at fire time — either way the schedule is
        unchanged."""
        plane = self.plane
        if not self.graph.try_acquire("hash"):
            return
        # mirlint: allow(id-ordering) — identity cache, never ordered
        self._held[id(batch)] = node_id
        if plane is None:
            return
        plane.enqueue([a.data for a in batch])
        # Lull fill: a strictly-future next event means the host is about
        # to "wait" in simulated time — launch the partial wave now so the
        # device works through the gap (chained with any full waves the
        # enqueue already launched).
        nxt = self.queue.peek_time()
        if (
            nxt is not None
            and nxt > self.queue.fake_time
            and plane.pending_count()
        ):
            plane.launch_partial()

    def on_node_reset(self, node_id: int) -> None:
        """A node restarted: its pending events were dropped, so any hash
        slots its scheduled batches held must be returned."""
        dropped = [
            key for key, holder in self._held.items() if holder == node_id
        ]
        for key in dropped:
            del self._held[key]
            self.graph.release("hash")

    # -- fire-time (the collect half) ---------------------------------------

    def before_hash_fire(self, batch) -> None:
        """About to run the fire-time collect: if the device is still
        executing this batch's wave, the coming block is a hash-stage
        stall (the autotuner's grow signal — a deeper prefetch window
        would have started this wave earlier)."""
        plane = self.plane
        if (
            plane is not None
            and plane.device
            and not plane.poll([a.data for a in batch])
        ):
            self.graph.note_stalled("hash")

    def after_hash_fire(self, batch) -> None:
        self.graph.clear_stall("hash")
        # mirlint: allow(id-ordering) — identity cache, never ordered
        node_id = self._held.pop(id(batch), None)
        if node_id is not None:
            self.graph.release("hash")

    def on_hash_deferred(self) -> None:
        """defer_unready re-scheduled an unready batch: device behind —
        the same grow signal as a blocking fire-time collect."""
        self.graph.note_stalled("hash")

    # -- control ------------------------------------------------------------

    def on_tick(self) -> None:
        if self.autotuner is not None:
            self.autotuner.observe()


class FastStageDriver:
    """Stage-graph driver for ``FastRecording``: the native engine's step
    loop as scheduler stages.  Wave slots are acquired lazily to cover the
    wrapper's in-flight dispatch list; ``hash_window_over`` returning True
    is the caller's cue to collect the oldest wave (the rolling window),
    and that blocked collect is exactly the stall interval the graph
    meters."""

    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config if config is not None else PipelineConfig()
        self.graph = _build_graph(self.config)
        self.autotuner: Optional[DepthAutotuner] = (
            DepthAutotuner(self.graph) if self.config.autotune else None
        )
        self._wave_slots = 0

    # -- hash stage: rolling wave window ------------------------------------

    def hash_window_over(self, inflight_waves: int) -> bool:
        """Grow the acquired slot count to cover ``inflight_waves``; True
        while the hash stage's depth budget is exhausted — the caller must
        collect (and release) the oldest wave before asking again."""
        while self._wave_slots < inflight_waves:
            if self.graph.try_acquire("hash"):
                self._wave_slots += 1
            else:
                return True
        return False

    def wave_collected(self) -> None:
        if self._wave_slots > 0:
            self._wave_slots -= 1
            self.graph.release("hash")

    def hash_window_reset(self) -> None:
        """A collect-all drained every in-flight wave (finalize, timeout,
        device pause): return every held slot."""
        while self._wave_slots > 0:
            self.wave_collected()
        self.graph.clear_stall("hash")

    # -- result stage: engine slices ----------------------------------------

    def slice_begin(self) -> None:
        self.graph.try_acquire("result")

    def slice_end(self) -> None:
        self.graph.release("result")
        if self.autotuner is not None:
            self.autotuner.observe()

    # -- device pauses ------------------------------------------------------

    def device_stall_begin(self) -> None:
        self.graph.note_stalled("hash")

    def device_stall_end(self) -> None:
        self.graph.clear_stall("hash")
