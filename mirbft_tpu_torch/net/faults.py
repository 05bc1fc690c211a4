"""Wire-level fault injection for the socket transport.

netem-style per-peer-pair fault schedules for :class:`~.tcp.TcpTransport`:
an outbound frame can be delayed, dropped, duplicated, reordered,
truncated, bit-corrupted, or blocked entirely (partition), per (src, dst)
link, with a deterministic seeded schedule.  The injector sits *between*
``send``'s frame encoding and the per-peer queue, so everything downstream
— sender threads, reconnect/backoff, the receiver's FrameDecoder poison
contract — is exercised exactly as a hostile network would exercise it.

The config object (:class:`FaultPlan`) is JSON round-trippable so
``tools/mirnet.py`` can ship one to each node process via ``cluster.json``
and rewrite ``faults.json`` mid-run for partition/heal choreography
(:meth:`FaultInjector.reconfigure`).

Observability: every injected fault counts in
``net_faults_injected_total{kind}`` and corruption additionally in
``net_frames_corrupted_total`` (docs/OBSERVABILITY.md), which is what makes
injected faults machine-checkable against the doctor's attribution
(docs/FAULTS.md "Doctor-judgment contract").

Determinism: one ``random.Random`` per (seed, src, dst) link — the same
plan over the same frame sequence injects the same faults, so scenario
failures replay.
"""

from __future__ import annotations

import heapq
import random
import struct
import threading
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics as metrics_mod
from .framing import FRAME_HEADER_LEN

# Shared-state declaration for mirlint's lock-discipline pass: submit()
# runs on node worker threads while reconfigure() runs on the control
# thread, so every attribute below may only be touched under its lock
# (docs/STATIC_ANALYSIS.md).
MIRLINT_SHARED_STATE = {
    "FaultInjector._plan": "_lock",
    "FaultInjector._held": "_lock",
    "FaultInjector._rngs": "_lock",
    "DelayScheduler._heap": "_cond",
    "DelayScheduler._counter": "_cond",
    "DelayScheduler._stopped": "_cond",
    "DelayScheduler._thread": "_cond",
}

# Injected-fault kinds (the `kind` label of net_faults_injected_total).
INJECT_KINDS = (
    "drop",
    "delay",
    "duplicate",
    "reorder",
    "truncate",
    "corrupt",
    "partition",
    # Active byzantine behaviors (net/byzantine.py) share the counter.
    "equivocate",
    "replay",
    "mangler_drop",
    "mangler_delay",
    "mangler_duplicate",
)


# ---------------------------------------------------------------------------
# Corruption corpus: every way the injector damages a frame, reusable as
# table-driven fuzz seeds for the FrameDecoder poison contract
# (tests/test_faults.py).
# ---------------------------------------------------------------------------

_HEADER_U32 = struct.Struct(">I")

CORRUPTION_KINDS = (
    "bit_flip_payload",
    "bit_flip_header",
    "bad_magic",
    "bad_version",
    "bad_kind",
    "oversize_length",
    "undersize_length",
    "bad_crc",
    "truncate_header",
    "truncate_payload",
)


def corrupt_frame(kind: str, frame: bytes, rng: random.Random) -> bytes:
    """Return a damaged copy of ``frame`` (one encoded frame).  Every kind
    yields bytes the receiving FrameDecoder must reject with FrameError
    (connection dropped) or legitimately starve on (truncation) — never
    anything that crashes the process."""
    buf = bytearray(frame)
    if kind == "bit_flip_payload":
        if len(buf) > FRAME_HEADER_LEN:
            pos = rng.randrange(FRAME_HEADER_LEN, len(buf))
        else:  # null payload: damage the CRC field instead
            pos = rng.randrange(FRAME_HEADER_LEN - 4, FRAME_HEADER_LEN)
        buf[pos] ^= 1 << rng.randrange(8)
    elif kind == "bit_flip_header":
        pos = rng.randrange(FRAME_HEADER_LEN)
        buf[pos] ^= 1 << rng.randrange(8)
    elif kind == "bad_magic":
        buf[0] ^= 0xFF
    elif kind == "bad_version":
        buf[2] = 0xEE
    elif kind == "bad_kind":
        buf[3] = 0x7F
    elif kind == "oversize_length":
        buf[4:8] = _HEADER_U32.pack(0xFFFFFFF0)
    elif kind == "undersize_length":
        # Lies short: the CRC check runs over the wrong byte range.
        buf[4:8] = _HEADER_U32.pack(max(0, len(frame) - FRAME_HEADER_LEN - 1))
    elif kind == "bad_crc":
        buf[8:12] = _HEADER_U32.pack(
            _HEADER_U32.unpack(bytes(buf[8:12]))[0] ^ 0xDEADBEEF
        )
    elif kind == "truncate_header":
        del buf[rng.randrange(1, FRAME_HEADER_LEN) :]
    elif kind == "truncate_payload":
        keep = FRAME_HEADER_LEN + rng.randrange(
            max(1, len(frame) - FRAME_HEADER_LEN)
        )
        del buf[keep:]
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return bytes(buf)


# ---------------------------------------------------------------------------
# Config objects
# ---------------------------------------------------------------------------


@dataclass
class FaultProfile:
    """netem-style schedule for one directed link.  Percentages are
    per-frame probabilities in [0, 100]; latency is milliseconds."""

    drop_pct: float = 0.0  # frame silently discarded
    delay_ms: float = 0.0  # fixed added latency
    jitter_ms: float = 0.0  # extra uniform latency in [0, jitter_ms]
    duplicate_pct: float = 0.0  # frame delivered twice
    reorder_pct: float = 0.0  # frame held back behind the next one
    truncate_pct: float = 0.0  # frame cut mid-stream
    corrupt_pct: float = 0.0  # frame bit-corrupted (random CORRUPTION_KINDS)
    partition: bool = False  # link blocked entirely (dial + drain fail)

    def active(self) -> bool:
        return self.partition or any(
            getattr(self, f.name) for f in fields(self) if f.name != "partition"
        )

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultProfile":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class FaultPlan:
    """One node's injection schedule: a default profile plus per-link
    overrides keyed ``(src, dst)``.  JSON shape (``as_dict``)::

        {"seed": 7, "default": {...}, "links": {"0->3": {...}}}
    """

    seed: int = 0
    default: FaultProfile = field(default_factory=FaultProfile)
    links: Dict[Tuple[int, int], FaultProfile] = field(default_factory=dict)

    def profile_for(self, src: int, dst: int) -> FaultProfile:
        return self.links.get((src, dst), self.default)

    def as_dict(self) -> dict:
        return {
            "seed": self.seed,
            "default": self.default.as_dict(),
            "links": {
                f"{src}->{dst}": prof.as_dict()
                for (src, dst), prof in sorted(self.links.items())
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        links = {}
        for key, prof in d.get("links", {}).items():
            src, _, dst = key.partition("->")
            links[(int(src), int(dst))] = FaultProfile.from_dict(prof)
        return cls(
            seed=int(d.get("seed", 0)),
            default=FaultProfile.from_dict(d.get("default", {})),
            links=links,
        )


# ---------------------------------------------------------------------------
# Delay scheduler (shared with net/byzantine.py)
# ---------------------------------------------------------------------------


class DelayScheduler:
    """Lazy single-thread heap scheduler: ``schedule(delay_s, fn)`` runs
    ``fn()`` on the scheduler thread after ``delay_s``.  The thread starts
    on first use, so zero-rate injectors cost nothing."""

    def __init__(self, name: str = "fault-delay"):
        self._name = name
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._counter = 0
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def schedule(self, delay_s: float, fn: Callable[[], None]) -> None:
        with self._cond:
            if self._stopped:
                return
            self._counter += 1
            heapq.heappush(
                self._heap, (time.monotonic() + delay_s, self._counter, fn)
            )
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and (
                    not self._heap
                    or self._heap[0][0] > time.monotonic()
                ):
                    if self._heap:
                        self._cond.wait(
                            timeout=max(
                                0.0, self._heap[0][0] - time.monotonic()
                            )
                        )
                    else:
                        self._cond.wait(timeout=0.5)
                if self._stopped:
                    return
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:
                pass  # delivery raced a transport shutdown

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._heap.clear()
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------


class FaultInjector:
    """Deterministic per-link wire-fault injector (module docstring).

    The transport binds its raw enqueue via :meth:`bind`; ``submit`` then
    stands in for the direct enqueue on every outbound frame.  Thread
    safety: ``submit`` runs on node worker threads, ``reconfigure`` on a
    control thread — both take the lock; delivery callbacks run unlocked
    (the transport's enqueue is itself synchronized)."""

    def __init__(
        self,
        node_id: int,
        plan: Optional[FaultPlan] = None,
        registry: Optional[metrics_mod.Registry] = None,
    ):
        self.node_id = node_id
        self._plan = plan if plan is not None else FaultPlan()
        self._registry = (
            registry if registry is not None else metrics_mod.default_registry
        )
        self._deliver: Optional[Callable[[int, bytes], None]] = None
        self._lock = threading.Lock()
        self._rngs: Dict[int, random.Random] = {}
        self._held: Dict[int, bytes] = {}  # reorder hold slot per dest
        self._scheduler = DelayScheduler(name=f"net{node_id}-faults")
        self._corrupted = self._registry.counter("net_frames_corrupted_total")

    def bind(self, deliver: Callable[[int, bytes], None]) -> None:
        self._deliver = deliver

    def _count(self, kind: str) -> None:
        self._registry.counter(
            "net_faults_injected_total", labels={"kind": kind}
        ).inc()

    def _rng(self, dest: int) -> random.Random:
        # Must lock: concurrent first-sends to distinct dests race the
        # dict insert, and reconfigure() swaps _plan out from under the
        # seed read.
        with self._lock:
            rng = self._rngs.get(dest)
            if rng is None:
                rng = self._rngs[dest] = random.Random(
                    (self._plan.seed * 1000003) ^ (self.node_id << 20) ^ dest
                )
            return rng

    def reconfigure(self, plan: FaultPlan) -> None:
        """Swap the schedule mid-run (partition/heal choreography).  Held
        reorder frames flush immediately so a heal never strands traffic."""
        with self._lock:
            self._plan = plan
            held, self._held = self._held, {}
        if self._deliver is not None:
            for dest, frame in held.items():
                self._deliver(dest, frame)

    def link_blocked(self, dest: int) -> bool:
        """True while the (self → dest) link is partitioned; the transport
        refuses to dial and fails ``_drain``, so the outage is a *real* TCP
        outage (backoff, ``peer_unreachable`` attribution) rather than a
        silent blackhole the UP gauge would lie about."""
        with self._lock:
            return self._plan.profile_for(self.node_id, dest).partition

    def submit(self, dest: int, frame: bytes) -> None:
        """Run one outbound frame through the link's schedule."""
        deliver = self._deliver
        if deliver is None:
            raise AssertionError("FaultInjector.bind was never called")
        with self._lock:
            prof = self._plan.profile_for(self.node_id, dest)
            if not prof.active():
                release = self._held.pop(dest, None)
            else:
                release = None
        if release is not None:
            deliver(dest, release)
        if not prof.active():
            deliver(dest, frame)
            return

        rng = self._rng(dest)
        if prof.partition:
            # Counted at injection; the frame would only rot in a queue the
            # blocked sender can never drain.
            self._count("partition")
            return
        if prof.drop_pct and rng.random() * 100.0 < prof.drop_pct:
            self._count("drop")
            return
        if prof.corrupt_pct and rng.random() * 100.0 < prof.corrupt_pct:
            frame = corrupt_frame(rng.choice(CORRUPTION_KINDS), frame, rng)
            self._count("corrupt")
            self._corrupted.inc()
        elif prof.truncate_pct and rng.random() * 100.0 < prof.truncate_pct:
            frame = frame[: rng.randrange(1, max(2, len(frame)))]
            self._count("truncate")
            self._corrupted.inc()

        delay_s = 0.0
        if prof.delay_ms or prof.jitter_ms:
            delay_s = (
                prof.delay_ms + rng.random() * prof.jitter_ms
            ) / 1000.0
            if delay_s > 0:
                self._count("delay")

        if prof.reorder_pct and rng.random() * 100.0 < prof.reorder_pct:
            # Hold this frame back; it rides behind the next one.
            with self._lock:
                held = self._held.get(dest)
                self._held[dest] = frame
            self._count("reorder")
            if held is None:
                return
            frame = held  # previous holdee goes out now, behind one frame
            held = None
        else:
            with self._lock:
                held = self._held.pop(dest, None)

        def out(f: bytes) -> None:
            if delay_s > 0:
                self._scheduler.schedule(delay_s, lambda: deliver(dest, f))
            else:
                deliver(dest, f)

        out(frame)
        if held is not None:
            out(held)
        if prof.duplicate_pct and rng.random() * 100.0 < prof.duplicate_pct:
            self._count("duplicate")
            dup_delay = delay_s + rng.random() * max(
                prof.jitter_ms, 1.0
            ) / 1000.0
            self._scheduler.schedule(dup_delay, lambda: deliver(dest, frame))

    def stop(self) -> None:
        self._scheduler.stop()
