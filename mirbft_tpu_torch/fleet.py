"""Fleet observability plane: telemetry collection, clock alignment,
trace merging, and trend detection (docs/OBSERVABILITY.md "Fleet plane").

The sharded deployment is a multi-process fleet whose tracing and metrics
planes are strictly node-local; this module is the parent-side aggregator
that turns them into one queryable surface:

- :class:`ClockAligner` — Cristian-style per-link offset estimation from
  pull/report echo timestamps.  Every process stamps trace events with
  its own ``time.perf_counter`` epoch, so raw timestamps from different
  processes are incomparable; the aligner maps each child's clock onto
  the collector's.
- :func:`build_report` — the child-side report builder: one metrics
  snapshot plus the trace-ring delta past the collector's cursor.
- :class:`TelemetryServer` — a standalone KIND_TELEMETRY listener for
  processes without a transport listener of their own (observers).
  Member nodes serve the same frames on their existing transport socket
  (``TcpTransport.start(on_telemetry=...)``).
- :class:`FleetCollector` — the mirnet parent's puller.  Periodically
  exchanges TEL_PULL/TEL_REPORT with every endpoint and maintains a
  rolling ``fleet/`` directory: ``latest.json`` (most recent snapshot
  per node), ``history.json`` (time-series ring), and ``trace.json``
  (the merged Chrome trace, pid = group, tid = node).
- :func:`detect_trends` — history-ring detectors for the leak shapes a
  soak cares about: monotonic RSS growth, fd growth, widening observer
  lag.
- :func:`slo_rows` — the cross-group SLO table behind ``mircat --fleet``
  and ``mirnet --top``.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from mirbft_tpu_torch import metrics as metrics_mod
from mirbft_tpu_torch import tracing
from mirbft_tpu_torch.net import telemetry
from mirbft_tpu_torch.net.framing import (
    KIND_TELEMETRY,
    FrameDecoder,
    FrameError,
    encode_frame,
)

# ---------------------------------------------------------------------------
# Clock alignment


class ClockAligner:
    """Cristian-style offset estimation over a sliding sample window.

    Each sample is one pull/report exchange: the parent sent at ``t0``,
    received at ``t1`` (both parent clock), and the child stamped the
    report at ``child_ts`` (child clock).  Assuming symmetric delay the
    child's stamp happened at the parent-clock midpoint ``(t0 + t1) / 2``,
    so ``offset = child_ts - midpoint`` converts child time to parent
    time by subtraction.  The estimate used is the offset of the
    *lowest-RTT* sample in the window — high-RTT exchanges bound the
    error loosely — and the window keeps the estimate fresh under drift.
    """

    def __init__(self, window: int = 16):
        self._samples: deque = deque(maxlen=window)

    def add(self, t0_us: float, t1_us: float, child_ts_us: float) -> None:
        rtt = max(0.0, float(t1_us) - float(t0_us))
        midpoint = (float(t0_us) + float(t1_us)) / 2.0
        self._samples.append((rtt, float(child_ts_us) - midpoint))

    def __len__(self) -> int:
        return len(self._samples)

    @property
    def offset_us(self) -> float:
        """Best current child-minus-parent offset estimate (0 until the
        first sample)."""
        if not self._samples:
            return 0.0
        return min(self._samples)[1]

    @property
    def rtt_us(self) -> float:
        if not self._samples:
            return 0.0
        return min(self._samples)[0]

    def to_parent(self, child_ts_us: float) -> float:
        return float(child_ts_us) - self.offset_us


# ---------------------------------------------------------------------------
# Child side: report building + the observer-side telemetry listener


def _rss_kb() -> Optional[int]:
    """Current resident set from /proc/self/statm — NOT ru_maxrss, which
    is a high-water mark and would trip the monotonic-growth detector on
    every healthy process."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGESIZE") // 1024
    except (OSError, ValueError, IndexError):
        return None


def _open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def build_report(
    group: Optional[int],
    node_label: str,
    cursor: int,
    registry: Optional[metrics_mod.Registry] = None,
    tracer: Optional[tracing.Tracer] = None,
) -> Dict:
    """One TEL_REPORT body: the child's clock, metrics snapshot, trace
    delta past ``cursor``, and process vitals."""
    reg = registry if registry is not None else metrics_mod.default_registry
    trc = tracer if tracer is not None else tracing.default_tracer
    new_cursor, events, dropped = trc.drain(cursor)
    report: Dict = {
        "ts_us": tracing.wall_clock_us(),
        "group": group,
        "node": node_label,
        "metrics": reg.snapshot(),
        "trace": {
            "cursor": new_cursor,
            "dropped": dropped,
            "events": events,
            "meta": [],
        },
    }
    rss = _rss_kb()
    if rss is not None:
        report["rss_kb"] = rss
    fds = _open_fds()
    if fds is not None:
        report["open_fds"] = fds
    return report


def serve_pull(
    payload: bytes,
    send,
    group: Optional[int],
    node_label: str,
    node_id: int = 0,
    registry: Optional[metrics_mod.Registry] = None,
    tracer: Optional[tracing.Tracer] = None,
) -> bool:
    """Answer one KIND_TELEMETRY payload if it is a TEL_PULL; returns
    whether it was.  Shared by the member-node transport handler and
    :class:`TelemetryServer`."""
    subtype, _from_node, t0_us, body = telemetry.decode(payload)
    if subtype != telemetry.TEL_PULL:
        return False
    cursor = int(telemetry.decode_body(body).get("cursor", 0))
    report = build_report(
        group, node_label, cursor, registry=registry, tracer=tracer
    )
    send(telemetry.encode_report(node_id, t0_us, report))
    return True


class TelemetryServer:
    """Minimal KIND_TELEMETRY listener for listener-less processes.

    Observers have no :class:`TcpTransport`; this serves TEL_PULL on a
    dedicated port so the fleet collector can reach them the same way it
    reaches members."""

    def __init__(
        self,
        host: str,
        port: int,
        group: Optional[int],
        node_label: str,
        registry: Optional[metrics_mod.Registry] = None,
        tracer: Optional[tracing.Tracer] = None,
    ):
        self.group = group
        self.node_label = node_label
        self.registry = registry
        self.tracer = tracer
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self._listener.settimeout(0.2)

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()

    def start(self) -> None:
        accept = threading.Thread(
            target=self._accept_loop, name="telemetry-accept", daemon=True
        )
        accept.start()
        self._threads.append(accept)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for thread in self._threads:
            thread.join(timeout=2)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(0.2)
            reader = threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name="telemetry-rx",
                daemon=True,
            )
            reader.start()
            self._threads.append(reader)

    def _serve_conn(self, conn: socket.socket) -> None:
        decoder = FrameDecoder()

        def send(payload: bytes) -> None:
            conn.sendall(encode_frame(KIND_TELEMETRY, payload))

        try:
            while not self._stop.is_set():
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                for kind, payload in decoder.feed(data):
                    if kind != KIND_TELEMETRY:
                        return  # wrong plane: drop the connection
                    serve_pull(
                        payload,
                        send,
                        self.group,
                        self.node_label,
                        registry=self.registry,
                        tracer=self.tracer,
                    )
        except (FrameError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Parent side: the collector


class _Endpoint:
    __slots__ = (
        "group",
        "label",
        "addr",
        "sock",
        "decoder",
        "cursor",
        "aligner",
        "events",
        "tid",
        "last",
        "reachable",
    )

    def __init__(self, group: int, label: str, addr: Tuple[str, int]):
        self.group = group
        self.label = label
        self.addr = (str(addr[0]), int(addr[1]))
        self.sock: Optional[socket.socket] = None
        self.decoder: Optional[FrameDecoder] = None
        self.cursor = 0
        self.aligner = ClockAligner()
        self.events: deque = deque(maxlen=20000)
        self.tid = 0
        self.last: Optional[Dict] = None
        self.reachable = False


class FleetCollector:
    """Pull-based fleet telemetry aggregator (see module docstring).

    ``endpoints`` is ``[{"group": g, "node": label, "host": h,
    "port": p}, ...]`` — every member node (its transport listen port)
    and every observer (its :class:`TelemetryServer` port).  The
    collector's own clock is :func:`tracing.wall_clock_us`, the same
    domain every child stamps its reports and trace events in, so one
    aligner per endpoint closes the epoch gap.
    """

    # History entries keep only the metric series the SLO table and the
    # trend detectors read — a full per-node snapshot ballooned the ring's
    # JSON dump to >10 ms per flush.  latest.json keeps everything.
    HISTORY_METRIC_PREFIXES = (
        "commit_latency_seconds",
        "observer_lag_batches",
        "pipeline_admission_stall_seconds",
        "net_send_lock_wait_seconds",
        "wal_fsync_seconds",
    )

    def __init__(
        self,
        out_dir,
        endpoints: List[Dict],
        interval_s: float = 1.0,
        history_cap: int = 240,
        trace_every: int = 4,
        registry: Optional[metrics_mod.Registry] = None,
    ):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.interval_s = interval_s
        # The merged trace is an analysis artifact, not a dashboard: it is
        # the expensive file (re-mapping + serializing every retained
        # event), so it lands every ``trace_every``-th flush and always on
        # stop.  latest/history stay fresh every interval.
        self.trace_every = max(1, int(trace_every))
        self._flushes = 0
        self._endpoints = [
            _Endpoint(int(ep["group"]), str(ep["node"]),
                      (ep["host"], ep["port"]))
            for ep in endpoints
        ]
        per_group: Dict[int, int] = {}
        for ep in self._endpoints:
            ep.tid = per_group.get(ep.group, 0)
            per_group[ep.group] = ep.tid + 1
        self.history: deque = deque(maxlen=history_cap)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = registry if registry is not None else metrics_mod.default_registry
        self._pulls = reg.counter("fleet_pulls_total")
        self._pull_timer = reg.histogram("fleet_pull_seconds")
        self._trace_events = reg.counter("fleet_trace_events_total")
        self._trace_dropped = reg.counter("fleet_trace_dropped_total")
        self._registry = reg

    # -- one exchange -------------------------------------------------------

    def _drop_conn(self, ep: _Endpoint) -> None:
        if ep.sock is not None:
            try:
                ep.sock.close()
            except OSError:
                pass
        ep.sock = None
        ep.decoder = None
        ep.reachable = False

    def _exchange(self, ep: _Endpoint, timeout_s: float = 2.0) -> None:
        if ep.sock is None:
            ep.sock = socket.create_connection(ep.addr, timeout=timeout_s)
            ep.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ep.sock.settimeout(timeout_s)
            ep.decoder = FrameDecoder()
        t0 = tracing.wall_clock_us()
        ep.sock.sendall(
            encode_frame(
                KIND_TELEMETRY, telemetry.encode_pull(0, int(t0), ep.cursor)
            )
        )
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                data = ep.sock.recv(1 << 20)
            except socket.timeout:
                continue
            if not data:
                raise OSError("telemetry peer closed the connection")
            for kind, payload in ep.decoder.feed(data):
                if kind != KIND_TELEMETRY:
                    continue
                subtype, _node, echo_t0, body = telemetry.decode(payload)
                if subtype != telemetry.TEL_REPORT:
                    continue
                t1 = tracing.wall_clock_us()
                self.ingest_report(
                    ep, float(echo_t0), t1, telemetry.decode_body(body)
                )
                return
        raise OSError(f"telemetry pull to {ep.addr} timed out")

    def ingest_report(
        self, ep: _Endpoint, t0_us: float, t1_us: float, report: Dict
    ) -> None:
        """Fold one TEL_REPORT body into the endpoint's state.  Public so
        the bench can measure collector cost without sockets."""
        ts_us = float(report.get("ts_us", 0.0))
        if ts_us:
            ep.aligner.add(t0_us, t1_us, ts_us)
        trace = report.get("trace") or {}
        ep.cursor = int(trace.get("cursor", ep.cursor))
        dropped = int(trace.get("dropped", 0))
        if dropped:
            self._trace_dropped.inc(dropped)
        events = trace.get("events") or []
        for ev in events:
            ep.events.append(ev)
        if events:
            self._trace_events.inc(len(events))
        self._registry.gauge(
            "fleet_clock_offset_us", labels={"node": ep.label}
        ).set(ep.aligner.offset_us)
        ep.last = {
            "group": ep.group,
            "metrics": report.get("metrics") or {},
            "rss_kb": report.get("rss_kb"),
            "open_fds": report.get("open_fds"),
            "ts_us": ts_us,
            "offset_us": ep.aligner.offset_us,
            "rtt_us": ep.aligner.rtt_us,
        }
        ep.reachable = True
        self._pulls.inc()

    # -- one full cycle -----------------------------------------------------

    def pull_once(self) -> None:
        with metrics_mod.Timer(self._pull_timer):
            for ep in self._endpoints:
                try:
                    self._exchange(ep)
                except (OSError, FrameError):
                    self._drop_conn(ep)
            self._record_history()
            self.flush()

    def _prune_for_history(self, last: Dict) -> Dict:
        metrics = last.get("metrics") or {}
        kept = {
            k: v
            for k, v in metrics.items()
            if k.startswith(self.HISTORY_METRIC_PREFIXES)
        }
        pruned = dict(last)
        pruned["metrics"] = kept
        return pruned

    def _record_history(self) -> None:
        nodes = {}
        for ep in self._endpoints:
            if ep.last is not None:
                nodes[ep.label] = self._prune_for_history(ep.last)
        if nodes:
            self.history.append(
                {
                    "t_us": tracing.wall_clock_us(),
                    "wall": time.time(),
                    "nodes": nodes,
                }
            )

    def merged_trace(self) -> Dict:
        """The fleet Chrome trace: every endpoint's events mapped onto
        the collector clock, pid = group id, tid = node index within the
        group."""
        meta: List[Dict] = []
        groups_named = set()
        events: List[Dict] = []
        for ep in self._endpoints:
            if ep.group not in groups_named:
                groups_named.add(ep.group)
                meta.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "pid": ep.group,
                        "tid": 0,
                        "args": {"name": f"group-{ep.group}"},
                    }
                )
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": ep.group,
                    "tid": ep.tid,
                    "args": {"name": ep.label},
                }
            )
            offset = ep.aligner.offset_us
            for ev in ep.events:
                out = dict(ev)
                out["ts"] = float(ev.get("ts", 0.0)) - offset
                out["pid"] = ep.group
                out["tid"] = ep.tid
                events.append(out)
        events.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"clock_domain": "fleet"},
        }

    def _write_json(self, name: str, doc) -> None:
        tmp = self.out_dir / (name + ".tmp")
        tmp.write_text(json.dumps(doc, separators=(",", ":")))
        tmp.replace(self.out_dir / name)

    def flush(self, final: bool = False) -> None:
        latest = {
            "wall": time.time(),
            "nodes": {
                ep.label: dict(ep.last, reachable=ep.reachable)
                for ep in self._endpoints
                if ep.last is not None
            },
        }
        self._write_json("latest.json", latest)
        self._write_json("history.json", list(self.history))
        if final or self._flushes % self.trace_every == 0:
            self._write_json("trace.json", self.merged_trace())
        self._flushes += 1

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="fleet-collector", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Flush before dropping connections: _drop_conn marks endpoints
        # unreachable (its meaning on the exchange path), which must not
        # leak into the final persisted snapshot.
        try:
            self.flush(final=True)
        except OSError:
            pass
        for ep in self._endpoints:
            self._drop_conn(ep)

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.pull_once()
            except Exception:
                # The collector must never take the deployment down.
                pass


# ---------------------------------------------------------------------------
# Query surface: metric extraction, SLO rows, trend detection


def _metric_values(snap: Dict, name: str, suffix: str = "") -> List[float]:
    """Values for ``name`` across label blocks: matches ``name<suffix>``
    and ``name{...}<suffix>`` keys in a flat snapshot dict."""
    pat = re.compile(
        re.escape(name) + r"(\{[^}]*\})?" + re.escape(suffix) + r"$"
    )
    return [
        float(v)
        for k, v in snap.items()
        if pat.fullmatch(k) and isinstance(v, (int, float))
    ]


def _median(values: List[float]) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def slo_rows(history: List[Dict]) -> List[Dict]:
    """Per-group SLO rows from a history ring: commit p50 (median across
    members) and p99 (max), observer lag, admission-stall p99, WAL fsync
    share of wall time over the window, and send-lock wait p99."""
    if not history:
        return []
    latest = history[-1]
    earliest = history[0]
    by_group: Dict[int, Dict[str, List]] = {}
    for label, node in latest["nodes"].items():
        group = node.get("group")
        if group is None:
            continue
        snap = node.get("metrics") or {}
        row = by_group.setdefault(
            int(group),
            {"p50": [], "p99": [], "lag": [], "stall": [], "lock": [],
             "fsync_share": [], "mapv": []},
        )
        row["p50"].extend(
            _metric_values(snap, "commit_latency_seconds", "_p50")
        )
        row["p99"].extend(
            _metric_values(snap, "commit_latency_seconds", "_p99")
        )
        row["lag"].extend(_metric_values(snap, "observer_lag_batches"))
        row["mapv"].extend(_metric_values(snap, "map_version"))
        row["stall"].extend(
            _metric_values(
                snap, "pipeline_admission_stall_seconds", "_p99"
            )
        )
        row["lock"].extend(
            _metric_values(snap, "net_send_lock_wait_seconds", "_p99")
        )
        first = (earliest["nodes"].get(label) or {}).get("metrics") or {}
        dt_s = (latest["t_us"] - earliest["t_us"]) / 1e6
        if dt_s > 0:
            now_sum = _metric_values(snap, "wal_fsync_seconds", "_sum")
            then_sum = _metric_values(first, "wal_fsync_seconds", "_sum")
            if now_sum:
                delta = sum(now_sum) - sum(then_sum)
                row["fsync_share"].append(max(0.0, delta) / dt_s * 100.0)
    rows = []
    for group in sorted(by_group):
        agg = by_group[group]
        rows.append(
            {
                "group": group,
                "commit_p50_ms": None if not agg["p50"] else round(
                    _median(agg["p50"]) * 1e3, 3
                ),
                "commit_p99_ms": None if not agg["p99"] else round(
                    max(agg["p99"]) * 1e3, 3
                ),
                "observer_lag": None if not agg["lag"] else max(agg["lag"]),
                "admission_stall_p99_ms": None if not agg["stall"] else round(
                    max(agg["stall"]) * 1e3, 3
                ),
                "send_lock_wait_p99_ms": None if not agg["lock"] else round(
                    max(agg["lock"]) * 1e3, 3
                ),
                "wal_fsync_share_pct": None if not agg["fsync_share"]
                else round(max(agg["fsync_share"]), 2),
                # Routing epoch (docs/SHARDING.md "Elastic resharding"):
                # the newest map any member of the group has installed.
                "map_version": None if not agg["mapv"]
                else int(max(agg["mapv"])),
            }
        )
    return rows


def detect_trends(
    history: List[Dict],
    min_points: int = 6,
    rss_growth_kb: int = 1024,
    fd_growth: int = 8,
    lag_growth: int = 3,
) -> List[Dict]:
    """History-ring trend detectors (informational — they annotate doctor
    output, they do not flip verdicts):

    - ``rss_monotonic_growth``: a node's resident set never decreased
      across the window and grew by >= ``rss_growth_kb``.
    - ``fd_growth``: open fd count never decreased and grew by >=
      ``fd_growth``.
    - ``observer_lag_widening``: an observer's lag gauge never decreased
      and widened by >= ``lag_growth`` batches.
    """
    if len(history) < min_points:
        return []
    window = list(history)[-max(min_points, 2):]
    labels = set()
    for entry in window:
        labels.update(entry["nodes"])
    findings: List[Dict] = []

    def series(label: str, field: str) -> List[float]:
        out = []
        for entry in window:
            node = entry["nodes"].get(label)
            if node is None:
                return []  # gaps: skip this label entirely
            value = node.get(field)
            if value is None:
                return []
            out.append(float(value))
        return out

    def metric_series(label: str, name: str) -> List[float]:
        out = []
        for entry in window:
            node = entry["nodes"].get(label)
            if node is None:
                return []
            values = _metric_values(node.get("metrics") or {}, name)
            if not values:
                return []
            out.append(max(values))
        return out

    def monotone_grew(values: List[float], growth: float) -> bool:
        if len(values) < min_points:
            return False
        if any(b < a for a, b in zip(values, values[1:])):
            return False
        return values[-1] - values[0] >= growth

    for label in sorted(labels):
        rss = series(label, "rss_kb")
        if monotone_grew(rss, rss_growth_kb):
            findings.append(
                {
                    "node": label,
                    "kind": "rss_monotonic_growth",
                    "detail": f"rss {rss[0]:.0f} -> {rss[-1]:.0f} kB over "
                              f"{len(rss)} samples",
                }
            )
        fds = series(label, "open_fds")
        if monotone_grew(fds, fd_growth):
            findings.append(
                {
                    "node": label,
                    "kind": "fd_growth",
                    "detail": f"open fds {fds[0]:.0f} -> {fds[-1]:.0f} over "
                              f"{len(fds)} samples",
                }
            )
        lag = metric_series(label, "observer_lag_batches")
        if monotone_grew(lag, lag_growth):
            findings.append(
                {
                    "node": label,
                    "kind": "observer_lag_widening",
                    "detail": f"lag {lag[0]:.0f} -> {lag[-1]:.0f} batches "
                              f"over {len(lag)} samples",
                }
            )
    return findings


def load_fleet(fleet_dir) -> Dict:
    """Read a collector output directory: ``{"latest": ..., "history":
    [...], "trace": {...}}`` with missing files as empty values."""
    root = Path(fleet_dir)
    out = {"latest": {}, "history": [], "trace": {}}
    for key, name in (
        ("latest", "latest.json"),
        ("history", "history.json"),
        ("trace", "trace.json"),
    ):
        path = root / name
        if path.exists():
            try:
                out[key] = json.loads(path.read_text())
            except ValueError:
                pass
    return out


def trace_timeline(trace_doc: Dict, trace_id_hex: str) -> List[Dict]:
    """Every event in a merged trace carrying the given trace id, sorted
    by aligned timestamp — the per-request causal timeline."""
    matches = []
    for ev in trace_doc.get("traceEvents", []):
        args = ev.get("args") or {}
        if args.get("trace") == trace_id_hex or trace_id_hex in (
            (args.get("traces") or {}).values()
        ):
            matches.append(ev)
    matches.sort(key=lambda e: e.get("ts", 0.0))
    return matches
