"""Incident bundles: cross-node journal slices + deterministic replay.

The diagnosis path of the flight recorder (docs/OBSERVABILITY.md "Flight
recorder"): :func:`capture_incident` cuts a self-contained
``incident-<id>/`` bundle out of a live or finished deployment — every
node's latest-boot journal, its final metrics snapshot, the commit /
checkpoint ground-truth logs, the merged fleet trace when a collector
ran, and a ``manifest.json`` naming the window, the trace id, the health
thresholds, and the fleet clock offsets.  :func:`replay_incident` then
replays the bundled journals through fresh state machines and health
monitors and reconstructs the causal commit / view-change timeline inside
the window — deterministically, so two replays of one bundle are
byte-identical and a bundle is a complete bug report.

``HealthMonitor.capture_hook`` auto-captures via :class:`AnomalyCapture`
(one bundle per anomaly kind per node, ``flight_recorder_captures_total``).

Clock domains: journal record times and anomaly times share the node
host's CLOCK_MONOTONIC (milliseconds / seconds), so ``window_ms`` is in
monotonic milliseconds and slices journals directly.  Fleet spans live in
aligned wall microseconds; the per-endpoint ``clock_offsets_us`` from the
collector ride in the manifest so span tooling can align them, and the
bundled trace is copied whole (it is already ring-bounded).
"""

from __future__ import annotations

import json
import shutil
import threading
import time as _time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics as metrics_mod
from .. import state as st
from .. import status as status_mod
from ..health import Anomaly, HealthMonitor, HealthThresholds
from ..statemachine.machine import MachineState, StateMachine
from . import journal as journal_mod

# The manifest schema, in lockstep with every reader below and enforced
# by mirlint's wire-schema pass (check_incident_manifest): adding a key
# here without teaching the readers — or vice versa — fails lint.
MANIFEST_KEYS = (
    "clock_offsets_us",
    "created_ms",
    "incident_id",
    "nodes",
    "reason",
    "source_root",
    "thresholds",
    "trace_id",
    "window_ms",
)

# Replay-derived stall threshold: an inter-commit gap longer than this
# inside the window counts as a stall finding.
STALL_GAP_MS = 1000.0

_COPY_FILES = ("metrics.prom", "commits.log", "checkpoints.log")


def sample_manifest() -> dict:
    """A fully-populated example manifest (mirlint round-trips this
    against :data:`MANIFEST_KEYS`; tests use it as a fixture)."""
    return {
        "clock_offsets_us": {"g0n0": 0.0, "g0n1": -12.5},
        "created_ms": 1700000000000,
        "incident_id": "n3-watermark_stall",
        "nodes": ["n0", "n1", "n2", "n3"],
        "reason": "watermark_stall",
        "source_root": "/tmp/mirnet-xyz",
        "thresholds": {"stall_observations": 150},
        "trace_id": "00000000000012ab",
        "window_ms": [1000.0, 64000.0],
    }


def _node_label_dirs(root: Path) -> List[Tuple[str, Path]]:
    """``(label, dir)`` for every journaled runtime under a deployment
    dir: nodes as ``n<i>`` (``g<g>n<i>`` inside a group dir) and
    observers as ``obs<i>`` — the labels the fleet plane uses."""
    root = Path(root)
    group_id: Optional[int] = None
    cluster_path = root / "cluster.json"
    if cluster_path.exists():
        try:
            group_id = json.loads(cluster_path.read_text()).get("group_id")
        except ValueError:
            group_id = None
    prefix = f"g{group_id}" if group_id is not None else ""
    out: List[Tuple[str, Path]] = []
    for node_dir in sorted(root.glob("node-*")):
        try:
            node_id = int(node_dir.name.split("-", 1)[1])
        except ValueError:
            continue
        out.append((f"{prefix}n{node_id}", node_dir))
    for obs_dir in sorted(root.glob("observer-*")):
        try:
            obs_idx = int(obs_dir.name.split("-", 1)[1])
        except ValueError:
            continue
        out.append((f"{prefix}obs{obs_idx}", obs_dir))
    return out


def _fleet_clock_offsets(root: Path) -> Dict[str, float]:
    """Per-node ``offset_us`` from the fleet collector's ``latest.json``
    (beside or above the deployment dir); empty when no collector ran."""
    for candidate in (root / "fleet", root.parent / "fleet"):
        latest = candidate / "latest.json"
        if not latest.exists():
            continue
        try:
            doc = json.loads(latest.read_text())
        except ValueError:
            continue
        offsets: Dict[str, float] = {}
        for label in sorted(doc.get("nodes") or {}):
            entry = (doc["nodes"] or {}).get(label) or {}
            if "offset_us" in entry:
                offsets[label] = float(entry["offset_us"])
        return offsets
    return {}


def _copy_latest_boot_journal(node_dir: Path, dest: Path) -> int:
    """Copy the newest boot's journal evidence (segments, or the legacy
    gzip stream) into ``dest``; returns the number of files copied."""
    copied = 0
    segs = journal_mod._segment_files(node_dir / journal_mod.JOURNAL_DIRNAME)
    if segs:
        latest_boot = segs[-1][0]
        jdir = dest / journal_mod.JOURNAL_DIRNAME
        jdir.mkdir(parents=True, exist_ok=True)
        for boot, _, path in segs:
            if boot != latest_boot:
                continue
            try:
                shutil.copy2(path, jdir / path.name)
                copied += 1
            except OSError:
                pass
        return copied
    legacy = sorted(node_dir.glob("events-*.gz"))
    if legacy:
        dest.mkdir(parents=True, exist_ok=True)
        try:
            shutil.copy2(legacy[-1], dest / legacy[-1].name)
            copied += 1
        except OSError:
            pass
    return copied


def capture_incident(
    root,
    window_ms: Tuple[float, float],
    *,
    trace_id: Optional[str] = None,
    reason: str = "manual",
    incident_id: Optional[str] = None,
    out_dir=None,
    registry: Optional[metrics_mod.Registry] = None,
) -> Path:
    """Cut an ``incident-<id>/`` bundle from deployment dir ``root``.

    Copies every node's latest-boot journal plus its metrics / commit /
    checkpoint evidence and the merged fleet trace, then writes
    ``manifest.json`` **last** — its presence is the completeness marker,
    which also makes capture idempotent (an existing complete bundle is
    returned untouched, so concurrent hooks cannot double-capture)."""
    root = Path(root)
    if incident_id is None:
        if trace_id:
            incident_id = f"trace-{trace_id}"
        else:
            incident_id = f"w{int(window_ms[0])}-{int(window_ms[1])}"
    base = Path(out_dir) if out_dir is not None else root / "incidents"
    bundle = base / f"incident-{incident_id}"
    manifest_path = bundle / "manifest.json"
    if manifest_path.exists():
        return bundle
    bundle.mkdir(parents=True, exist_ok=True)

    labels: List[str] = []
    for label, node_dir in _node_label_dirs(root):
        dest = bundle / label
        copied = _copy_latest_boot_journal(node_dir, dest)
        for name in _COPY_FILES:
            src = node_dir / name
            if src.exists():
                dest.mkdir(parents=True, exist_ok=True)
                try:
                    shutil.copy2(src, dest / name)
                    copied += 1
                except OSError:
                    pass
        if copied:
            labels.append(label)

    for candidate in (root / "fleet", root.parent / "fleet"):
        trace_path = candidate / "trace.json"
        if trace_path.exists():
            try:
                shutil.copy2(trace_path, bundle / "trace.json")
            except OSError:
                pass
            break

    thresholds = None
    cluster_path = root / "cluster.json"
    if cluster_path.exists():
        try:
            thresholds = json.loads(cluster_path.read_text()).get("thresholds")
        except ValueError:
            thresholds = None

    manifest = {
        "clock_offsets_us": _fleet_clock_offsets(root),
        # Wall-clock creation stamp: provenance metadata for humans, no
        # replay decision ever reads it.
        # mirlint: allow(wall-clock)
        "created_ms": int(_time.time() * 1000),
        "incident_id": incident_id,
        "nodes": labels,
        "reason": reason,
        "source_root": str(root),
        "thresholds": thresholds,
        "trace_id": trace_id,
        "window_ms": [float(window_ms[0]), float(window_ms[1])],
    }
    manifest_path.write_text(json.dumps(manifest, indent=2, sort_keys=True))
    reg = registry if registry is not None else metrics_mod.default_registry
    reg.counter("flight_recorder_captures_total").inc()
    return bundle


class AnomalyCapture:
    """``HealthMonitor.capture_hook`` implementation: auto-capture one
    incident bundle per anomaly kind (first occurrence wins), windowed
    around the anomaly with lead-in context, after a short settle delay
    so the journal tail past the anomaly lands in the copy.

    Runs in the node process; capture happens on a daemon thread so the
    monitor's emission path never blocks on file copies."""

    def __init__(
        self,
        root,
        node_label: str,
        *,
        max_captures: int = 4,
        settle_s: float = 1.0,
        pre_window_s: float = 15.0,
        post_window_s: float = 2.0,
        registry: Optional[metrics_mod.Registry] = None,
        time_source: Optional[Callable[[], float]] = None,
    ):
        self.root = Path(root)
        self.node_label = node_label
        self.max_captures = max_captures
        self.settle_s = settle_s
        self.pre_window_s = pre_window_s
        self.post_window_s = post_window_s
        self.registry = registry
        # Window timestamps must share the journal's clock domain.  The
        # monitor clock and the JournalRecorder time_source are wired to
        # the same clock (monotonic in mirnet deployments), with the
        # monitor in seconds and the journal in ms — so the anomaly's own
        # time/since values translate directly.  ``time_source`` overrides
        # that assumption when the two domains differ.
        self.time_source = time_source
        self.captured: List[str] = []  # kinds, in emission order

    def __call__(self, anomaly: Anomaly) -> None:
        if anomaly.kind in self.captured:
            return
        if len(self.captured) >= self.max_captures:
            return
        self.captured.append(anomaly.kind)
        if self.time_source is not None:
            # The hook fires at detection, so "now" in the monitor clock
            # is anomaly.time; carry the lead over into the journal
            # domain anchored at the override clock's current value.
            now_ms = float(self.time_source())
            lead_s = max(0.0, float(anomaly.time) - float(anomaly.since))
            window = (
                now_ms - (lead_s + self.pre_window_s) * 1000.0,
                now_ms + self.post_window_s * 1000.0,
            )
        else:
            window = (
                (float(anomaly.since) - self.pre_window_s) * 1000.0,
                (float(anomaly.time) + self.post_window_s) * 1000.0,
            )
        thread = threading.Thread(
            target=self._capture, args=(anomaly.kind, window), daemon=True
        )
        thread.start()

    def _capture(self, kind: str, window: Tuple[float, float]) -> None:
        try:
            if self.settle_s > 0:
                _time.sleep(self.settle_s)
            capture_incident(
                self.root,
                window,
                reason=kind,
                incident_id=f"{self.node_label}-{kind}",
                registry=self.registry,
            )
        except Exception:
            pass  # capture is evidence, never a failure mode


# ---------------------------------------------------------------------------
# Deterministic bundle replay
# ---------------------------------------------------------------------------


def _commit_line(batch) -> str:
    reqs = ",".join(f"{r.client_id}:{r.req_no}" for r in batch.requests)
    return f"{batch.seq_no} {batch.digest.hex()} {reqs}"


def _replay_node(label: str, node_dir: Path, thresholds) -> dict:
    """Replay one bundled node's newest boot: full-boot state machine +
    health monitor run (determinism needs the boot from its first event),
    returning commits, epoch changes, anomalies, and the boot envelope."""
    boots = journal_mod.load_boots(node_dir)
    out = {
        "label": label,
        "commits": [],  # (time_ms, seq, line)
        "epochs": [],  # (time_ms, epoch)
        "anomalies": [],
        "anomaly_kinds": [],
        "dropped": 0,
        "torn": False,
        "last_event_ms": 0.0,
        "error": None,
    }
    if not boots:
        return out
    boot = boots[-1]
    out["dropped"] = boot.dropped
    out["torn"] = boot.torn
    clock = {"t": 0.0}
    monitor = HealthMonitor(
        0,
        registry=metrics_mod.Registry(),
        clock=lambda: clock["t"],
        thresholds=thresholds,
    )
    sm = StateMachine()
    try:
        for record, _trace in boot.records:
            clock["t"] = float(record.time)
            out["last_event_ms"] = float(record.time)
            actions = sm.apply_event(record.state_event)
            monitor.observe_events((record.state_event,), actions)
            for action in actions:
                if isinstance(action, st.ActionCommit):
                    out["commits"].append(
                        (
                            float(record.time),
                            action.batch.seq_no,
                            _commit_line(action.batch),
                        )
                    )
            if sm.state == MachineState.INITIALIZED:
                epoch = sm.epoch_tracker.current_epoch.number
                if not out["epochs"] or out["epochs"][-1][1] != epoch:
                    out["epochs"].append((float(record.time), epoch))
            if isinstance(record.state_event, st.EventTickElapsed):
                monitor.observe_snapshot(
                    status_mod.snapshot(sm), now=float(record.time)
                )
    except Exception as exc:
        out["error"] = f"{type(exc).__name__}: {exc}"
    out["anomalies"] = [
        {
            "kind": a.kind,
            "time_ms": float(a.time),
            "since_ms": float(a.since),
            "peer": a.peer,
        }
        for a in monitor.anomalies
    ]
    out["anomaly_kinds"] = sorted({a.kind for a in monitor.anomalies})
    return out


def _stall_gaps(
    commits: List[Tuple[float, int, str]],
    last_event_ms: float,
    window: Tuple[float, float],
    gap_ms: float,
) -> List[dict]:
    """Inter-commit gaps (including the tail gap to the last recorded
    event) longer than ``gap_ms`` that overlap the window."""
    out: List[dict] = []
    times = [t for t, _, _ in commits]
    edges = list(zip(times, times[1:]))
    if times and last_event_ms > times[-1]:
        edges.append((times[-1], last_event_ms))
    for since, until in edges:
        gap = until - since
        if gap <= gap_ms:
            continue
        if until < window[0] or since > window[1]:
            continue
        out.append({"since_ms": since, "until_ms": until, "gap_ms": gap})
    return out


def replay_incident(bundle, stall_gap_ms: float = STALL_GAP_MS) -> dict:
    """Deterministically replay a captured bundle (module docstring).

    Every bundled node's newest boot replays in full — determinism needs
    the boot from its first event — and only the *reported* timeline is
    filtered to the manifest window.  The result is pure data (print it
    with :func:`format_replay`); two replays of one bundle are identical.
    """
    bundle = Path(bundle)
    manifest = json.loads((bundle / "manifest.json").read_text())
    window = tuple(manifest["window_ms"])
    thresholds = (
        HealthThresholds.from_dict(manifest["thresholds"])
        if manifest.get("thresholds")
        else None
    )

    per_node = []
    for label in manifest["nodes"]:
        node_dir = bundle / label
        if not node_dir.is_dir():
            continue
        per_node.append(_replay_node(label, node_dir, thresholds))

    timeline: List[dict] = []
    stalls: List[dict] = []
    anomaly_kinds: set = set()
    for node in per_node:
        label = node["label"]
        for time_ms, seq, line in node["commits"]:
            if window[0] <= time_ms <= window[1]:
                timeline.append(
                    {
                        "time_ms": time_ms,
                        "node": label,
                        "kind": "commit",
                        "seq": seq,
                        "detail": line,
                    }
                )
        for time_ms, epoch in node["epochs"]:
            if window[0] <= time_ms <= window[1]:
                timeline.append(
                    {
                        "time_ms": time_ms,
                        "node": label,
                        "kind": "epoch",
                        "seq": epoch,
                        "detail": f"epoch {epoch}",
                    }
                )
        for anomaly in node["anomalies"]:
            if window[0] <= anomaly["time_ms"] <= window[1]:
                timeline.append(
                    {
                        "time_ms": anomaly["time_ms"],
                        "node": label,
                        "kind": "anomaly",
                        "seq": 0,
                        "detail": anomaly["kind"],
                    }
                )
        anomaly_kinds.update(node["anomaly_kinds"])
        for stall in _stall_gaps(
            node["commits"], node["last_event_ms"], window, stall_gap_ms
        ):
            stalls.append(dict(stall, node=label))
    timeline.sort(key=lambda e: (e["time_ms"], e["node"], e["kind"], e["seq"]))
    stalls.sort(key=lambda s: (s["since_ms"], s["node"]))

    return {
        "incident_id": manifest["incident_id"],
        "reason": manifest["reason"],
        "trace_id": manifest.get("trace_id"),
        "window_ms": [float(window[0]), float(window[1])],
        "nodes": [
            {
                "label": n["label"],
                "commits": len(n["commits"]),
                "anomaly_kinds": n["anomaly_kinds"],
                "dropped": n["dropped"],
                "torn": n["torn"],
                "error": n["error"],
            }
            for n in per_node
        ],
        "timeline": timeline,
        "stalls": stalls,
        "anomaly_kinds": sorted(anomaly_kinds),
    }


def format_replay(report: dict) -> str:
    """Human-readable rendering of a :func:`replay_incident` result."""
    lines = [
        f"incident {report['incident_id']} "
        f"(reason={report['reason']}, "
        f"window={report['window_ms'][0]:.0f}..{report['window_ms'][1]:.0f}ms)"
    ]
    for node in report["nodes"]:
        extras = []
        if node["dropped"]:
            extras.append(f"dropped={node['dropped']}")
        if node["torn"]:
            extras.append("torn-tail")
        if node["error"]:
            extras.append(f"error={node['error']}")
        suffix = f" [{', '.join(extras)}]" if extras else ""
        lines.append(
            f"  {node['label']}: {node['commits']} commits replayed, "
            f"anomalies={node['anomaly_kinds'] or '-'}{suffix}"
        )
    for event in report["timeline"]:
        lines.append(
            f"  {event['time_ms']:>12.1f}ms {event['node']:>8} "
            f"{event['kind']:>7} {event['detail']}"
        )
    for stall in report["stalls"]:
        lines.append(
            f"  stall: {stall['node']} "
            f"{stall['since_ms']:.1f}..{stall['until_ms']:.1f}ms "
            f"({stall['gap_ms']:.0f}ms without a commit)"
        )
    if not report["timeline"]:
        lines.append("  (no events inside the window)")
    return "\n".join(lines)
