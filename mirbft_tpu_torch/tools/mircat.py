"""mircat — event-log viewer and deterministic replayer.

Rebuild of reference ``cmd/mircat``: reads a recorded event log, filters by
node / event type / step message type, and in ``--interactive`` mode replays
each event through a fresh state machine per node, printing the resulting
actions, optional per-index status snapshots, and per-node replay wall time
(reference main.go:172-227, 429-446).

``--trace OUT.json`` converts the log into a Chrome trace-event file
(Perfetto-loadable, see docs/OBSERVABILITY.md): events replay through fresh
state machines with the tracer clock pinned to each record's *simulated*
timestamp, deriving per-request commit spans and device hash-wave spans in
sim time — offline, from any recorded run.

``--doctor`` replays the log through per-node ``HealthMonitor``s (see
docs/OBSERVABILITY.md "Health plane"): every record feeds the event-stream
detectors, every tick takes a status snapshot, and the result is a health
report — stall windows, view-change timelines, anomalies, and per-peer
fault attribution — for any recorded run, long after it happened.  Exits 1
when anomalies were found (0 on a clean bill), so it doubles as a CI gate.
``--doctor-json OUT.json`` additionally writes the full report as JSON.

Pointing ``--doctor`` at a **mirnet deployment directory** (instead of one
log file) runs :func:`doctor_deployment`: every node's per-boot event logs
(``node-<i>/events-*.gz``) are replayed through a fresh state machine per
boot and one monitor per node, using the thresholds the live run shipped in
``cluster.json``; the replay ledger is then merged with each node's final
``metrics.prom`` fault counters (which cover transport-only faults like
``peer_unreachable`` that never enter the event log).  Truncated logs —
a SIGKILLed node leaves a torn gzip — are tolerated and reported, never
fatal.  This is the judge ``tools/mirnet.py --scenario`` runs verdicts
against (docs/FAULTS.md "Doctor-judgment contract").

Several directories at once — or a sharded root whose ``group-<g>``
children each hold one group's deployment (docs/SHARDING.md) — run
:func:`doctor_sharded` instead: one :func:`doctor_deployment` per group,
aggregated into a single verdict with the fault ledger re-keyed
``<group>/<peer>:<kind>``, healthy only when every group is.

Usage:
    python -m mirbft_tpu_torch.tools.mircat LOG.gz [--node N ...]
        [--event-type TYPE ...] [--step-type TYPE ...]
        [--interactive] [--status-index IDX ...] [--verbose-text]
        [--trace OUT.json] [--doctor] [--doctor-json OUT.json]
    python -m mirbft_tpu_torch.tools.mircat DEPLOY_DIR --doctor
    python -m mirbft_tpu_torch.tools.mircat SHARD_ROOT --doctor
    python -m mirbft_tpu_torch.tools.mircat DIR_A DIR_B ... --doctor
    python -m mirbft_tpu_torch.tools.mircat DEPLOY_DIR --audit
    python -m mirbft_tpu_torch.tools.mircat DEPLOY_DIR --incident \\
        [--trace-id HEX] [--window T0 T1]
    python -m mirbft_tpu_torch.tools.mircat BUNDLE_DIR --incident

``--audit`` is the determinism invariant, continuously enforced on real
deployments (docs/OBSERVABILITY.md "Flight recorder"): every boot's
journal replays through a fresh state machine and the reconstructed
commit/checkpoint stream must byte-match the live ``commits.log`` /
``checkpoints.log``.  Any mismatch is a hard finding (exit 1); torn
tails — SIGKILL mid-write — are clean-cut and reported as notes, never
divergence.  Verdicts land in ``<dir>/audit.json``, which ``--fleet``
surfaces as per-node ``audit=`` rows.

``--incident`` cuts a self-contained ``incident-<id>/`` bundle (journal
slices + spans + metrics + manifest) from a deployment directory and
deterministically replays it, printing the causal commit/view-change
timeline — the same bundles ``HealthMonitor`` anomalies auto-capture.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .. import metrics, tracing
from .. import state as st
from .. import status as status_mod
from ..eventlog import load_boots, read_event_log
from ..health import HealthMonitor, HealthThresholds
from ..statemachine.machine import MachineState, StateMachine
from .textmarshal import compact_text

_EVENT_TYPE_NAMES = {
    "Initialize": st.EventInitialParameters,
    "LoadPersistedEntry": st.EventLoadPersistedEntry,
    "CompleteInitialization": st.EventLoadCompleted,
    "HashResult": st.EventHashResult,
    "CheckpointResult": st.EventCheckpointResult,
    "RequestPersisted": st.EventRequestPersisted,
    "StateTransferComplete": st.EventStateTransferComplete,
    "StateTransferFailed": st.EventStateTransferFailed,
    "Step": st.EventStep,
    "TickElapsed": st.EventTickElapsed,
    "ActionsReceived": st.EventActionsReceived,
}


def _parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="mircat", description="mirbft_tpu_torch event-log viewer/replayer"
    )
    parser.add_argument(
        "log",
        nargs="*",
        help="gzip event log file, or (with --doctor) one or more "
        "deployment directories; a sharded root containing group-* "
        "subdirectories expands to one doctor run per group",
    )
    parser.add_argument(
        "--node", type=int, action="append", help="only events for these node ids"
    )
    parser.add_argument(
        "--event-type",
        action="append",
        choices=sorted(_EVENT_TYPE_NAMES),
        help="only these event types",
    )
    parser.add_argument(
        "--step-type",
        action="append",
        help="only Step events whose message type matches (e.g. Preprepare)",
    )
    parser.add_argument(
        "--interactive",
        action="store_true",
        help="replay events through fresh state machines, printing actions",
    )
    parser.add_argument(
        "--status-index",
        type=int,
        action="append",
        help="print the node's status snapshot after this event index",
    )
    parser.add_argument(
        "--verbose-text",
        action="store_true",
        help="print full event structures instead of compact text",
    )
    parser.add_argument(
        "--trace",
        metavar="OUT.json",
        help="replay and export a Chrome trace-event JSON (sim-time commit "
        "spans and hash-wave spans; load in Perfetto)",
    )
    parser.add_argument(
        "--doctor",
        action="store_true",
        help="replay through per-node health monitors and print a health "
        "report (stall windows, view changes, per-peer faults); exits 1 "
        "if anomalies were detected",
    )
    parser.add_argument(
        "--doctor-json",
        metavar="OUT.json",
        help="with --doctor: also write the full report as JSON",
    )
    parser.add_argument(
        "--audit",
        action="store_true",
        help="divergence audit: replay each boot's journal through a "
        "fresh state machine and byte-compare the reconstructed "
        "commit/checkpoint stream against the live commits.log; any "
        "mismatch is a hard finding (exit 1), torn tails are clean-cut "
        "notes; writes <dir>/audit.json",
    )
    parser.add_argument(
        "--incident",
        action="store_true",
        help="incident replay: with a deployment directory, capture an "
        "incident-<id>/ bundle (slice by --trace-id and/or --window) "
        "and deterministically replay it; with an existing bundle "
        "directory, replay it as-is — printing the causal "
        "commit/view-change timeline",
    )
    parser.add_argument(
        "--window",
        nargs=2,
        type=float,
        metavar=("T0", "T1"),
        help="with --incident: the monotonic-millisecond window to slice "
        "(defaults to the whole recorded run)",
    )
    parser.add_argument(
        "--wal",
        action="store_true",
        help="treat LOG as a group-commit WAL directory: dump/verify the "
        "segments offline (record CRCs, index continuity, torn-tail "
        "report); exits 1 on problems",
    )
    parser.add_argument(
        "--fleet",
        metavar="DIR",
        help="report on a fleet collector output directory (a mirnet "
        "--fleet run's <root>/fleet/, or the root itself): cross-group "
        "SLO table, per-node vitals, trend findings",
    )
    parser.add_argument(
        "--trace-id",
        metavar="HEX",
        help="with --fleet: print the causal timeline of one request — "
        "every span in the merged fleet trace carrying this trace id, "
        "in aligned-clock order; with --incident: name the bundle after "
        "this request and record it in the manifest",
    )
    return parser.parse_args(argv)


def _matches(record: st.RecordedEvent, args: argparse.Namespace) -> bool:
    if args.node and record.node_id not in args.node:
        return False
    if args.event_type:
        wanted = tuple(_EVENT_TYPE_NAMES[name] for name in args.event_type)
        if not isinstance(record.state_event, wanted):
            return False
    if args.step_type:
        if not isinstance(record.state_event, st.EventStep):
            return False
        if type(record.state_event.msg).__name__ not in args.step_type:
            return False
    return True


# ---------------------------------------------------------------------------
# Deployment doctor: judge a whole mirnet run directory
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(-?[0-9.eE+]+|NaN)\s*$"
)
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prom_samples(
    text: str, name: str
) -> List[Tuple[Dict[str, str], float]]:
    """Parse a Prometheus text snapshot into ``[(labels, value), ...]`` for
    one metric name (label-aware, unlike a prefix-sum; used by the doctor
    and the mirnet scenario judge)."""
    out: List[Tuple[Dict[str, str], float]] = []
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        m = _PROM_LINE.match(line)
        if m is None or m.group(1) != name:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        out.append((dict(_PROM_LABEL.findall(m.group(2) or "")), value))
    return out


def _node_prom(node_dir: Path, name: str) -> List[Tuple[Dict[str, str], float]]:
    path = node_dir / "metrics.prom"
    if not path.exists():
        return []
    return parse_prom_samples(path.read_text(), name)


def _fleet_node_traces(root: Path, group_id) -> Dict[int, List[str]]:
    """Best-effort fault attribution from the fleet plane: for each node
    of ``group_id``, the trace ids of the most recent request spans on
    that node in the merged fleet trace (``fleet/trace.json`` beside or
    above the deployment dir).  Empty when no collector ran."""
    if group_id is None:
        return {}
    trace_path = None
    for candidate in (root / "fleet", root.parent / "fleet"):
        if (candidate / "trace.json").exists():
            trace_path = candidate / "trace.json"
            break
    if trace_path is None:
        return {}
    try:
        doc = json.loads(trace_path.read_text())
    except ValueError:
        return {}
    per_node: Dict[int, List[Tuple[float, str]]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("pid") != group_id or ev.get("ph") == "M":
            continue
        trace = (ev.get("args") or {}).get("trace")
        if not trace:
            continue
        per_node.setdefault(int(ev.get("tid", 0)), []).append(
            (float(ev.get("ts", 0.0)), str(trace))
        )
    out: Dict[int, List[str]] = {}
    for node_id, stamped in per_node.items():
        stamped.sort()
        seen: List[str] = []
        for _ts, trace in stamped:
            if trace in seen:
                seen.remove(trace)
            seen.append(trace)
        out[node_id] = seen[-3:]
    return out


def doctor_deployment(
    root, thresholds: Optional[HealthThresholds] = None
) -> dict:
    """Judge a mirnet deployment directory (module docstring).

    Two evidence streams, merged per node:

    * **Replay** — each boot's event log (``node-<i>/events-*.gz``) through
      a fresh state machine and the node's monitor, clock pinned to record
      timestamps.  Gives anomalies, the fault ledger for everything that
      crossed the state machine (suspicion votes, invalid digests), and the
      epoch timeline.
    * **Live counters** — the node's last ``metrics.prom``: covers faults
      the transport attributed without a state-machine event
      (``peer_unreachable``) and live anomalies.  Merged with the replay
      ledger by max per (peer, kind) — the streams overlap on
      state-machine-visible kinds, so summing would double count.

    A torn log (SIGKILL mid-write) terminates that boot's replay and is
    listed in ``truncated_logs``; it never fails the doctor.
    """
    root = Path(root)
    cluster = {}
    cluster_path = root / "cluster.json"
    if cluster_path.exists():
        cluster = json.loads(cluster_path.read_text())
    if thresholds is None:
        thresholds = HealthThresholds.from_dict(cluster.get("thresholds") or {})
    num_nodes = cluster.get("node_count")
    node_traces = _fleet_node_traces(root, cluster.get("group_id"))

    per_node: Dict[int, dict] = {}
    aggregate_faults: Dict[str, float] = {}
    truncated: List[str] = []
    total_anomalies = 0

    for node_dir in sorted(root.glob("node-*")):
        try:
            node_id = int(node_dir.name.split("-", 1)[1])
        except ValueError:
            continue
        clock = {"t": 0.0}
        monitor = HealthMonitor(
            node_id,
            registry=metrics.Registry(),
            clock=lambda: clock["t"],
            thresholds=thresholds,
            num_nodes=num_nodes,
        )
        timeline: List[Tuple[float, int]] = []
        boots = 0
        # load_boots covers both layouts: the flight recorder's segmented
        # journal/ directory and legacy events-*.gz streams.  Torn tails
        # come back clean-cut, reported under truncated_logs as before.
        for boot_log in load_boots(node_dir):
            boots += 1
            sm = StateMachine()
            try:
                for record, _trace in boot_log.records:
                    clock["t"] = float(record.time)
                    actions = sm.apply_event(record.state_event)
                    monitor.observe_events((record.state_event,), actions)
                    if sm.state == MachineState.INITIALIZED:
                        epoch = sm.epoch_tracker.current_epoch.number
                        if not timeline or timeline[-1][1] != epoch:
                            timeline.append((float(record.time), epoch))
                    if isinstance(record.state_event, st.EventTickElapsed):
                        monitor.observe_snapshot(
                            status_mod.snapshot(sm), now=float(record.time)
                        )
            except Exception as exc:  # mid-boot replay break (pruned head)
                truncated.append(
                    f"{node_dir.name} boot {boot_log.boot}: {exc!r}"
                )
            if boot_log.error:
                truncated.append(boot_log.error)
            elif boot_log.torn:
                truncated.append(
                    f"{node_dir.name} boot {boot_log.boot}: torn tail "
                    f"(clean-cut)"
                )

        live_faults: Dict[Tuple[int, str], float] = {}
        for labels, value in _node_prom(node_dir, "peer_faults_total"):
            if "peer" in labels and "kind" in labels:
                key = (int(labels["peer"]), labels["kind"])
                live_faults[key] = live_faults.get(key, 0.0) + value
        live_anomalies: Dict[str, float] = {}
        for labels, value in _node_prom(node_dir, "anomalies_total"):
            if "kind" in labels and value:
                live_anomalies[labels["kind"]] = (
                    live_anomalies.get(labels["kind"], 0.0) + value
                )

        merged: Dict[Tuple[int, str], float] = {}
        for key in set(monitor.faults) | set(live_faults):
            merged[key] = max(
                float(monitor.faults.get(key, 0)), live_faults.get(key, 0.0)
            )
        report = monitor.report()
        node_anomalies = max(
            report["anomaly_count"], int(sum(live_anomalies.values()))
        )
        total_anomalies += node_anomalies
        for (peer, kind), count in merged.items():
            agg_key = f"{peer}:{kind}"
            aggregate_faults[agg_key] = aggregate_faults.get(agg_key, 0.0) + count
        per_node[node_id] = {
            "healthy": node_anomalies == 0 and not merged,
            "anomaly_count": node_anomalies,
            "anomaly_kinds": sorted(
                {a.kind for a in monitor.anomalies} | set(live_anomalies)
            ),
            "faults": {f"{p}:{k}": c for (p, k), c in sorted(merged.items())},
            "max_epoch": max((e for _, e in timeline), default=0),
            "epoch_timeline": [{"time": t, "epoch": e} for t, e in timeline],
            "boots": boots,
            "stall_windows": report["stall_windows"],
            "observations": report["observations"],
            "recent_traces": node_traces.get(node_id, []),
        }

    healthy = total_anomalies == 0 and not aggregate_faults
    return {
        "root": str(root),
        "healthy": healthy,
        "anomaly_count": total_anomalies,
        "faults": dict(sorted(aggregate_faults.items())),
        "per_node": per_node,
        "truncated_logs": truncated,
    }


def _print_deployment_report(report: dict) -> None:
    for node_id in sorted(report["per_node"]):
        node = report["per_node"][node_id]
        print(
            f"node {node_id}: "
            f"{'HEALTHY' if node['healthy'] else 'UNHEALTHY'} "
            f"({node['anomaly_count']} anomalies, {node['boots']} boots, "
            f"max_epoch={node['max_epoch']})"
        )
        for kind in node["anomaly_kinds"]:
            print(f"  anomaly kind: {kind}")
        # The trace column: the requests most recently in flight on this
        # node per the fleet trace — what a fault likely interrupted.
        traces = node.get("recent_traces") or []
        trace_col = f" trace={traces[-1]}" if traces else ""
        for key, count in node["faults"].items():
            peer, kind = key.split(":", 1)
            print(f"  fault: peer {peer} {kind} x{count:g}{trace_col}")
    for line in report["truncated_logs"]:
        print(f"truncated log (tolerated): {line}")
    print(
        f"verdict: {'HEALTHY' if report['healthy'] else 'UNHEALTHY'} "
        f"({report['anomaly_count']} anomalies, "
        f"{len(report['faults'])} fault keys across "
        f"{len(report['per_node'])} nodes)"
    )


def _group_map_version(group_dir: Path) -> Optional[int]:
    """Newest routing-map version any member of the group has installed,
    from the per-node ``metrics.prom`` ledgers (the ``map_version``
    gauge); ``None`` for pre-resharding deployments that never exported
    the gauge."""
    versions = [
        value
        for node_dir in sorted(group_dir.glob("node-*"))
        for _labels, value in _node_prom(node_dir, "map_version")
    ]
    return int(max(versions)) if versions else None


def _map_skew_findings(versions: Dict) -> List[str]:
    """Flag groups whose installed map is older than one cutover behind
    the fleet's newest — one behind is a rollout in flight, two or more
    means a group missed a reshard entirely (docs/SHARDING.md "Elastic
    resharding")."""
    known = [v for v in versions.values() if v is not None]
    if not known:
        return []
    newest = max(known)
    return [
        f"group {label} map_version {version} is "
        f"{newest - version} cutovers behind the fleet head {newest}"
        for label, version in sorted(versions.items(), key=str)
        if version is not None and newest - version > 1
    ]


def _sharded_group_dirs(path: Path) -> List[Tuple[str, Path]]:
    """``(label, deployment_dir)`` pairs for one doctor input path.

    A sharded mirnet root (``--groups``) holds one full deployment
    directory per group under ``group-<g>/``; expand it so every group
    is judged independently.  A plain deployment directory is a single
    unlabelled group of its own.
    """
    groups = sorted(
        (d for d in path.glob("group-*") if d.is_dir()),
        key=lambda d: int(d.name.split("-", 1)[1]),
    )
    if groups:
        return [(d.name, d) for d in groups]
    return [(path.name, path)]


def doctor_sharded(
    paths, thresholds: Optional[HealthThresholds] = None
) -> dict:
    """Judge several deployment directories as one sharded verdict.

    Each input path expands via :func:`_sharded_group_dirs` (a sharded
    root becomes its ``group-*`` children) and runs through
    :func:`doctor_deployment` unchanged — groups are independent
    consensus instances, so per-group thresholds come from each group's
    own ``cluster.json``.  The aggregate is healthy only when every
    group is, and the fault ledger is re-keyed ``<group>/<peer>:<kind>``
    so cross-group collisions stay distinguishable.
    """
    per_group: Dict[str, dict] = {}
    faults: Dict[str, float] = {}
    map_versions: Dict[str, Optional[int]] = {}
    anomaly_count = 0
    truncated: List[str] = []
    for path in paths:
        for label, group_dir in _sharded_group_dirs(Path(path)):
            report = doctor_deployment(group_dir, thresholds=thresholds)
            per_group[label] = report
            map_versions[label] = _group_map_version(group_dir)
            anomaly_count += report["anomaly_count"]
            truncated.extend(report["truncated_logs"])
            for key, count in report["faults"].items():
                faults[f"{label}/{key}"] = faults.get(f"{label}/{key}", 0.0) + count
    return {
        "roots": [str(p) for p in paths],
        "healthy": all(r["healthy"] for r in per_group.values()),
        "anomaly_count": anomaly_count,
        "faults": dict(sorted(faults.items())),
        "per_group": per_group,
        "map_versions": map_versions,
        "map_skew": _map_skew_findings(map_versions),
        "truncated_logs": truncated,
    }


def _print_sharded_report(report: dict) -> None:
    for label in report["per_group"]:
        group = report["per_group"][label]
        version = (report.get("map_versions") or {}).get(label)
        version_col = "" if version is None else f", map_version {version}"
        print(
            f"=== {label}: "
            f"{'HEALTHY' if group['healthy'] else 'UNHEALTHY'} "
            f"({group['anomaly_count']} anomalies, "
            f"{len(group['per_node'])} nodes{version_col}) ==="
        )
        _print_deployment_report(group)
    for line in report.get("map_skew") or []:
        print(f"map skew: {line}")
    print(
        f"sharded verdict: "
        f"{'HEALTHY' if report['healthy'] else 'UNHEALTHY'} "
        f"({report['anomaly_count']} anomalies, "
        f"{len(report['faults'])} fault keys across "
        f"{len(report['per_group'])} groups)"
    )


# ---------------------------------------------------------------------------
# Divergence audit: replayed journal vs live commit/checkpoint ground truth
# ---------------------------------------------------------------------------


def _read_log_lines(path: Path) -> List[str]:
    if not path.exists():
        return []
    return [ln for ln in path.read_text().splitlines() if ln]


def _commit_line(batch) -> str:
    reqs = ",".join(f"{r.client_id}:{r.req_no}" for r in batch.requests)
    return f"{batch.seq_no} {batch.digest.hex()} {reqs}"


def audit_node(node_dir) -> dict:
    """Continuously-enforced determinism invariant for one node dir:
    replay every journaled boot through a fresh state machine and
    byte-compare the reconstructed commit/checkpoint stream against the
    live ``commits.log`` / ``checkpoints.log``.

    Verdicts: ``clean`` (everything reconstructed matches), ``divergent``
    (any byte mismatch — a hard finding), ``gapped`` (overflow dropped
    events, replay is not faithful, compare skipped), ``pruned``
    (retention removed the boot's head, replay cannot initialize),
    ``no-journal``.  Torn tails are clean-cut by construction and only
    noted — a crash is evidence, never divergence."""
    from ..groups.reshard import RESHARD_CONTROL_CLIENT, parse_commit_line

    node_dir = Path(node_dir)
    live_commits: Dict[int, str] = {}
    cutover_markers = 0
    for line in _read_log_lines(node_dir / "commits.log"):
        try:
            live_commits[int(line.split(" ", 1)[0])] = line
        except ValueError:
            continue
        # Reshard cutover markers are ordinary committed requests from
        # the reserved control client; replay reconstructs them like any
        # other batch, so they are counted, never flagged.
        if any(
            cid == RESHARD_CONTROL_CLIENT
            for cid, _rno in parse_commit_line(line)[1]
        ):
            cutover_markers += 1
    live_max = max(live_commits, default=0)
    live_checkpoints: Dict[int, str] = {}
    for line in _read_log_lines(node_dir / "checkpoints.log"):
        try:
            seq_txt, digest_hex = line.split(" ", 1)
            live_checkpoints[int(seq_txt)] = digest_hex.strip()
        except ValueError:
            continue

    divergences: List[str] = []
    notes: List[str] = []
    boots = load_boots(node_dir)
    gapped = False
    pruned = False
    compared = 0
    for boot in boots:
        where = f"boot {boot.boot}"
        if boot.torn:
            notes.append(f"{where}: torn tail (clean-cut)")
        if boot.error:
            notes.append(f"{where}: {boot.error}")
        if boot.dropped:
            gapped = True
            notes.append(
                f"{where}: {boot.dropped} events dropped under overflow; "
                f"replay not faithful, compare skipped"
            )
            continue
        if boot.pruned:
            pruned = True
            notes.append(
                f"{where}: head pruned by retention; compare skipped"
            )
            continue

        # Observer journals carry the applied stream directly.
        for seq, line in boot.applies:
            compared += 1
            live = live_commits.get(seq)
            if live is None:
                if seq < live_max:
                    divergences.append(
                        f"{where}: applied seq {seq} missing from live "
                        f"commits.log"
                    )
                continue
            if live != line:
                divergences.append(
                    f"{where}: seq {seq} diverges: journal {line!r} vs "
                    f"live {live!r}"
                )

        if not boot.records:
            continue
        sm = StateMachine()
        try:
            for record, _trace in boot.records:
                actions = sm.apply_event(record.state_event)
                for action in actions:
                    if isinstance(action, st.ActionCommit):
                        compared += 1
                        seq = action.batch.seq_no
                        line = _commit_line(action.batch)
                        live = live_commits.get(seq)
                        if live is None:
                            # Tolerate tail loss only: the journal can be
                            # ahead of a log torn by SIGKILL, but a hole
                            # before the live head is hard divergence.
                            if seq < live_max:
                                divergences.append(
                                    f"{where}: replayed seq {seq} missing "
                                    f"from live commits.log"
                                )
                            continue
                        if live != line:
                            divergences.append(
                                f"{where}: seq {seq} diverges: replay "
                                f"{line!r} vs live {live!r}"
                            )
                event = record.state_event
                if (
                    isinstance(event, st.EventCheckpointResult)
                    and len(event.value) == 32
                    and event.seq_no in live_checkpoints
                ):
                    compared += 1
                    if event.value.hex() != live_checkpoints[event.seq_no]:
                        divergences.append(
                            f"{where}: checkpoint {event.seq_no} diverges: "
                            f"replay {event.value.hex()} vs live "
                            f"{live_checkpoints[event.seq_no]}"
                        )
        except Exception as exc:
            notes.append(f"{where}: replay stopped: {exc!r}")

    if divergences:
        verdict = "divergent"
    elif not boots:
        verdict = "no-journal"
    elif gapped and compared == 0:
        verdict = "gapped"
    elif pruned and compared == 0:
        verdict = "pruned"
    else:
        verdict = "clean"
    return {
        "verdict": verdict,
        "boots": len(boots),
        "compared": compared,
        "cutover_markers": cutover_markers,
        "divergences": divergences,
        "notes": notes,
    }


def audit_deployment(root, write_json: bool = True) -> dict:
    """Audit every node (and observer) of one deployment directory and —
    by default — persist the verdicts to ``<root>/audit.json``, the file
    ``mircat --fleet`` reads for its ``audit=`` rows."""
    from ..eventlog.incident import _node_label_dirs

    root = Path(root)
    per_node: Dict[str, dict] = {}
    for label, node_dir in _node_label_dirs(root):
        per_node[label] = audit_node(node_dir)
    divergence_count = sum(
        len(node["divergences"]) for node in per_node.values()
    )
    report = {
        "root": str(root),
        "clean": divergence_count == 0,
        "divergence_count": divergence_count,
        "per_node": per_node,
    }
    if write_json:
        try:
            (root / "audit.json").write_text(
                json.dumps(report, indent=2, sort_keys=True)
            )
        except OSError:
            pass  # read-only deployment dir: verdict still printed
    return report


def audit_sharded(paths) -> dict:
    """One :func:`audit_deployment` per group (same expansion as the
    doctor), aggregated; per-group ``audit.json`` files are written so
    each group's fleet view finds its own verdicts, plus a combined one
    at each sharded root."""
    per_group: Dict[str, dict] = {}
    for path in paths:
        for label, group_dir in _sharded_group_dirs(Path(path)):
            per_group[label] = audit_deployment(group_dir)
    combined = {
        "roots": [str(p) for p in paths],
        "clean": all(r["clean"] for r in per_group.values()),
        "divergence_count": sum(
            r["divergence_count"] for r in per_group.values()
        ),
        "per_group": per_group,
    }
    for path in paths:
        root = Path(path)
        if (root / "shard.json").exists() or list(root.glob("group-*")):
            merged: Dict[str, dict] = {}
            for group in sorted(per_group):
                merged.update(per_group[group]["per_node"])
            try:
                (root / "audit.json").write_text(
                    json.dumps(
                        {
                            "root": str(root),
                            "clean": combined["clean"],
                            "divergence_count": combined["divergence_count"],
                            "per_node": merged,
                        },
                        indent=2,
                        sort_keys=True,
                    )
                )
            except OSError:
                pass
    return combined


def _print_audit_report(report: dict) -> None:
    groups = report.get("per_group") or {"": report}
    for group_label in sorted(groups):
        group = groups[group_label]
        prefix = f"{group_label}: " if group_label else ""
        for label in sorted(group["per_node"]):
            node = group["per_node"][label]
            print(
                f"{prefix}{label}: {node['verdict'].upper()} "
                f"({node['boots']} boots, {node['compared']} compared)"
            )
            for line in node["divergences"]:
                print(f"  divergence: {line}")
            for line in node["notes"]:
                print(f"  note: {line}")
    print(
        f"audit verdict: {'CLEAN' if report['clean'] else 'DIVERGENT'} "
        f"({report['divergence_count']} divergences)"
    )


def _print_wal_report(report: dict) -> None:
    print(f"wal dir: {report['dir']}")
    print(f"low index: {report['low_index']}")
    header = f"{'segment':<24} {'records':>8} {'first':>8} {'last':>8} {'bytes':>10} {'valid':>10}  status"
    print(header)
    print("-" * len(header))
    for seg in report["segments"]:
        first = seg["first_index"] if seg["first_index"] is not None else "-"
        last = seg["last_index"] if seg["last_index"] is not None else "-"
        print(
            f"{seg['name']:<24} {seg['records']:>8} {first:>8} {last:>8} "
            f"{seg['bytes']:>10} {seg['valid_bytes']:>10}  {seg['status']}"
        )
    print(f"live records (>= low index): {report['live_records']}")
    if report["problems"]:
        print("problems:")
        for problem in report["problems"]:
            print(f"  - {problem}")
    else:
        print("no problems found")


# ---------------------------------------------------------------------------
# Fleet query surface: SLO tables and per-request causal timelines
# ---------------------------------------------------------------------------


def _fleet_dir(path: Path) -> Path:
    """Accept the deployment root or the ``fleet/`` directory itself."""
    if (path / "fleet" / "latest.json").exists():
        return path / "fleet"
    return path


def _fmt_cell(value) -> str:
    return "-" if value is None else f"{value:g}"


def fleet_report(fleet_dir, trace_id: Optional[str] = None) -> int:
    """``--fleet``: print the cross-group SLO table, trend findings, and
    (with ``--trace-id``) one request's causal timeline from the merged
    fleet trace.  Exits 2 when the directory has no collector output."""
    from .. import fleet as fleet_mod

    root = _fleet_dir(Path(fleet_dir))
    doc = fleet_mod.load_fleet(root)
    if not doc["latest"] and not doc["history"]:
        print(f"mircat: no fleet collector output under {root}",
              file=sys.stderr)
        return 2

    rows = fleet_mod.slo_rows(doc["history"])
    print(f"fleet dir: {root}")
    header = (
        f"{'group':>5} {'commit p50 ms':>14} {'commit p99 ms':>14} "
        f"{'obs lag':>8} {'stall p99 ms':>13} {'lock p99 ms':>12} "
        f"{'fsync %':>8} {'map ver':>8}"
    )
    print(header)
    print("-" * len(header))
    for row in rows:
        print(
            f"{row['group']:>5} {_fmt_cell(row['commit_p50_ms']):>14} "
            f"{_fmt_cell(row['commit_p99_ms']):>14} "
            f"{_fmt_cell(row['observer_lag']):>8} "
            f"{_fmt_cell(row['admission_stall_p99_ms']):>13} "
            f"{_fmt_cell(row['send_lock_wait_p99_ms']):>12} "
            f"{_fmt_cell(row['wal_fsync_share_pct']):>8} "
            f"{_fmt_cell(row.get('map_version')):>8}"
        )
    if not rows:
        print("(no history samples yet)")
    for line in _map_skew_findings(
        {row["group"]: row.get("map_version") for row in rows}
    ):
        print(f"map skew: {line}")

    findings = fleet_mod.detect_trends(doc["history"])
    for finding in findings:
        print(
            f"trend: {finding['node']} {finding['kind']}: "
            f"{finding['detail']}"
        )

    if trace_id:
        # tid -> node label from the merged trace's thread_name metadata,
        # so the timeline reads g0n1, not a bare thread number.
        names: Dict[Tuple[int, int], str] = {}
        for ev in doc["trace"].get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") == "thread_name":
                names[(ev.get("pid"), ev.get("tid"))] = (
                    (ev.get("args") or {}).get("name", "")
                )
        timeline = fleet_mod.trace_timeline(doc["trace"], trace_id)
        print(f"trace {trace_id}: {len(timeline)} spans")
        for ev in timeline:
            where = names.get(
                (ev.get("pid"), ev.get("tid")),
                f"{ev.get('pid')}/{ev.get('tid')}",
            )
            dur = ev.get("dur")
            dur_txt = f" dur={dur / 1000.0:.3f}ms" if dur is not None else ""
            print(
                f"  {ev.get('ts', 0.0) / 1000.0:>12.3f}ms "
                f"{where:>10} {ev.get('name')}{dur_txt}"
            )
        if not timeline:
            return 1

    # The correctness plane in the same view: last `mircat --audit`
    # verdict per node (audit.json lives at the deployment root, one
    # level above fleet/).
    audit_doc = None
    audit_path = root.parent / "audit.json"
    if audit_path.exists():
        try:
            audit_doc = json.loads(audit_path.read_text())
        except ValueError:
            audit_doc = None
    if audit_doc and audit_doc.get("per_node"):
        for label in sorted(audit_doc["per_node"]):
            verdict = audit_doc["per_node"][label].get("verdict", "-")
            print(f"  {label} audit={verdict}")
    else:
        print("  audit=- (no audit.json; run mircat --audit <root>)")
    return 0


def _incident_cli(args: argparse.Namespace) -> int:
    """``--incident``: replay an existing bundle, or capture one from a
    deployment directory first (module docstring)."""
    from ..eventlog.incident import (
        capture_incident,
        format_replay,
        replay_incident,
    )

    if len(args.log) != 1 or not Path(args.log[0]).is_dir():
        print("mircat: --incident requires one directory (a deployment "
              "root or an incident bundle)", file=sys.stderr)
        return 2
    path = Path(args.log[0])
    if (path / "manifest.json").exists():
        bundle = path
    else:
        window = (
            (float(args.window[0]), float(args.window[1]))
            if args.window
            # No window: slice nothing out — the whole recorded run.
            else (0.0, 1e15)
        )
        bundle = capture_incident(
            path, window, trace_id=args.trace_id, reason="manual"
        )
        print(f"bundle -> {bundle}")
    print(format_replay(replay_incident(bundle)))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse_args(argv)

    if args.fleet:
        return fleet_report(args.fleet, trace_id=args.trace_id)

    if not args.log:
        print("mircat: need a log file or deployment directory "
              "(or --fleet DIR)", file=sys.stderr)
        return 2

    if args.incident:
        return _incident_cli(args)

    if args.audit:
        if not all(Path(p).is_dir() for p in args.log):
            print("mircat: --audit requires deployment directories",
                  file=sys.stderr)
            return 2
        expanded = [
            pair for p in args.log for pair in _sharded_group_dirs(Path(p))
        ]
        if len(expanded) == 1 and expanded[0][1] == Path(args.log[0]):
            report = audit_deployment(args.log[0])
        else:
            report = audit_sharded(args.log)
        _print_audit_report(report)
        return 0 if report["clean"] else 1

    if args.wal:
        from ..storage import wal_segment_report

        if len(args.log) != 1 or not Path(args.log[0]).is_dir():
            print("mircat: --wal requires one WAL directory", file=sys.stderr)
            return 2
        report = wal_segment_report(args.log[0])
        _print_wal_report(report)
        return 0 if report["ok"] else 1

    if any(Path(p).is_dir() for p in args.log):
        if not all(Path(p).is_dir() for p in args.log):
            print(
                "mircat: cannot mix log files and directories",
                file=sys.stderr,
            )
            return 2
        if not (args.doctor or args.doctor_json):
            print(
                "mircat: directory input requires --doctor, --audit, or "
                "--incident",
                file=sys.stderr,
            )
            return 2
        # One plain deployment dir keeps the classic single-deployment
        # report; multiple dirs or a sharded root (group-* children)
        # aggregate per group.
        expanded = [
            pair for p in args.log for pair in _sharded_group_dirs(Path(p))
        ]
        if len(expanded) == 1 and expanded[0][1] == Path(args.log[0]):
            report = doctor_deployment(args.log[0])
            _print_deployment_report(report)
        else:
            report = doctor_sharded(args.log)
            _print_sharded_report(report)
        if args.doctor_json:
            with open(args.doctor_json, "w") as f:
                json.dump(report, f, indent=2)
            print(f"doctor report -> {args.doctor_json}")
        return 0 if report["healthy"] else 1

    if len(args.log) != 1:
        print(
            "mircat: multiple inputs are only supported with --doctor "
            "directories",
            file=sys.stderr,
        )
        return 2

    machines: Dict[int, StateMachine] = defaultdict(StateMachine)
    replay_time: Dict[int, float] = defaultdict(float)
    status_indexes: Set[int] = set(args.status_index or [])

    # --trace replays every event (like --interactive, without the action
    # printing) with the tracer clock pinned to each record's simulated
    # timestamp, so derived spans land in the sim clock domain.
    do_replay = args.interactive or bool(args.trace) or args.doctor
    tracer = None
    span_trackers: Dict[int, tracing.CommitSpanTracker] = {}
    wave_trackers: Dict[int, tracing.HashWaveTracker] = {}
    if args.trace:
        sim_clock = {"t": 0.0}
        tracer = tracing.Tracer(
            capacity=1 << 20,
            clock=lambda: sim_clock["t"],
            enabled=True,
            clock_domain="sim",
        )

    # --doctor: per-node monitors with the clock pinned to each record's
    # simulated timestamp and a private registry (offline analysis must not
    # pollute the process-global metrics).  Each tick record triggers one
    # snapshot observation — the same cadence as the live wirings.
    doctor_monitors: Dict[int, HealthMonitor] = {}
    doctor_epochs: Dict[int, List[Tuple[float, int]]] = {}
    doctor_registry = metrics.Registry() if args.doctor else None
    doctor_clock = {"t": 0.0}

    log_path = args.log[0]
    with open(log_path, "rb") as f:
        for index, record in enumerate(read_event_log(f)):
            shown = _matches(record, args)
            # --trace / --doctor without --interactive are pure analysis
            # modes: no event listing.
            if shown and (
                args.interactive or not (args.trace or args.doctor)
            ):
                text = (
                    repr(record.state_event)
                    if args.verbose_text
                    else compact_text(record.state_event)
                )
                print(f"[{index}] node={record.node_id} time={record.time} {text}")

            if do_replay:
                sm = machines[record.node_id]
                if tracer is not None:
                    sim_clock["t"] = float(record.time)
                start = time.perf_counter()
                actions = sm.apply_event(record.state_event)
                replay_time[record.node_id] += time.perf_counter() - start
                if tracer is not None:
                    node_id = record.node_id
                    spans = span_trackers.get(node_id)
                    if spans is None:
                        tracer.name_process(node_id, f"node{node_id}")
                        spans = span_trackers[node_id] = (
                            tracing.CommitSpanTracker(
                                tracer, node_id, registry=metrics.Registry()
                            )
                        )
                        wave_trackers[node_id] = tracing.HashWaveTracker(
                            tracer, node_id
                        )
                    events = (record.state_event,)
                    spans.observe(events, actions)
                    wave_trackers[node_id].observe(events, actions)
                if args.doctor:
                    node_id = record.node_id
                    doctor_clock["t"] = float(record.time)
                    monitor = doctor_monitors.get(node_id)
                    if monitor is None:
                        monitor = doctor_monitors[node_id] = HealthMonitor(
                            node_id,
                            registry=doctor_registry,
                            clock=lambda: doctor_clock["t"],
                        )
                        doctor_epochs[node_id] = []
                    monitor.observe_events((record.state_event,), actions)
                    if sm.state == MachineState.INITIALIZED:
                        epoch = sm.epoch_tracker.current_epoch.number
                        timeline = doctor_epochs[node_id]
                        if not timeline or timeline[-1][1] != epoch:
                            timeline.append((float(record.time), epoch))
                    if isinstance(record.state_event, st.EventTickElapsed):
                        monitor.observe_snapshot(
                            status_mod.snapshot(sm), now=float(record.time)
                        )
                if shown and args.interactive:
                    for action in actions:
                        print(f"        -> {compact_text(action)}")
                if index in status_indexes and args.interactive:
                    print(status_mod.snapshot(sm).pretty())

    if args.interactive:
        for node_id in sorted(replay_time):
            print(
                f"node {node_id} replay time: "
                f"{replay_time[node_id] * 1000:.1f} ms"
            )
    if tracer is not None:
        tracer.export(args.trace)
        commits = sum(t.committed for t in span_trackers.values())
        waves = sum(t.waves for t in wave_trackers.values())
        print(
            f"trace: {len(tracer)} events ({commits} commit spans, "
            f"{waves} hash waves) -> {args.trace}"
        )
    if args.doctor:
        return _doctor_report(args, doctor_monitors, doctor_epochs)
    return 0


def _doctor_report(
    args: argparse.Namespace,
    monitors: Dict[int, HealthMonitor],
    epochs: Dict[int, List[Tuple[float, int]]],
) -> int:
    """Print the offline health report; exit 1 if any anomaly was found."""
    total_anomalies = 0
    aggregate_faults: Dict[Tuple[int, str], int] = {}
    per_node = {}
    for node_id in sorted(monitors):
        monitor = monitors[node_id]
        report = monitor.report()
        report["epoch_timeline"] = [
            {"time": t, "epoch": e} for t, e in epochs.get(node_id, [])
        ]
        per_node[node_id] = report
        total_anomalies += report["anomaly_count"]
        for (peer, kind), count in monitor.faults.items():
            key = (peer, kind)
            aggregate_faults[key] = aggregate_faults.get(key, 0) + count

        print(
            f"node {node_id}: "
            f"{'HEALTHY' if report['healthy'] else 'UNHEALTHY'} "
            f"({report['anomaly_count']} anomalies, "
            f"{report['observations']} observations)"
        )
        for anomaly in monitor.anomalies:
            print(f"  {anomaly.describe()}")
        for window in report["stall_windows"]:
            until = (
                f"{window['until']:g}"
                if window["until"] is not None
                else "end-of-log"
            )
            print(
                f"  stall window: {window['since']:g}..{until} "
                f"(low_watermark={window['low_watermark']})"
            )
        timeline = epochs.get(node_id, [])
        if len(timeline) > 1:
            changes = " -> ".join(
                f"{e}@{t:g}" for t, e in timeline
            )
            print(f"  view changes: {changes}")

    if aggregate_faults:
        print("peer faults (all nodes):")
        for (peer, kind), count in sorted(aggregate_faults.items()):
            print(f"  peer {peer}: {kind} x{count}")

    healthy = total_anomalies == 0
    print(
        f"verdict: {'HEALTHY' if healthy else 'UNHEALTHY'} "
        f"({total_anomalies} anomalies across {len(monitors)} nodes)"
    )
    if args.doctor_json:
        with open(args.doctor_json, "w") as f:
            json.dump(
                {
                    "log": args.log[0],
                    "healthy": healthy,
                    "anomaly_count": total_anomalies,
                    "peer_faults": {
                        f"{peer}:{kind}": count
                        for (peer, kind), count in sorted(
                            aggregate_faults.items()
                        )
                    },
                    "per_node": per_node,
                },
                f,
                indent=2,
            )
        print(f"doctor report -> {args.doctor_json}")
    return 0 if healthy else 1


if __name__ == "__main__":
    sys.exit(main())
