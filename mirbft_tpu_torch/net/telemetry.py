"""KIND_TELEMETRY subframe codec: the fleet observability plane's wire
format (docs/OBSERVABILITY.md "Fleet plane").

Three subtypes ride one frame kind, mirroring the KIND_GROUP registry in
``groups/ship.py`` so mirlint's wire check can hold constants, registry,
and samples in lockstep:

- ``TEL_PULL`` (parent -> child): request one metrics + trace-ring delta.
  The header's u64 field is ``t0_us``, the parent's clock at send time,
  echoed back verbatim for Cristian-style offset estimation; the JSON
  body carries the parent's trace-ring ``cursor`` for this child.
- ``TEL_REPORT`` (child -> parent): the reply.  The header's u64 field
  echoes the pull's ``t0_us``; the JSON body carries the child's own
  clock reading (``ts_us``), its ``Registry.snapshot()``, and the drained
  trace-ring delta past the requested cursor.
- ``TEL_ANNOUNCE`` (member -> member): best-effort trace-id binding
  propagation.  A node serving a traced client submission pushes the
  ``(client_id, req_no) -> trace_id`` binding to its group peers so every
  replica's ``CommitSpanTracker`` can stamp the shared id — the header's
  u64 field is unused (zero).

Subframe layout::

    subtype 1 byte   TEL_PULL / TEL_REPORT / TEL_ANNOUNCE
    node    4 bytes  big-endian sender node id
    clock   8 bytes  big-endian u64 microseconds (semantics per subtype)
    body    JSON (UTF-8), possibly empty

The body is JSON rather than a packed struct on purpose: reports carry an
open-ended metrics snapshot whose key set grows with every instrument, and
the pull path is off the hot path (one exchange per node per collector
interval), so schema agility wins over bytes here.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

from mirbft_tpu_torch.net.framing import FrameError

# Declarative subtype registry: mirlint's telemetry wire check walks the
# TEL_* constants and this dict and asserts they agree (tools/mirlint.py).
TEL_PULL = 0
TEL_REPORT = 1
TEL_ANNOUNCE = 2

SUBTYPE_NAMES = {
    TEL_PULL: "tel_pull",
    TEL_REPORT: "tel_report",
    TEL_ANNOUNCE: "tel_announce",
}

_SUB_HEADER = struct.Struct(">BIQ")  # subtype, node id, u64 microseconds


def encode(subtype: int, node_id: int, clock_us: int, body: bytes = b"") -> bytes:
    if subtype not in SUBTYPE_NAMES:
        raise FrameError(f"unknown telemetry subtype {subtype}")
    return _SUB_HEADER.pack(subtype, node_id, clock_us) + body


def decode(payload: bytes) -> Tuple[int, int, int, bytes]:
    """``(subtype, node_id, clock_us, body)`` from a KIND_TELEMETRY
    payload.  Raises :class:`FrameError` on truncation or an unknown
    subtype — the caller drops the connection, never the process."""
    if len(payload) < _SUB_HEADER.size:
        raise FrameError(
            f"telemetry subframe of {len(payload)} bytes is shorter than "
            f"its {_SUB_HEADER.size}-byte header"
        )
    subtype, node_id, clock_us = _SUB_HEADER.unpack_from(payload)
    if subtype not in SUBTYPE_NAMES:
        raise FrameError(f"unknown telemetry subtype {subtype}")
    return subtype, node_id, clock_us, payload[_SUB_HEADER.size:]


def _json_body(doc: Dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def encode_pull(node_id: int, t0_us: int, cursor: int) -> bytes:
    """Parent's pull: ``t0_us`` is the parent clock at send (echoed back),
    ``cursor`` the trace-ring position the parent has already drained."""
    return encode(TEL_PULL, node_id, t0_us, _json_body({"cursor": cursor}))


def encode_report(node_id: int, echo_t0_us: int, report: Dict) -> bytes:
    """Child's reply: echoes the pull's ``t0_us``; ``report`` must carry
    ``ts_us`` (the child's clock when it built the report)."""
    return encode(TEL_REPORT, node_id, echo_t0_us, _json_body(report))


def encode_announce(node_id: int, bindings) -> bytes:
    """Trace-binding push: ``bindings`` is ``[(client_id, req_no,
    trace_id_hex), ...]``."""
    body = _json_body(
        {"bindings": [[c, r, t] for c, r, t in bindings]}
    )
    return encode(TEL_ANNOUNCE, node_id, 0, body)


def decode_body(body: bytes) -> Dict:
    """Parse a subframe's JSON body; raises :class:`FrameError` on garbage
    so transport callers keep their drop-the-connection contract."""
    if not body:
        return {}
    try:
        doc = json.loads(body.decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise FrameError(f"bad telemetry body: {exc}") from None
    if not isinstance(doc, dict):
        raise FrameError("telemetry body is not a JSON object")
    return doc


def sample_payloads() -> Dict[int, bytes]:
    """One representative encoded subframe per subtype — the corpus for
    mirlint's decode -> re-encode byte-identity check."""
    return {
        TEL_PULL: encode_pull(0, 17_000_000, 128),
        TEL_REPORT: encode_report(
            2,
            17_000_000,
            {
                "ts_us": 23_500_000,
                "group": 1,
                "node": "g1n0",
                "metrics": {"group_commits_total": 5.0},
                "trace": {
                    "cursor": 130,
                    "dropped": 0,
                    "events": [],
                    "meta": [],
                },
            },
        ),
        TEL_ANNOUNCE: encode_announce(
            1, [(7, 3, "00deadbeef00beef")]
        ),
    }
