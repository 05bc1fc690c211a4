"""Length-prefixed frame codec for the socket transport.

A frame is::

    magic   2 bytes  b"MB"
    version 1 byte   FRAME_VERSION
    kind    1 byte   KIND_HANDSHAKE / KIND_MSG / KIND_CLIENT / KIND_SNAPSHOT
                     / KIND_GROUP
    length  4 bytes  big-endian payload length
    crc32   4 bytes  big-endian CRC32 of the payload
    payload ``length`` bytes (``wire.encode`` output for KIND_MSG)

The payload codec stays ``mirbft_tpu_torch.wire`` — this layer only delimits and
integrity-checks byte streams.  :class:`FrameDecoder` is incremental: feed
it whatever ``recv`` returned (a torn header, half a payload, three frames
at once) and it yields every complete frame.  Any malformed input — wrong
magic, unknown version/kind, oversized length, CRC mismatch — raises
:class:`FrameError`; the caller's contract is to drop the *connection* (the
peer re-syncs by reconnecting; there is no in-stream resynchronization),
never the process.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

FRAME_MAGIC = b"MB"
FRAME_VERSION = 1
FRAME_HEADER_LEN = 12

# Frame kinds.  KIND_HANDSHAKE must be the first frame on every connection
# (tcp.py); KIND_MSG carries one wire-encoded protocol message; KIND_CLIENT
# carries a client-submission envelope (tools/mirnet.py); KIND_SNAPSHOT
# carries one snapshot state-transfer subframe — request, chunk, or
# missing (storage/snapshot.py); KIND_GROUP carries one sharding-plane
# subframe — group-map discovery or committed-batch log shipping
# (groups/ship.py, docs/SHARDING.md); KIND_TELEMETRY carries one fleet
# observability subframe — metrics/trace pull, report, or trace-binding
# announce (net/telemetry.py, docs/OBSERVABILITY.md "Fleet plane").
KIND_HANDSHAKE = 0
KIND_MSG = 1
KIND_CLIENT = 2
KIND_SNAPSHOT = 3
KIND_GROUP = 4
KIND_TELEMETRY = 5

# Upper bound on a single payload.  Generous against the largest legitimate
# protocol message (a MsgBatch of a full iteration's sends), tight against
# a garbage length field committing us to buffer gigabytes.
MAX_FRAME_PAYLOAD = 32 * 1024 * 1024

_HEADER = struct.Struct(">2sBBII")


class FrameError(ValueError):
    """The byte stream is not a valid frame sequence; drop the connection."""


def encode_frame(kind: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME_PAYLOAD:
        raise FrameError(
            f"payload of {len(payload)} bytes exceeds frame cap "
            f"{MAX_FRAME_PAYLOAD}"
        )
    return (
        _HEADER.pack(
            FRAME_MAGIC,
            FRAME_VERSION,
            kind,
            len(payload),
            zlib.crc32(payload) & 0xFFFFFFFF,
        )
        + payload
    )


class FrameDecoder:
    """Incremental decoder over a byte stream of frames.

    ``feed(data)`` returns every frame completed by ``data`` as a list of
    ``(kind, payload)`` tuples and buffers any tail for the next call.
    Raises :class:`FrameError` on malformed input; after an error the
    decoder is poisoned (the stream has no resync point) and every further
    ``feed`` re-raises.
    """

    __slots__ = ("_buf", "_max_payload", "_error")

    def __init__(self, max_payload: int = MAX_FRAME_PAYLOAD):
        self._buf = bytearray()
        self._max_payload = max_payload
        self._error: FrameError = None

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        if self._error is not None:
            raise self._error
        self._buf.extend(data)
        frames: List[Tuple[int, bytes]] = []
        try:
            pos = 0
            buf = self._buf
            while len(buf) - pos >= FRAME_HEADER_LEN:
                magic, version, kind, length, crc = _HEADER.unpack_from(
                    buf, pos
                )
                if magic != FRAME_MAGIC:
                    raise FrameError(f"bad frame magic {bytes(magic)!r}")
                if version != FRAME_VERSION:
                    raise FrameError(f"unsupported frame version {version}")
                if kind not in (
                    KIND_HANDSHAKE,
                    KIND_MSG,
                    KIND_CLIENT,
                    KIND_SNAPSHOT,
                    KIND_GROUP,
                    KIND_TELEMETRY,
                ):
                    raise FrameError(f"unknown frame kind {kind}")
                if length > self._max_payload:
                    raise FrameError(
                        f"frame length {length} exceeds cap {self._max_payload}"
                    )
                if len(buf) - pos - FRAME_HEADER_LEN < length:
                    break  # torn tail: wait for more bytes
                start = pos + FRAME_HEADER_LEN
                payload = bytes(buf[start : start + length])
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    raise FrameError("frame CRC mismatch")
                frames.append((kind, payload))
                pos = start + length
            if pos:
                del buf[:pos]
        except FrameError as exc:
            self._error = exc
            raise
        return frames

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered awaiting a complete frame (diagnostics only)."""
        return len(self._buf)


# --------------------------------------------------------------------------
# KIND_CLIENT group envelope (docs/SHARDING.md)
#
# Sharded deployments prefix the client submission body with a 6-byte
# envelope header so one connection can multiplex submissions to a node's
# co-hosted groups.  The decode path is versioned-compat: a payload without
# the envelope magic is a legacy single-group submission and decodes as
# group 0 with the whole payload as body, so old clients and recorded
# streams keep working unchanged.  The magic byte cannot collide with a
# legacy payload in practice: legacy bodies start with an 8-byte big-endian
# req_no, whose first byte only reaches 0xC1 for req_no >= 0xC1 << 56.

CLIENT_ENV_MAGIC = 0xC1
CLIENT_ENV_VERSION = 1
CLIENT_ENV_VERSION_TRACED = 2
CLIENT_ENV_VERSION_ROUTED = 3
_CLIENT_ENV = struct.Struct(">BBI")  # magic, version, group id
_CLIENT_ENV_TRACE = struct.Struct(">BBIQ")  # + u64 trace id (version 2)
# Version 3 ("routed", docs/SHARDING.md "Elastic resharding") appends the
# u64 client id and the u32 map version the sender routed under, so a
# node can re-route the *client* under its own (possibly newer) map
# instead of trusting the sender's group pick, and redirect stale epochs.
_CLIENT_ENV_ROUTED = struct.Struct(">BBIQQI")


def encode_client_envelope(
    group_id: int,
    body: bytes,
    trace_id: int = 0,
    client_id: int = None,
    map_version: int = None,
) -> bytes:
    """Wrap a client submission body with its destination group id.

    A nonzero ``trace_id`` upgrades the envelope to version 2, which
    appends the 8-byte id after the group id (docs/OBSERVABILITY.md
    "Fleet plane"); ``trace_id == 0`` emits the byte-identical version-1
    envelope, so untraced submissions stay compatible with old decoders.
    Passing ``client_id`` (with the sender's ``map_version``, default 0)
    emits the version-3 routed envelope.
    """
    if client_id is not None:
        return _CLIENT_ENV_ROUTED.pack(
            CLIENT_ENV_MAGIC,
            CLIENT_ENV_VERSION_ROUTED,
            group_id,
            trace_id,
            client_id,
            map_version or 0,
        ) + body
    if trace_id:
        return _CLIENT_ENV_TRACE.pack(
            CLIENT_ENV_MAGIC, CLIENT_ENV_VERSION_TRACED, group_id, trace_id
        ) + body
    return _CLIENT_ENV.pack(CLIENT_ENV_MAGIC, CLIENT_ENV_VERSION, group_id) + body


def decode_client_envelope(payload: bytes) -> Tuple[int, int, bytes]:
    """``(group_id, trace_id, body)`` from a KIND_CLIENT payload; legacy
    payloads (no envelope magic) imply group 0, and version-1 envelopes
    imply trace id 0 (untraced).  Raises :class:`FrameError` on an
    envelope from a future version."""
    group_id, trace_id, _cid, _mv, body = decode_client_envelope_routed(
        payload
    )
    return group_id, trace_id, body


def decode_client_envelope_routed(
    payload: bytes,
) -> Tuple[int, int, Optional[int], Optional[int], bytes]:
    """``(group_id, trace_id, client_id, map_version, body)``; the last
    two are ``None`` below envelope version 3 (the sender predates the
    routed form — route by its group pick, as before)."""
    if len(payload) >= _CLIENT_ENV.size and payload[0] == CLIENT_ENV_MAGIC:
        _magic, version, group_id = _CLIENT_ENV.unpack_from(payload)
        if version == CLIENT_ENV_VERSION:
            return group_id, 0, None, None, payload[_CLIENT_ENV.size:]
        if version == CLIENT_ENV_VERSION_TRACED:
            if len(payload) < _CLIENT_ENV_TRACE.size:
                raise FrameError("truncated traced client envelope")
            _m, _v, group_id, trace_id = _CLIENT_ENV_TRACE.unpack_from(
                payload
            )
            return (
                group_id, trace_id, None, None,
                payload[_CLIENT_ENV_TRACE.size:],
            )
        if version == CLIENT_ENV_VERSION_ROUTED:
            if len(payload) < _CLIENT_ENV_ROUTED.size:
                raise FrameError("truncated routed client envelope")
            (
                _m, _v, group_id, trace_id, client_id, map_version,
            ) = _CLIENT_ENV_ROUTED.unpack_from(payload)
            return (
                group_id, trace_id, client_id, map_version,
                payload[_CLIENT_ENV_ROUTED.size:],
            )
        raise FrameError(
            f"unsupported client envelope version {version}"
        )
    return 0, 0, None, None, payload
