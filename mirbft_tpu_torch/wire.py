"""Canonical deterministic binary codec for the L0 schema.

Replaces the reference's protobuf serialization (``pkg/pb/*``).  Requirements
it must satisfy (same as the reference's use of proto marshaling):

* **Determinism across nodes** — epoch-change digests are computed over
  serialized message content on every node (reference
  ``pkg/statemachine/stateless.go:323-352``), so encoding must be canonical:
  no map ordering, no optional-field ambiguity.
* **Self-description for unions** — WAL entries (8 Persistent kinds), the
  15-variant Msg oneof, events and actions are all discriminated unions; every
  encoded dataclass is prefixed with a stable registry tag.
* **Streamability** — the event log (``mirbft_tpu_torch.eventlog``) is a stream of
  length-prefixed records read back incrementally.

Encoding rules, applied to dataclass fields in declaration order:
  int -> uvarint (LEB128);  bool -> single byte;  bytes -> uvarint length + raw;
  str -> utf-8, length-prefixed;  tuple[X, ...] -> uvarint count + elements;
  Optional[T] -> presence byte + value;  dataclass -> uvarint tag + fields.

Tags are assigned explicitly in ``_REGISTRY_ORDER`` below and are part of the
wire format: append only, never renumber.
"""

from __future__ import annotations

import io
import threading
import typing
from dataclasses import fields, is_dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import messages as m
from . import state as s

# ---------------------------------------------------------------------------
# Varint primitives.
# ---------------------------------------------------------------------------


def write_uvarint(buf: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError(f"uvarint cannot encode negative value {value}")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


_MAX_VARINT_SHIFT = 63  # bound accepted varints to 64 bits (untrusted input)


def read_uvarint(view: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    end = len(view)
    while True:
        if pos >= end:
            raise ValueError("truncated uvarint")
        if shift > _MAX_VARINT_SHIFT:
            raise ValueError("uvarint exceeds 64 bits")
        b = view[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


# ---------------------------------------------------------------------------
# Registry: stable tag <-> class.  APPEND ONLY.
# ---------------------------------------------------------------------------

_REGISTRY_ORDER: List[type] = [
    # messages (tags 0..)
    m.NetworkConfig,
    m.ClientState,
    m.ReconfigNewClient,
    m.ReconfigRemoveClient,
    m.ReconfigNewConfig,
    m.NetworkState,
    m.RequestAck,
    m.Request,
    m.EpochConfig,
    m.CheckpointMsg,
    m.EpochChangeSetEntry,
    m.EpochChange,
    m.EpochChangeAck,
    m.NewEpochConfig,
    m.RemoteEpochChange,
    m.NewEpoch,
    m.Preprepare,
    m.Prepare,
    m.Commit,
    m.Suspect,
    m.NewEpochEcho,
    m.NewEpochReady,
    m.FetchBatch,
    m.ForwardBatch,
    m.FetchRequest,
    m.ForwardRequest,
    m.AckMsg,
    m.QEntry,
    m.PEntry,
    m.CEntry,
    m.NEntry,
    m.FEntry,
    m.ECEntry,
    m.TEntry,
    # state events / actions / origins
    s.BatchOrigin,
    s.VerifyBatchOrigin,
    s.EpochChangeOrigin,
    s.EventInitialParameters,
    s.EventLoadPersistedEntry,
    s.EventLoadCompleted,
    s.EventHashResult,
    s.EventCheckpointResult,
    s.EventRequestPersisted,
    s.EventStateTransferComplete,
    s.EventStateTransferFailed,
    s.EventStep,
    s.EventTickElapsed,
    s.EventActionsReceived,
    s.ActionSend,
    s.ActionHashRequest,
    s.ActionPersist,
    s.ActionTruncate,
    s.ActionCommit,
    s.ActionCheckpoint,
    s.ActionAllocatedRequest,
    s.ActionCorrectRequest,
    s.ActionForwardRequest,
    s.ActionStateTransfer,
    s.ActionStateApplied,
    s.RecordedEvent,
    m.AckBatch,
    m.MsgBatch,
    m.ReconfigTransferClient,
]

_TAG_OF: Dict[type, int] = {cls: i for i, cls in enumerate(_REGISTRY_ORDER)}
_CLS_OF: Dict[int, type] = dict(enumerate(_REGISTRY_ORDER))


# ---------------------------------------------------------------------------
# Per-class codec compilation.  Each field gets an (encode, decode) pair
# resolved once from its type annotation.
# ---------------------------------------------------------------------------

_Encoder = Callable[[bytearray, Any], None]
_Decoder = Callable[[memoryview, int], Tuple[Any, int]]


def _enc_int(buf: bytearray, v: int) -> None:
    write_uvarint(buf, v)


def _dec_int(view: memoryview, pos: int) -> Tuple[int, int]:
    return read_uvarint(view, pos)


def _enc_bool(buf: bytearray, v: bool) -> None:
    buf.append(1 if v else 0)


def _dec_bool(view: memoryview, pos: int) -> Tuple[bool, int]:
    if pos >= len(view):
        raise ValueError("truncated bool")
    return view[pos] != 0, pos + 1


def _enc_bytes(buf: bytearray, v: bytes) -> None:
    write_uvarint(buf, len(v))
    buf.extend(v)


def _dec_bytes(view: memoryview, pos: int) -> Tuple[bytes, int]:
    n, pos = read_uvarint(view, pos)
    if pos + n > len(view):
        raise ValueError("truncated bytes field")
    return bytes(view[pos : pos + n]), pos + n


def _enc_str(buf: bytearray, v: str) -> None:
    _enc_bytes(buf, v.encode("utf-8"))


def _dec_str(view: memoryview, pos: int) -> Tuple[str, int]:
    b, pos = _dec_bytes(view, pos)
    return b.decode("utf-8"), pos


def _enc_obj(buf: bytearray, v: Any) -> None:
    codec = _CODECS.get(type(v))
    if codec is None:
        raise TypeError(f"unregistered wire type {type(v).__name__}")
    write_uvarint(buf, _TAG_OF[type(v)])
    codec.encode_fields(buf, v)


_MAX_DECODE_DEPTH = 32  # deepest legitimate schema nesting is far shallower
_decode_state = threading.local()  # per-thread: concurrent decodes must not interact


def _dec_obj(view: memoryview, pos: int) -> Tuple[Any, int]:
    # Depth guard: MsgBatch made the schema recursive (its element union
    # contains Msg, which contains MsgBatch), so crafted bytes could
    # otherwise nest thousands deep and surface as RecursionError instead of
    # the ValueError ingress boundaries are hardened against.
    tag, pos = read_uvarint(view, pos)
    cls = _CLS_OF.get(tag)
    if cls is None:
        raise ValueError(f"unknown wire tag {tag}")
    depth = getattr(_decode_state, "depth", 0)
    if depth >= _MAX_DECODE_DEPTH:
        raise ValueError("wire object nesting exceeds permitted depth")
    _decode_state.depth = depth + 1
    try:
        return _CODECS[cls].decode_fields(view, pos)
    finally:
        _decode_state.depth = depth


def _make_checked_obj_codec(allowed: frozenset) -> Tuple[_Encoder, _Decoder]:
    """Object codec that rejects wire tags outside the field's declared type.

    Without this, untrusted bytes could type-confuse any nested field (e.g. a
    Suspect where a RequestAck is declared), crashing the state machine later.
    """

    def dec(view: memoryview, pos: int) -> Tuple[Any, int]:
        obj, pos = _dec_obj(view, pos)
        if type(obj) not in allowed:
            raise ValueError(
                f"wire type {type(obj).__name__} not permitted in this field"
            )
        return obj, pos

    return _enc_obj, dec


def _make_tuple_codec(elem: Tuple[_Encoder, _Decoder]) -> Tuple[_Encoder, _Decoder]:
    e_enc, e_dec = elem

    def enc(buf: bytearray, v: tuple) -> None:
        write_uvarint(buf, len(v))
        for item in v:
            e_enc(buf, item)

    def dec(view: memoryview, pos: int) -> Tuple[tuple, int]:
        n, pos = read_uvarint(view, pos)
        out = []
        for _ in range(n):
            item, pos = e_dec(view, pos)
            out.append(item)
        return tuple(out), pos

    return enc, dec


def _make_optional_codec(elem: Tuple[_Encoder, _Decoder]) -> Tuple[_Encoder, _Decoder]:
    e_enc, e_dec = elem

    def enc(buf: bytearray, v: Any) -> None:
        if v is None:
            buf.append(0)
        else:
            buf.append(1)
            e_enc(buf, v)

    def dec(view: memoryview, pos: int) -> Tuple[Any, int]:
        present = view[pos]
        pos += 1
        if not present:
            return None, pos
        return e_dec(view, pos)

    return enc, dec


def _codec_for_annotation(ann: Any) -> Tuple[_Encoder, _Decoder]:
    origin = typing.get_origin(ann)
    if ann is int:
        return _enc_int, _dec_int
    if ann is bool:
        return _enc_bool, _dec_bool
    if ann is bytes:
        return _enc_bytes, _dec_bytes
    if ann is str:
        return _enc_str, _dec_str
    if origin is tuple:
        args = typing.get_args(ann)
        if len(args) == 2 and args[1] is Ellipsis:
            return _make_tuple_codec(_codec_for_annotation(args[0]))
        raise TypeError(f"only homogeneous tuple[X, ...] supported, got {ann}")
    if origin is typing.Union:
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if len(args) != len(typing.get_args(ann)):
            # Optional[T]
            if len(args) == 1:
                return _make_optional_codec(_codec_for_annotation(args[0]))
            return _make_optional_codec(_make_checked_obj_codec(frozenset(args)))
        # plain union of dataclasses: tag-dispatched, membership-checked
        return _make_checked_obj_codec(frozenset(args))
    if is_dataclass(ann):
        return _make_checked_obj_codec(frozenset((ann,)))
    raise TypeError(f"unsupported wire annotation {ann!r}")


class _ClassCodec:
    __slots__ = ("cls", "field_codecs")

    def __init__(self, cls: type, hints: Dict[str, Any]):
        self.cls = cls
        self.field_codecs = [
            (f.name, _codec_for_annotation(hints[f.name])) for f in fields(cls)
        ]

    def encode_fields(self, buf: bytearray, obj: Any) -> None:
        for name, (enc, _) in self.field_codecs:
            enc(buf, getattr(obj, name))

    def decode_fields(self, view: memoryview, pos: int) -> Tuple[Any, int]:
        values = []
        for _, (_, dec) in self.field_codecs:
            v, pos = dec(view, pos)
            values.append(v)
        return self.cls(*values), pos


_CODECS: Dict[type, _ClassCodec] = {}


def _build_registry() -> None:
    for cls in _REGISTRY_ORDER:
        module = m if cls.__module__ == m.__name__ else s
        hints = typing.get_type_hints(cls, vars(module) | vars(typing))
        _CODECS[cls] = _ClassCodec(cls, hints)


_build_registry()


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def encode(obj: Any) -> bytes:
    """Canonically encode a registered dataclass (tag-prefixed)."""
    buf = bytearray()
    _enc_obj(buf, obj)
    return bytes(buf)


def decode(data: bytes) -> Any:
    obj, pos = _dec_obj(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"trailing bytes after decode: {len(data) - pos}")
    return obj


def write_framed(stream: io.RawIOBase, obj: Any) -> None:
    """Write a uvarint-length-prefixed record (eventlog framing)."""
    payload = encode(obj)
    head = bytearray()
    write_uvarint(head, len(payload))
    stream.write(bytes(head))
    stream.write(payload)


def read_framed(stream: io.RawIOBase) -> Optional[Any]:
    """Read one length-prefixed record; returns None at clean EOF."""
    # read varint length byte-by-byte
    length = 0
    shift = 0
    first = True
    while True:
        b = stream.read(1)
        if b is None:
            continue  # non-blocking raw stream; wait for data
        if not b:
            if first:
                return None
            raise EOFError("truncated record length")
        first = False
        if shift > _MAX_VARINT_SHIFT:
            raise ValueError("record length varint exceeds 64 bits")
        length |= (b[0] & 0x7F) << shift
        if not (b[0] & 0x80):
            break
        shift += 7
    # RawIOBase.read may return fewer than `length` bytes before EOF
    # (pipes, sockets, unbuffered files) — accumulate until complete.
    chunks = []
    remaining = length
    while remaining:
        chunk = stream.read(remaining)
        if chunk is None:
            continue
        if not chunk:
            raise EOFError("truncated record payload")
        chunks.append(chunk)
        remaining -= len(chunk)
    return decode(b"".join(chunks))
