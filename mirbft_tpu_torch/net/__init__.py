"""Socket transport plane (L3.5): the layer between the node runtime and
the world.

The reference library is transport-agnostic and never ships a real
``Link``; every transport in this tree was in-process (the testengine's
``SimLink``, the test-local ``FakeTransport``).  This package adds the
deployment story:

* :mod:`mirbft_tpu_torch.net.framing` — the length-prefixed frame codec over the
  canonical ``wire`` serialization (magic + version + kind + length +
  CRC32), with an incremental decoder that survives partial reads and
  rejects torn/oversized/garbage frames by reporting a :class:`FrameError`
  (the connection dies, the process never does).
* :mod:`mirbft_tpu_torch.net.tcp` — :class:`TcpTransport`, a real-socket ``Link``
  with one outbound sender thread + byte-budgeted drop-on-overflow queue
  per peer, a handshake carrying (node id, network-config fingerprint),
  and a per-peer CONNECTING → UP → BACKOFF state machine with capped
  jittered exponential backoff.

Deployment harness: ``python -m mirbft_tpu_torch.tools.mirnet`` runs an N-node
cluster as separate OS processes over localhost TCP (docs/TRANSPORT.md).
"""

from .framing import (
    FRAME_HEADER_LEN,
    FrameDecoder,
    FrameError,
    KIND_CLIENT,
    KIND_HANDSHAKE,
    KIND_MSG,
    encode_frame,
)
from .tcp import TcpTransport, config_fingerprint

__all__ = [
    "FRAME_HEADER_LEN",
    "FrameDecoder",
    "FrameError",
    "KIND_CLIENT",
    "KIND_HANDSHAKE",
    "KIND_MSG",
    "TcpTransport",
    "config_fingerprint",
    "encode_frame",
]
