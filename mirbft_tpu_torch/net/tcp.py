"""Real-socket ``Link``: framed TCP with reconnect/backoff per peer.

:class:`TcpTransport` implements the same ``Link`` protocol the node
runtime consumes (``processor/interfaces.py``): ``send(dest, msg)`` must
not block, and drop-on-backpressure is acceptable.  Design:

* **One outbound connection + sender thread per peer.**  ``send`` encodes
  the message once (``wire.encode`` + frame) and enqueues it on the peer's
  byte-budgeted queue; overflow drops the *newest* frame (the counterpart
  of ``msgbuffers.py``'s drop-on-overflow — consensus tolerates loss, and
  every protocol message is re-derivable by retry/fetch).
* **Per-peer connection state machine** CONNECTING → UP → BACKOFF.  A dial
  failure or mid-stream send error moves the peer to BACKOFF with capped
  exponential backoff plus jitter, then back to CONNECTING.  A peer stuck
  in BACKOFF past ``unreachable_after_s`` is attributed to the health
  plane as a ``peer_unreachable`` fault, once per outage.
* **Handshake.**  The first frame on every connection (both directions) is
  KIND_HANDSHAKE carrying the sender's node id and the network-config
  fingerprint; a fingerprint mismatch (peer from a different network or
  config revision) drops the connection before any protocol traffic.
* **Inbound.**  An accept loop spawns one reader thread per connection;
  frames are decoded incrementally (partial reads, coalesced frames) and
  malformed input — bad magic, CRC mismatch, oversized length, garbage
  payload — drops that connection only, never the process.

Observability (docs/OBSERVABILITY.md "Socket transport"): counters
``net_tx_bytes_total`` / ``net_rx_bytes_total`` / ``net_tx_dropped_total``
/ ``net_reconnects_total``, per-peer gauges ``net_peer_queue_depth`` and
``net_peer_up``, tracer instant events ``net_peer_connect`` /
``net_peer_drop``.
"""

from __future__ import annotations

import hashlib
import random
import select
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics as metrics_mod
from .. import tracing, wire
from .framing import (
    FrameDecoder,
    FrameError,
    KIND_CLIENT,
    KIND_GROUP,
    KIND_HANDSHAKE,
    KIND_MSG,
    KIND_SNAPSHOT,
    KIND_TELEMETRY,
    encode_frame,
)

# Per-peer connection states (exported for tests/status).
CONNECTING = "connecting"
UP = "up"
BACKOFF = "backoff"

# Shared-state declaration for mirlint's lock-discipline pass: the send
# queue is filled by node worker threads and drained by the per-peer
# sender thread, so queue state may only be touched under the peer's
# condition; the accepted-connection list is shared between the acceptor
# and stop() (docs/STATIC_ANALYSIS.md).  The remaining _Peer fields
# (state/backoff_s/down_since/fault_recorded) are single-writer sender-
# thread state and stay out of the map.
MIRLINT_SHARED_STATE = {
    "_Peer.frames": "cond",
    "_Peer.queued_bytes": "cond",
    "_ConnSender.pending": "cond",
    "_ConnSender.pending_bytes": "cond",
    "_ConnSender.writing": "cond",
    "_ConnSender.error": "cond",
    "TcpTransport._conns": "_conns_lock",
}

_HANDSHAKE = struct.Struct(">I")


def config_fingerprint(network_config) -> bytes:
    """Canonical fingerprint of a NetworkConfig (or any wire-encodable
    object): nodes speaking for different networks/config revisions fail
    the handshake instead of exchanging undeliverable protocol traffic."""
    return hashlib.sha256(wire.encode(network_config)).digest()[:16]


class _Peer:
    """Outbound half of one peer link: queue + sender thread state."""

    __slots__ = (
        "peer_id",
        "addr",
        "frames",
        "queued_bytes",
        "cond",
        "state",
        "backoff_s",
        "down_since",
        "fault_recorded",
        "thread",
    )

    def __init__(self, peer_id: int, addr: Tuple[str, int]):
        self.peer_id = peer_id
        self.addr = addr
        self.frames: deque = deque()
        self.queued_bytes = 0
        self.cond = threading.Condition()
        self.state = CONNECTING
        self.backoff_s = 0.0
        self.down_since: Optional[float] = None
        self.fault_recorded = False
        self.thread: Optional[threading.Thread] = None


class _ConnSender:
    """Writer-combining batched sender for one accepted connection.

    Group-plane pushes (ShipFeed), client replies, and telemetry answers
    can all race on the same inbound socket, and ``sendall`` under a
    plain lock serializes every producer behind the slowest subscriber
    (docs/PERFORMANCE.md §16).  Producers instead append the encoded
    frame under the condition and the first appender becomes the
    *writer*: it swaps the whole pending batch out, drops the lock, and
    pushes the batch with one ``sendall`` — a burst of N frames costs
    one syscall, and every non-writer producer returns after a list
    append instead of queueing behind the socket.  Pending bytes are
    bounded: a producer over the budget blocks until the writer drains
    (the pre-batching behaviour — blocking in ``sendall`` under the
    lock — with the socket timeout surfacing as a latched connection
    error that every later sender re-raises)."""

    MAX_PENDING_BYTES = 4 << 20

    __slots__ = ("conn", "cond", "pending", "pending_bytes", "writing", "error")

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.cond = threading.Condition()
        self.pending: List[bytes] = []
        self.pending_bytes = 0
        self.writing = False
        self.error: Optional[BaseException] = None

    def send(self, frame: bytes, wait_hist, tx_bytes) -> None:
        t0 = time.perf_counter()
        with self.cond:
            wait_hist.observe(time.perf_counter() - t0)
            while (
                self.error is None
                and self.writing
                and self.pending_bytes >= self.MAX_PENDING_BYTES
            ):
                self.cond.wait()
            if self.error is not None:
                raise self.error
            self.pending.append(frame)
            self.pending_bytes += len(frame)
            if self.writing:
                return  # the active writer flushes this frame
            self.writing = True
        while True:
            with self.cond:
                if not self.pending:
                    self.writing = False
                    self.cond.notify_all()
                    return
                batch = b"".join(self.pending)
                self.pending.clear()
                self.pending_bytes = 0
                self.cond.notify_all()
            try:
                self.conn.sendall(batch)
            except BaseException as exc:
                with self.cond:
                    self.error = exc
                    self.writing = False
                    self.cond.notify_all()
                raise
            tx_bytes.inc(len(batch))


class TcpTransport:
    """A ``Link`` over localhost/LAN TCP (see module docstring)."""

    def __init__(
        self,
        node_id: int,
        peers: Dict[int, Tuple[str, int]],
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
        fingerprint: bytes = b"",
        queue_budget_bytes: int = 8 * 1024 * 1024,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        backoff_jitter: float = 0.3,
        unreachable_after_s: float = 5.0,
        dial_timeout_s: float = 1.0,
        tracer: Optional[tracing.Tracer] = None,
        health_monitor=None,
        logger=None,
        fault_injector=None,
    ):
        self.node_id = node_id
        self.fingerprint = fingerprint
        self.queue_budget_bytes = queue_budget_bytes
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.unreachable_after_s = unreachable_after_s
        self.dial_timeout_s = dial_timeout_s
        self.tracer = tracer if tracer is not None else tracing.default_tracer
        self.health_monitor = health_monitor
        self.logger = logger
        # Optional wire-fault injector (net/faults.py): when set, every
        # outbound frame routes through its per-link schedule before the
        # peer queue, and partitioned links refuse to dial/drain so the
        # outage is a real TCP outage (docs/FAULTS.md).
        self.fault_injector = fault_injector
        if fault_injector is not None:
            fault_injector.bind(self._enqueue_frame)
        self._rng = random.Random(node_id)  # jitter only; never protocol-visible

        self._peers: Dict[int, _Peer] = {
            pid: _Peer(pid, addr)
            for pid, addr in peers.items()
            if pid != node_id
        }
        self._on_message: Optional[Callable[[int, object], None]] = None
        self._on_client: Optional[Callable[[bytes, Callable], None]] = None
        self._on_snapshot: Optional[Callable[[bytes], Optional[bytes]]] = None
        self._on_group: Optional[Callable[[bytes, Callable], None]] = None
        self._on_telemetry: Optional[Callable[[bytes, Callable], None]] = None
        self._stop = threading.Event()
        self._threads: list = []
        self._conns: list = []
        self._conns_lock = threading.Lock()

        self._tx_bytes = metrics_mod.counter("net_tx_bytes_total")
        self._rx_bytes = metrics_mod.counter("net_rx_bytes_total")
        self._tx_dropped = metrics_mod.counter("net_tx_dropped_total")
        self._reconnects = metrics_mod.counter("net_reconnects_total")
        # Wait to acquire a reader connection's send lock: reply traffic
        # and ship-feed pushes contend on it, and this histogram is the
        # measured answer to whether that contention matters
        # (docs/OBSERVABILITY.md, ROADMAP item 3).
        self._send_lock_wait = metrics_mod.histogram(
            "net_send_lock_wait_seconds"
        )

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, listen_port))
        self._listener.listen(64)
        self._listener.settimeout(0.2)

    # --- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()

    def start(
        self,
        on_message: Callable[[int, object], None],
        on_client: Optional[Callable[[bytes, Callable], None]] = None,
        on_snapshot: Optional[Callable[[bytes], Optional[bytes]]] = None,
        on_group: Optional[Callable[[bytes, Callable], None]] = None,
        on_telemetry: Optional[Callable[[bytes, Callable], None]] = None,
    ) -> None:
        """Begin accepting and dialing.  ``on_message(source, msg)`` is
        invoked on reader threads for every inbound protocol message (the
        node's thread-safe ``step``); ``on_client(payload, reply)`` for
        KIND_CLIENT frames (``reply(payload)`` answers on the same
        connection — the mirnet submission path); ``on_snapshot(digest)``
        returns the local snapshot body (or None) for KIND_SNAPSHOT
        state-transfer requests (storage/snapshot.py); ``on_group(payload,
        send)`` handles KIND_GROUP sharding-plane frames — ``send(payload)``
        answers (and may keep answering: log-ship subscriptions hold the
        connection open) on the same connection (groups/ship.py);
        ``on_telemetry(payload, send)`` handles KIND_TELEMETRY fleet
        observability frames the same way (net/telemetry.py)."""
        self._on_message = on_message
        self._on_client = on_client
        self._on_snapshot = on_snapshot
        self._on_group = on_group
        self._on_telemetry = on_telemetry
        accept = threading.Thread(
            target=self._accept_loop,
            name=f"net{self.node_id}-accept",
            daemon=True,
        )
        accept.start()
        self._threads.append(accept)
        for peer in self._peers.values():
            peer.thread = threading.Thread(
                target=self._sender_loop,
                args=(peer,),
                name=f"net{self.node_id}-tx{peer.peer_id}",
                daemon=True,
            )
            peer.thread.start()
            self._threads.append(peer.thread)

    def stop(self) -> None:
        self._stop.set()
        if self.fault_injector is not None:
            self.fault_injector.stop()
        for peer in self._peers.values():
            with peer.cond:
                peer.cond.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        for thread in list(self._threads):
            thread.join(timeout=2)

    def peer_state(self, peer_id: int) -> str:
        return self._peers[peer_id].state

    # --- Link --------------------------------------------------------------

    def send(self, dest: int, msg) -> None:
        """Non-blocking enqueue; drops on overflow (Link contract)."""
        if dest not in self._peers:
            return  # self or unknown peer: nothing to do
        frame = encode_frame(KIND_MSG, wire.encode(msg))
        if self.fault_injector is not None:
            self.fault_injector.submit(dest, frame)
        else:
            self._enqueue_frame(dest, frame)

    def _enqueue_frame(self, dest: int, frame: bytes) -> None:
        peer = self._peers.get(dest)
        if peer is None:
            return
        with peer.cond:
            if peer.queued_bytes + len(frame) > self.queue_budget_bytes:
                self._tx_dropped.inc()
                return
            peer.frames.append(frame)
            peer.queued_bytes += len(frame)
            metrics_mod.gauge(
                "net_peer_queue_depth", labels={"peer": str(dest)}
            ).set(peer.queued_bytes)
            peer.cond.notify()

    # --- outbound ----------------------------------------------------------

    def _sender_loop(self, peer: _Peer) -> None:
        up_gauge = metrics_mod.gauge(
            "net_peer_up", labels={"peer": str(peer.peer_id)}
        )
        up_gauge.set(0)
        while not self._stop.is_set():
            sock = self._dial(peer)
            if sock is None:
                if self._stop.is_set():
                    return
                self._enter_backoff(peer, up_gauge, was_up=False)
                continue
            peer.state = UP
            peer.backoff_s = 0.0
            peer.down_since = None
            peer.fault_recorded = False
            up_gauge.set(1)
            self.tracer.instant(
                "net_peer_connect",
                pid=self.node_id,
                args={"peer": peer.peer_id},
            )
            try:
                self._drain(peer, sock)
            except OSError:
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            if self._stop.is_set():
                return
            self._enter_backoff(peer, up_gauge, was_up=True)

    def _dial(self, peer: _Peer) -> Optional[socket.socket]:
        if self.fault_injector is not None and self.fault_injector.link_blocked(
            peer.peer_id
        ):
            return None  # partitioned: behaves exactly like a dead network
        try:
            sock = socket.create_connection(
                peer.addr, timeout=self.dial_timeout_s
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            sock.sendall(
                encode_frame(
                    KIND_HANDSHAKE,
                    _HANDSHAKE.pack(self.node_id) + self.fingerprint,
                )
            )
            return sock
        except OSError:
            return None

    def _drain(self, peer: _Peer, sock: socket.socket) -> None:
        """Pump the peer queue into the socket until error or stop."""
        depth_gauge = metrics_mod.gauge(
            "net_peer_queue_depth", labels={"peer": str(peer.peer_id)}
        )
        while not self._stop.is_set():
            if (
                self.fault_injector is not None
                and self.fault_injector.link_blocked(peer.peer_id)
            ):
                # A partition starting mid-connection severs the link the
                # way a cable pull would: the sender reconnects into the
                # (refused) dial path and enters backoff.
                raise OSError("link partitioned (fault injection)")
            with peer.cond:
                if not peer.frames:
                    peer.cond.wait(timeout=0.2)
                if self._stop.is_set():
                    return
                frame = peer.frames.popleft() if peer.frames else None
                if frame is not None:
                    peer.queued_bytes -= len(frame)
                    depth_gauge.set(peer.queued_bytes)
            if frame is None:
                # Idle liveness probe: the outbound half of a link never
                # receives data (each direction has its own connection), so
                # readability means EOF/RST — without this, an idle link
                # only notices a dead peer on the next send and the
                # UP/BACKOFF state machine would lie to the health plane.
                readable, _, _ = select.select([sock], [], [], 0)
                if readable and not sock.recv(4096):
                    raise OSError("peer closed connection")
                continue
            sock.sendall(frame)  # OSError here → caller reconnects
            self._tx_bytes.inc(len(frame))

    def _enter_backoff(self, peer: _Peer, up_gauge, was_up: bool) -> None:
        peer.state = BACKOFF
        up_gauge.set(0)
        now = time.monotonic()
        if peer.down_since is None:
            peer.down_since = now
        self._reconnects.inc()
        if was_up:
            self.tracer.instant(
                "net_peer_drop",
                pid=self.node_id,
                args={"peer": peer.peer_id},
            )
        if (
            self.health_monitor is not None
            and not peer.fault_recorded
            and now - peer.down_since >= self.unreachable_after_s
        ):
            peer.fault_recorded = True
            self.health_monitor.record_fault(
                peer.peer_id,
                "peer_unreachable",
                down_seconds=round(now - peer.down_since, 3),
            )
        peer.backoff_s = min(
            self.backoff_max_s,
            max(self.backoff_base_s, peer.backoff_s * 2),
        )
        delay = peer.backoff_s * (
            1 + self.backoff_jitter * self._rng.random()
        )
        self._stop.wait(timeout=delay)
        if not self._stop.is_set():
            peer.state = CONNECTING

    # --- inbound -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(0.2)
            with self._conns_lock:
                self._conns.append(conn)
            reader = threading.Thread(
                target=self._reader_loop,
                args=(conn,),
                name=f"net{self.node_id}-rx",
                daemon=True,
            )
            reader.start()
            self._threads.append(reader)

    def _reader_loop(self, conn: socket.socket) -> None:
        decoder = FrameDecoder()
        source: Optional[int] = None
        # Group-plane pushes (ShipFeed) come from the node's app thread
        # while this reader may be answering on the same socket, so every
        # send on this connection goes through one writer-combining
        # batcher: frames enqueue under the condition, one producer at a
        # time drains the batch with a single sendall outside it.
        sender = _ConnSender(conn)

        def locked_send(kind: int, payload: bytes) -> None:
            sender.send(
                encode_frame(kind, payload),
                self._send_lock_wait,
                self._tx_bytes,
            )

        def reply(payload: bytes) -> None:
            locked_send(KIND_CLIENT, payload)

        def group_send(payload: bytes) -> None:
            locked_send(KIND_GROUP, payload)

        def telemetry_send(payload: bytes) -> None:
            locked_send(KIND_TELEMETRY, payload)

        try:
            while not self._stop.is_set():
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return  # peer closed
                self._rx_bytes.inc(len(data))
                for kind, payload in decoder.feed(data):
                    if kind == KIND_HANDSHAKE:
                        peer_id = _HANDSHAKE.unpack_from(payload)[0]
                        if payload[_HANDSHAKE.size :] != self.fingerprint:
                            self._log_drop(
                                f"peer {peer_id}: config fingerprint mismatch"
                            )
                            return
                        source = peer_id
                    elif kind == KIND_MSG:
                        if source is None:
                            self._log_drop("protocol frame before handshake")
                            return
                        self._on_message(source, wire.decode(payload))
                    elif kind == KIND_CLIENT:
                        if self._on_client is None:
                            self._log_drop("unexpected client frame")
                            return
                        self._on_client(payload, reply)
                    elif kind == KIND_SNAPSHOT:
                        if self._on_snapshot is None:
                            self._log_drop("unexpected snapshot frame")
                            return
                        self._serve_snapshot(conn, payload)
                    elif kind == KIND_GROUP:
                        if self._on_group is None:
                            self._log_drop("unexpected group frame")
                            return
                        self._on_group(payload, group_send)
                    elif kind == KIND_TELEMETRY:
                        if self._on_telemetry is None:
                            self._log_drop("unexpected telemetry frame")
                            return
                        self._on_telemetry(payload, telemetry_send)
        except FrameError as exc:
            self._log_drop(f"frame error from peer {source}: {exc}")
        except Exception as exc:  # decode error, stopped node, ...
            self._log_drop(f"dropping connection from peer {source}: {exc!r}")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_snapshot(self, conn: socket.socket, payload: bytes) -> None:
        """Answer one snapshot state-transfer request on the requester's
        connection.  The chunk stream can be many MiB, so the 0.2 s reader
        timeout is lifted for the duration of the sendall burst."""
        # Local import: storage depends on net.framing, so importing at
        # module level would make the dependency circular.
        from ..storage import snapshot as snapmod

        replies = snapmod.serve_request(payload, self._on_snapshot)
        conn.settimeout(None)
        try:
            for reply_payload in replies:
                frame = encode_frame(KIND_SNAPSHOT, reply_payload)
                conn.sendall(frame)
                self._tx_bytes.inc(len(frame))
        finally:
            conn.settimeout(0.2)

    def _log_drop(self, why: str) -> None:
        self.tracer.instant(
            "net_conn_drop", pid=self.node_id, args={"why": why}
        )
        if self.logger is not None:
            self.logger.warn("net: " + why)
