"""Pluggable interfaces of the processor layer.

Rebuild of reference ``pkg/processor/serial.go:21-60`` — network transport,
storage, and crypto remain caller-pluggable, exactly as in the reference.
The ``Hasher`` is the TPU seam: its batch method receives every digest
request of a processing iteration at once.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Protocol, Sequence, Tuple

from ..messages import (
    ClientState,
    Msg,
    NetworkConfig,
    NetworkState,
    Persistent,
    QEntry,
    Reconfiguration,
    RequestAck,
)
from ..state import Event


class Hasher(Protocol):
    """Batch digest computation.  ``hash_batches`` receives a list of
    multi-part messages (each a list of byte slices to be concatenated) and
    returns one digest per message, in order.  The TPU implementation pads
    each concatenation into fixed-shape blocks and runs one vmapped SHA-256
    dispatch per length bucket; the CPU implementation folds via hashlib."""

    def hash_batches(self, batches: Sequence[Sequence[bytes]]) -> List[bytes]:
        ...


class Link(Protocol):
    """Network egress (reference serial.go:25-27).  Implementations must not
    block; drop-on-backpressure is acceptable (consensus tolerates loss)."""

    def send(self, dest: int, msg: Msg) -> None:
        ...


class App(Protocol):
    """The replicated application (reference serial.go:29-33)."""

    def apply(self, entry: QEntry) -> None:
        ...

    def snap(
        self,
        network_config: NetworkConfig,
        client_states: Tuple[ClientState, ...],
    ) -> Tuple[bytes, Tuple[Reconfiguration, ...]]:
        """Returns (checkpoint value, pending reconfigurations).  The value
        must encode the NetworkState (it is compared across nodes)."""
        ...

    def transfer_to(self, seq_no: int, snap: bytes) -> NetworkState:
        """Fetch and apply app state for the given checkpoint; returns the
        network state encoded in it.  Raising signals transfer failure."""
        ...


class RequestStore(Protocol):
    """Durable store of request payloads and allocations
    (reference serial.go:35-41)."""

    def get_allocation(self, client_id: int, req_no: int) -> Optional[bytes]:
        ...

    def put_allocation(self, client_id: int, req_no: int, digest: bytes) -> None:
        ...

    def get_request(self, ack: RequestAck) -> Optional[bytes]:
        ...

    def put_request(self, ack: RequestAck, data: bytes) -> None:
        ...

    def sync(self) -> None:
        ...


class WAL(Protocol):
    """Durable write-ahead log (reference serial.go:43-48)."""

    def write(self, index: int, entry: Persistent) -> None:
        ...

    def truncate(self, index: int) -> None:
        ...

    def sync(self) -> None:
        ...

    def load_all(self, for_each: Callable[[int, Persistent], None]) -> None:
        ...


class EventInterceptor(Protocol):
    """Tracing tap applied to every event entering the state machine
    (reference serial.go:50-60)."""

    def intercept(self, event: Event) -> None:
        ...
