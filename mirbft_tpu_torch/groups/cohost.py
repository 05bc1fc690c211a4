"""Cohost crypto plane: one shared fused device wave for all co-hosted groups.

The cohost layout (tools/mirnet.py ``run_host``) boots one node of every
group inside a single OS process.  Before this plane each instance owned a
private hasher, so the host paid the fused pipeline's per-dispatch overhead
once per group — which is exactly backwards: dispatch overhead is the fixed
cost the wave exists to amortize (docs/PERFORMANCE.md §13), and co-hosted
groups are the extra rows that amortize it.  ``CohostCryptoPlane`` owns ONE
``FusedCryptoPipeline`` (multi-tenant: per-group quorum slabs, group-tagged
rows) and ONE ``SharedWaveMux``; each group gets a ``DeviceHashPlane``
attached to the mux as its tenant, wrapped in a ``_LockedHasher`` handle
that satisfies the processor ``Hasher`` protocol.

Threading: the simulated engine drives a mux from one event loop, but a
cohost process runs each group's node on its own worker threads, and a mux
launch mutates *other* tenants' plane state (their pending/in-flight
bookkeeping).  One host-wide re-entrant lock around every hasher entry
point serializes the crypto plane — the device is a single shared resource
anyway, so the lock adds no parallelism loss where it matters, and the
lock's scope is declared below for mirlint's shared-state pass.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

# One host-wide RLock serializes every tenant hasher call
# (hash/dispatch/collect/flush) — a mux launch mutates ALL tenants'
# plane bookkeeping, not just the caller's.
MIRLINT_SHARED_STATE = {
    "CohostCryptoPlane._planes": "_lock",
}


class _LockedHasher:
    """Per-group ``Hasher`` handle over the shared cohost plane.

    Exposes the full split-phase protocol surface
    (``processor/pipeline.py`` probes ``dispatch_batches`` /
    ``collect_batches`` with hasattr), each call serialized under the
    host-wide plane lock.  The lock is not held *between* a group's
    dispatch and its later collect, so dispatches interleave across
    groups and aggregate into shared waves; a blocking collect does hold
    the lock for its duration, but by then the wave is already executing
    on the device, so the waiters overlap device time, not add to it."""

    def __init__(self, plane, lock: threading.RLock):
        self._plane = plane
        self._lock = lock

    def hash_batches(self, batches: Sequence[Sequence[bytes]]) -> List[bytes]:
        with self._lock:
            return self._plane.hash_batches(batches)

    def dispatch_batches(self, batches: Sequence[Sequence[bytes]]):
        with self._lock:
            return self._plane.dispatch_batches(batches)

    def collect_batches(self, handle) -> List[bytes]:
        with self._lock:
            return self._plane.collect_batches(handle)

    def flush_inflight(self) -> None:
        """Shutdown barrier — see ``Node.stop``."""
        with self._lock:
            self._plane.flush_inflight()


class CohostCryptoPlane:
    """One fused crypto wave for a whole cohost process.

    Build one per host, then hand ``hasher_for(group)`` to each co-hosted
    instance's ``ProcessorConfig``.  All tenants' hash rows ride shared
    group-tagged fused waves; each tenant collects its own rows
    independently (``SharedWaveMux``).

    ``torch_device``: "cuda" (the default) launches the port's CUDA kernels,
    "cpu" runs their plain PyTorch twins (the CPU tests)."""

    def __init__(
        self,
        n_groups: int,
        kernel: str = "auto",
        wave_size: int = 192,
        adaptive: bool = True,
        torch_device: str = "cuda",
    ):
        from ..ops.fused import FusedCryptoPipeline
        from ..testengine.crypto import DeviceHashPlane, SharedWaveMux

        # mirlint: allow(lock-map) — single RLock; see MIRLINT_SHARED_STATE.
        self._lock = threading.RLock()
        self._plane_cls = DeviceHashPlane
        self.pipeline = FusedCryptoPipeline(
            kernel=kernel, n_groups=n_groups, device=torch_device
        )
        self.mux = SharedWaveMux(
            self.pipeline, wave_size=wave_size, adaptive=adaptive
        )
        self.n_groups = n_groups
        self.kernel = kernel
        self.wave_size = wave_size
        self.torch_device = torch_device
        self._planes: Dict[int, object] = {}

    def hasher_for(self, group: int) -> _LockedHasher:
        """The group's ``Hasher``: a mux-attached ``DeviceHashPlane``
        behind the host-wide lock."""
        with self._lock:
            plane = self._planes.get(group)
            if plane is None:
                plane = self._plane_cls(
                    device=True,
                    wave_size=self.wave_size,
                    kernel=self.kernel,
                    torch_device=self.torch_device,
                )
                plane.attach_mux(self.mux, group)
                self._planes[group] = plane
            return _LockedHasher(plane, self._lock)

    def flush(self) -> None:
        """Flush and materialize every tenant's in-flight work (process
        shutdown)."""
        with self._lock:
            for plane in self._planes.values():
                plane.flush_inflight()
