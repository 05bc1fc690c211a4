"""Deterministic discrete-event simulation harness (L6).

N in-process nodes (full state machine + processor stacks) share one
time-ordered event queue with a per-category latency model and seeded
randomness — multi-node consensus without a cluster, bit-for-bit
reproducible.  The mangler DSL injects network faults (drop/delay/jitter/
duplicate/crash-restart) at the queue.  ``FastRecording`` runs the same
simulation in the native C++ engine.  With ``CryptoConfig(device=True)``
(``Recording``) or ``device=True`` (``FastRecording``) the cluster's hash
and signature-verification waves run on the port's CUDA kernels.
"""

from .crypto import DeviceAuthPlane, DeviceHashPlane
from .queue import EventQueue, SimEvent
from .recorder import (
    ClientConfig,
    CryptoConfig,
    NodeConfig,
    Recorder,
    Recording,
    ReconfigPoint,
    RuntimeParameters,
    Spec,
)
from .manglers import (
    After,
    Conditional,
    EventMangling,
    For,
    Until,
    matching,
)
from .fastengine import (
    FastEngineUnsupported,
    FastRecording,
    PdesEnvelopeUnsupported,
)

__all__ = [
    "After",
    "ClientConfig",
    "Conditional",
    "CryptoConfig",
    "DeviceAuthPlane",
    "DeviceHashPlane",
    "EventMangling",
    "EventQueue",
    "FastEngineUnsupported",
    "FastRecording",
    "For",
    "NodeConfig",
    "PdesEnvelopeUnsupported",
    "ReconfigPoint",
    "Recorder",
    "Recording",
    "RuntimeParameters",
    "SimEvent",
    "Spec",
    "Until",
    "matching",
]
