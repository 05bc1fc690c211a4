"""Deterministic discrete-event simulation harness (L6).

N in-process nodes (full state machine + processor stacks) share one
time-ordered event queue with a per-category latency model and seeded
randomness — multi-node consensus without a cluster, bit-for-bit
reproducible.  With ``CryptoConfig(device=True)`` the cluster's hash and
signature-verification waves run on the port's CUDA kernels.
"""

from .crypto import DeviceAuthPlane, DeviceHashPlane
from .queue import EventQueue, SimEvent
from .recorder import (
    ClientConfig,
    CryptoConfig,
    NodeConfig,
    Recorder,
    Recording,
    RuntimeParameters,
    Spec,
)

__all__ = [
    "ClientConfig",
    "CryptoConfig",
    "DeviceAuthPlane",
    "DeviceHashPlane",
    "EventQueue",
    "NodeConfig",
    "Recorder",
    "Recording",
    "RuntimeParameters",
    "SimEvent",
    "Spec",
]
