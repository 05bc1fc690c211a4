"""Processor layer (L2): executes the actions the state machine emits.

Pure functions over (interface, action-batch) pairs, mirroring the
reference's ``pkg/processor`` — with one deliberate TPU-first change: the
``Hasher`` boundary is *batched*.  The reference hashes one action at a time
through a streaming ``hash.Hash`` (``serial.go:180-198``); here
``process_hash_actions`` hands every outstanding digest request of the
iteration to the hasher in one call, which the TPU backend
(``mirbft_tpu_torch.ops``) pads into fixed shapes and executes as a single vmapped
SHA-256 dispatch.  Results re-enter the event stream in action order, so
determinism is independent of device timing.
"""

from .interfaces import App, EventInterceptor, Hasher, Link, RequestStore, WAL
from .pipeline import AdmissionWindow, PipelineConfig, PipelineScheduler
from .serial import (
    apply_wal_actions,
    initialize_wal_for_new_node,
    process_app_actions,
    process_hash_actions,
    process_net_actions,
    process_reqstore_events,
    process_state_machine_events,
    process_wal_actions,
    recover_wal_for_existing_node,
)
from .work import WorkItems
from .clients import Client, Clients
from .replicas import Replicas, split_forward_requests

__all__ = [
    "AdmissionWindow",
    "App",
    "Client",
    "Clients",
    "EventInterceptor",
    "Hasher",
    "Link",
    "PipelineConfig",
    "PipelineScheduler",
    "RequestStore",
    "Replicas",
    "WAL",
    "WorkItems",
    "apply_wal_actions",
    "initialize_wal_for_new_node",
    "process_app_actions",
    "process_hash_actions",
    "process_net_actions",
    "process_reqstore_events",
    "process_state_machine_events",
    "process_wal_actions",
    "recover_wal_for_existing_node",
    "split_forward_requests",
]
