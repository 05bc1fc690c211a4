"""Deterministic consensus state machine (L1).

Pure, single-threaded, non-blocking: consumes ``state.Event``s, emits
``state.Action``s.  No I/O, clocks, or threads — everything blocking or
compute-heavy (hashing on TPU, disk, network, app commit) is delegated to the
processor layer (L2).  Mirrors the capability surface of the reference's
``pkg/statemachine`` while being written Python/TPU-first.
"""
