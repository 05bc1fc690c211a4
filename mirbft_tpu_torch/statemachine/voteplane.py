"""Glue for the native sequence-vote plane (see _native/ackplane.cpp).

The three-phase commit's Prepare/Commit traffic is O(N²) per sequence
cluster-wide (reference ``pkg/statemachine/sequence.go:257-355``) and
dominates wall-clock at 64+ replicas.  The native ``SeqPlane`` owns vote
accumulation (replica bitmasks + per-digest counts) while the sequence
lifecycle stays in Python; transport envelopes pack their votes ONCE
(cached on the shared ``MsgBatch`` object) and every receiver applies the
whole envelope with a single native call.

Pure-Python mode (no toolchain, or ``MIRBFT_TPU_NATIVE=0``) keeps the dict
path in ``sequence.py``; differential tests assert both modes converge to
identical state.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

from .. import _native
from ..messages import Commit, MsgBatch, Prepare

if _native.available:
    _native.core.register_vote_types(Prepare, Commit)


def make_seq_plane(n_nodes: int, my_id: int, iq: int):
    """A fresh native vote plane, or None when running pure-Python."""
    if not _native.available or n_nodes > 4096:
        return None
    return _native.core.SeqPlane(n_nodes, my_id, iq)


# One packed-vote split per envelope object: the in-process transports hand
# every receiver the same MsgBatch, so N replicas share one packing pass.
# Keyed by id() — a WeakKeyDictionary would re-hash the whole envelope (the
# frozen dataclass __hash__ walks every contained message) on each lookup,
# costing what the shared pack saves.  The weakref guards id reuse and its
# callback evicts the entry when the envelope is collected.
_split_cache: dict = {}  # id(envelope) -> (weakref, (packed, votes, rest))


def split_votes(envelope: MsgBatch) -> Tuple[bytes, list, list]:
    """(packed_votes, vote_msgs, rest) for an envelope, cached per object."""
    # mirlint: allow(id-ordering) — identity memo key; the cache entry
    # pins the object and is is-checked before use, never ordered.
    key = id(envelope)
    entry = _split_cache.get(key)
    if entry is not None and entry[0]() is envelope:
        return entry[1]
    result = _native.core.pack_votes(envelope.msgs)

    def _evict(ref, key=key):
        live = _split_cache.get(key)
        if live is not None and live[0] is ref:
            del _split_cache[key]

    _split_cache[key] = (weakref.ref(envelope, _evict), result)
    return result
