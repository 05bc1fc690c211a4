"""Byte-bounded per-node message buffering.

Rebuild of reference ``pkg/statemachine/msgbuffers.go``: each peer node gets a
byte-budgeted ``NodeBuffer`` (EventInitialParameters.buffer_size) shared by all
per-component ``MsgBuffer``s; when over capacity the storing buffer drops its
own oldest messages first (:145-164).  Classification of buffered messages is
4-way: PAST (drop), CURRENT (apply), FUTURE (keep), INVALID (drop).
"""

from __future__ import annotations

import enum
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .. import wire
from ..messages import Msg
from ..state import EventInitialParameters


class Applyable(enum.IntEnum):
    PAST = 0
    CURRENT = 1
    FUTURE = 2
    INVALID = 3


FilterFn = Callable[[int, Msg], Applyable]
ApplyFn = Callable[[int, Msg], None]


def msg_size(msg: Msg) -> int:
    """Wire size of a message; the unit of buffer accounting (the reference
    uses proto.Size)."""
    return len(wire.encode(msg))


class NodeBuffers:
    """Registry of per-peer buffers (reference msgbuffers.go:20-44)."""

    __slots__ = ("my_config", "logger", "node_map")

    def __init__(self, my_config: EventInitialParameters, logger=None):
        self.my_config = my_config
        self.logger = logger
        self.node_map: Dict[int, "NodeBuffer"] = {}

    def node_buffer(self, source: int) -> "NodeBuffer":
        nb = self.node_map.get(source)
        if nb is None:
            nb = NodeBuffer(source, self.my_config, self.logger)
            self.node_map[source] = nb
        return nb


class NodeBuffer:
    """Aggregate byte budget for one peer (reference msgbuffers.go:64-77)."""

    __slots__ = ("id", "my_config", "logger", "total_size", "msg_bufs")

    def __init__(self, node_id: int, my_config: EventInitialParameters, logger=None):
        self.id = node_id
        self.my_config = my_config
        self.logger = logger
        self.total_size = 0
        self.msg_bufs: List["MsgBuffer"] = []  # for status reporting only

    def over_capacity(self) -> bool:
        return self.total_size > self.my_config.buffer_size

    def _msg_stored(self, size: int) -> None:
        self.total_size += size

    def _msg_removed(self, size: int) -> None:
        self.total_size -= size


class MsgBuffer:
    """One component's buffer of not-yet-applyable messages from one peer
    (reference msgbuffers.go:121-226)."""

    __slots__ = ("component", "buffer", "node_buffer", "group", "version")

    def __init__(self, component: str, node_buffer: NodeBuffer, group=None):
        self.component = component
        # deque of (msg, cached wire size)
        self.buffer: Deque[Tuple[Msg, int]] = deque()
        self.node_buffer = node_buffer
        # Optional shared one-element counter cell: the owner's live message
        # count across a group of buffers (lets it skip drain scans cheaply).
        self.group = group
        # Monotone store counter: lets drain loops skip a re-scan when
        # neither the buffer nor the filter-relevant state has changed
        # since a scan that applied and dropped nothing (a no-op iterate
        # is observably pure, so skipping it preserves bit-identity).
        self.version = 0

    def store(self, msg: Msg) -> None:
        self.version += 1
        # Over budget: drop our own oldest first (see reference's fairness
        # note, msgbuffers.go:146-151).
        while self.node_buffer.over_capacity() and self.buffer:
            old_msg, old_size = self.buffer.popleft()
            if self.group is not None:
                self.group[0] -= 1
            self.node_buffer._msg_removed(old_size)
            self._deregister_if_empty()
            if self.node_buffer.logger is not None:
                self.node_buffer.logger.warn(
                    "dropping buffered msg",
                    component=self.component,
                    type=type(old_msg).__name__,
                )
        size = msg_size(msg)
        if not self.buffer:
            self.node_buffer.msg_bufs.append(self)
        self.buffer.append((msg, size))
        if self.group is not None:
            self.group[0] += 1
        self.node_buffer._msg_stored(size)

    def _deregister_if_empty(self) -> None:
        if not self.buffer:
            try:
                self.node_buffer.msg_bufs.remove(self)
            except ValueError:
                pass

    # next/iterate compact the deque in ONE pass instead of deleting from
    # the middle per removed entry: ``del deque[i]`` is O(n), which turned
    # big-buffer drains (cascading view changes buffer enormous message
    # piles) into O(n^2) wall time.  Kept entries preserve their relative
    # order and apply_fn-appended entries are still visited, so behavior is
    # identical to the delete-based loop.

    def next(self, filter_fn: FilterFn) -> Optional[Msg]:
        """Pop the first CURRENT message, dropping PAST/INVALID along the way;
        FUTURE messages are skipped in place (reference msgbuffers.go:178-204).

        Rotation pass (deque indexing is O(n)): scanned FUTURE entries are
        re-appended and, once the CURRENT message is found, the deque is
        rotated back so order is preserved — a front-resident CURRENT entry
        costs O(1), keeping consecutive-drain loops linear."""
        buf = self.buffer
        kept = 0
        scanned = 0
        total = len(buf)
        found = None
        while scanned < total:
            scanned += 1
            entry = buf.popleft()
            msg, size = entry
            verdict = filter_fn(self.node_buffer.id, msg)
            if verdict == Applyable.FUTURE:
                buf.append(entry)
                kept += 1
                continue
            if self.group is not None:
                self.group[0] -= 1
            self.node_buffer._msg_removed(size)
            if verdict == Applyable.CURRENT:
                found = msg
                break
        if kept:
            buf.rotate(kept)
        self._deregister_if_empty()
        return found

    def iterate(self, filter_fn: FilterFn, apply_fn: ApplyFn) -> None:
        """Apply every CURRENT message, dropping PAST/INVALID, keeping FUTURE
        (reference msgbuffers.go:206-226).

        Single pass draining the deque; kept (FUTURE) entries collect into
        a side list restored at the end, so entries stored by apply_fn
        during the pass are drained and visited too — matching the C++
        twin's compaction loop, which re-reads buffer.size().  Kept
        originals precede kept apply_fn-appended entries, as in C++."""
        buf = self.buffer
        kept = []
        while buf:
            msg, size = buf.popleft()
            verdict = filter_fn(self.node_buffer.id, msg)
            if verdict == Applyable.FUTURE:
                kept.append((msg, size))
                continue
            if self.group is not None:
                self.group[0] -= 1
            self.node_buffer._msg_removed(size)
            if verdict == Applyable.CURRENT:
                apply_fn(self.node_buffer.id, msg)
        buf.extend(kept)
        self._deregister_if_empty()

    def __len__(self) -> int:
        return len(self.buffer)
