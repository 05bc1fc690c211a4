"""In-memory mirror of the durable write-ahead log.

Rebuild of reference ``pkg/statemachine/persisted.go``.  Every append emits a
``Persist`` action mirroring the entry to disk; ``truncate`` computes the cut
index and emits a ``Truncate`` action; and — the key trick of the protocol
(reference ``docs/LogMovement.md``) — ``construct_epoch_change`` derives the
PBFT view-change message (checkpoints / P-set / Q-set) purely from the log, so
crash recovery and view change share one code path.

The reference threads a callback-struct visitor (``logIterator``) over a
linked list; here the log is a Python list of (index, entry) pairs and callers
iterate directly — simpler and faster for the host-side hot path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..messages import (
    CEntry,
    CheckpointMsg,
    ECEntry,
    EpochChange,
    EpochChangeSetEntry,
    FEntry,
    NEntry,
    PEntry,
    Persistent,
    QEntry,
    Suspect,
    TEntry,
)
from .actions import Actions


class PersistedLog:
    """Append-only in-memory WAL mirror (reference persisted.go:36-43)."""

    __slots__ = ("next_index", "entries", "logger")

    def __init__(self, logger=None):
        self.next_index = 0
        # list of (index, entry); head is entries[0] after truncation
        self.entries: List[Tuple[int, Persistent]] = []
        self.logger = logger

    # --- loading (recovery path; no Persist actions) ---

    def append_initial_load(self, index: int, entry: Persistent) -> None:
        """Append an entry already read from durable storage
        (reference persisted.go:50-68)."""
        if self.entries:
            if self.next_index != index:
                raise AssertionError(
                    f"WAL indexes out of order: expected {self.next_index}, "
                    f"got {index} — corrupted WAL?"
                )
        else:
            self.next_index = index
        self.entries.append((index, entry))
        self.next_index = index + 1

    # --- appending (normal path; emits Persist) ---

    def append(self, entry: Persistent) -> Actions:
        """Append a new entry and emit the mirroring Persist action
        (reference persisted.go:70-83).  The log must be non-empty (a fresh
        node seeds genesis CEntry/FEntry via append_initial_load)."""
        if not self.entries:
            raise AssertionError(
                "appending to an unseeded log; initialize via append_initial_load"
            )
        index = self.next_index
        self.entries.append((index, entry))
        self.next_index += 1
        return Actions().persist(index, entry)

    # typed helpers mirroring addPEntry/addQEntry/... (persisted.go:85-160)
    def add_p_entry(self, entry: PEntry) -> Actions:
        return self.append(entry)

    def add_q_entry(self, entry: QEntry) -> Actions:
        return self.append(entry)

    def add_n_entry(self, entry: NEntry) -> Actions:
        return self.append(entry)

    def add_c_entry(self, entry: CEntry) -> Actions:
        if entry.network_state is None:
            raise AssertionError("CEntry network state must be set")
        return self.append(entry)

    def add_suspect(self, entry: Suspect) -> Actions:
        return self.append(entry)

    def add_ec_entry(self, entry: ECEntry) -> Actions:
        return self.append(entry)

    def add_f_entry(self, entry: FEntry) -> Actions:
        """Gracefully end the current epoch (reconfiguration boundary).  The
        reference only ever seeds an FEntry at genesis; our reconfiguration
        path appends one when the reconfiguring checkpoint lands, per
        reference docs/LogMovement.md's intended flow."""
        return self.append(entry)

    def add_t_entry(self, entry: TEntry) -> Actions:
        return self.append(entry)

    # --- truncation (reference persisted.go:162-190) ---

    def truncate(self, low_watermark: int) -> Actions:
        """Advance the log head to the first entry that anchors the current
        watermark (CEntry ≥ low_watermark or NEntry > low_watermark) and emit
        a Truncate action for the durable WAL, if the head moved."""
        for pos, (index, entry) in enumerate(self.entries):
            if isinstance(entry, CEntry):
                if entry.seq_no < low_watermark:
                    continue
            elif isinstance(entry, NEntry):
                if entry.seq_no <= low_watermark:
                    continue
            else:
                continue

            if self.logger is not None:
                self.logger.debug(
                    "truncating WAL", seq_no=low_watermark, index=index
                )
            if pos == 0:
                break
            del self.entries[:pos]
            return Actions().truncate(index)

        return Actions()

    # --- view-change derivation (reference persisted.go:245-318) ---

    def construct_epoch_change(self, new_epoch: int) -> EpochChange:
        """Deterministically derive the epoch-change message from the log.

        P-set: for each sequence, only the *latest* PEntry before the target
        epoch survives.  Q-set: every QEntry (per epoch it was logged under).
        Checkpoints: every CEntry still in the log.  Iteration stops once the
        log's epoch (tracked via N/F entries) reaches ``new_epoch``.
        """
        # Pass 1: count PEntries per sequence so only the last one is kept.
        p_counts: Dict[int, int] = {}
        log_epoch: Optional[int] = None
        for _, entry in self.entries:
            if log_epoch is not None and log_epoch >= new_epoch:
                break
            if isinstance(entry, PEntry):
                p_counts[entry.seq_no] = p_counts.get(entry.seq_no, 0) + 1
            elif isinstance(entry, NEntry):
                log_epoch = entry.epoch_config.number
            elif isinstance(entry, FEntry):
                log_epoch = entry.ends_epoch_config.number

        # Pass 2: collect checkpoints, final P entries, and all Q entries.
        checkpoints: List[CheckpointMsg] = []
        p_set: List[EpochChangeSetEntry] = []
        q_set: List[EpochChangeSetEntry] = []
        log_epoch = None
        for _, entry in self.entries:
            if log_epoch is not None and log_epoch >= new_epoch:
                break
            if isinstance(entry, PEntry):
                remaining = p_counts[entry.seq_no]
                if remaining != 1:
                    p_counts[entry.seq_no] = remaining - 1
                    continue
                p_set.append(
                    EpochChangeSetEntry(
                        epoch=log_epoch, seq_no=entry.seq_no, digest=entry.digest
                    )
                )
            elif isinstance(entry, QEntry):
                q_set.append(
                    EpochChangeSetEntry(
                        epoch=log_epoch, seq_no=entry.seq_no, digest=entry.digest
                    )
                )
            elif isinstance(entry, NEntry):
                log_epoch = entry.epoch_config.number
            elif isinstance(entry, FEntry):
                log_epoch = entry.ends_epoch_config.number
            elif isinstance(entry, CEntry):
                checkpoints.append(
                    CheckpointMsg(seq_no=entry.seq_no, value=entry.checkpoint_value)
                )

        return EpochChange(
            new_epoch=new_epoch,
            checkpoints=tuple(checkpoints),
            p_set=tuple(p_set),
            q_set=tuple(q_set),
        )
