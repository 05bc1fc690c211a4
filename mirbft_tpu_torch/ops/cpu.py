"""CPU reference hasher (hashlib SHA-256).

The batch interface mirrors the TPU backend's so the two are swappable and
comparable bit-for-bit (the TPU kernels are tested for equality against
this implementation).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence


class CpuHasher:
    """Batch SHA-256 via hashlib; the semantics the reference gets from
    ``crypto.SHA256`` through its streaming Hasher interface
    (reference pkg/processor/serial.go:21-23)."""

    def hash_batches(self, batches: Sequence[Sequence[bytes]]) -> List[bytes]:
        out = []
        for parts in batches:
            h = hashlib.sha256()
            for part in parts:
                h.update(part)
            out.append(h.digest())
        return out
