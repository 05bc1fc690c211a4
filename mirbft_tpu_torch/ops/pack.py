"""SHA-256 waves packed on the card from one staged copy of their bytes.

The JAX package pads and packs a wave on the host (``pack_messages``, kept
verbatim in ``ops/sha256.py``) and ships the kernel-ready words: for a wave
of 4,096 messages of 640 bytes that is 4.2 MB of words for 2.6 MB of
message, a zero fill, a byte swap and, for the lanes layout, a transpose,
all on the host.  The port stages the wave instead:

* ``stage_messages`` writes the wave's raw bytes, each row's byte offset
  (int64) and length (int32) into one pooled buffer, pinned on a CUDA
  hasher (``StagingPool``).  Extra sections (the fused wave's quorum and
  verify arrays) go into the same buffer (``StagedWave.add``), so one
  host-to-device copy carries the whole wave (``StagedWave.copy_in``).
* ``StagedWave.pack`` (and ``pack_wave``, on tensors) then writes, on the
  card, exactly the words that ``pack_messages`` writes for the wave's
  layout and buckets: the CUDA kernel ``csrc/pack.cu``
  (``pack_wave_kernel``) for CUDA tensors, its plain PyTorch version
  ``pack_wave_torch`` for CPU tensors.  The hash kernels' contract does
  not change.

A staged buffer is reused only when the wave that copied from it is done:
its lease carries the wave's CUDA event, and the pool hands out a free
lease only once that event has completed (``StagingPool.acquire``); a busy
pool allocates a new buffer from torch's caching host allocator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .sha256 import _BufferPool, _next_pow2

LAYOUTS = {"batch": 0, "lanes": 1}
_ALIGN = 16
# The smallest buffer the pool hands out: small waves share one size.
_MIN_CAPACITY = 1 << 16

_TORCH_DTYPES = {
    np.dtype(np.uint8): "uint8",
    np.dtype(np.bool_): "bool",
    np.dtype(np.int32): "int32",
    np.dtype(np.uint32): "int32",  # uint32 words cross as int32 bits
    np.dtype(np.int64): "int64",
}


_U8, _I32, _I64 = np.dtype(np.uint8), np.dtype(np.int32), np.dtype(np.int64)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class StagingLease:
    """One pooled staging buffer: ``flat`` (a uint8 tensor, pinned for a
    CUDA hasher), ``host`` (a numpy view of it) and ``event``, the CUDA
    event of the last wave that copied from it (None until one did, and on
    the CPU)."""

    __slots__ = ("key", "flat", "host", "event")

    def __init__(self, key, flat):
        self.key = key
        self.flat = flat
        self.host = flat.numpy()
        self.event = None

    def idle(self) -> bool:
        return self.event is None or self.event.query()


class StagingPool(_BufferPool):
    """``_BufferPool``'s free lists (at most ``cap`` leases a size) over
    staging buffers, keyed by ``("staged", capacity)``: the capacity is the
    wave's bytes rounded up to a power of two, at least 64 KB.  ``pinned``
    allocates page-locked host memory (``torch.empty(pin_memory=True)``,
    from torch's caching host allocator)."""

    def __init__(self, pinned: bool, cap: int = 4):
        super().__init__(cap)
        self.pinned = pinned

    def acquire(self, nbytes: int) -> StagingLease:  # type: ignore[override]
        import torch

        capacity = max(_MIN_CAPACITY, _next_pow2(nbytes))
        key = ("staged", capacity)
        free = self._free.get(key)
        if free:
            # Newest first; a lease whose wave is still copying is skipped,
            # never refilled.
            for i in range(len(free) - 1, -1, -1):
                if free[i].idle():
                    return free.pop(i)
        flat = torch.empty(capacity, dtype=torch.uint8, pin_memory=self.pinned)
        return StagingLease(key, flat)


class StagedWave:
    """A hash wave staged for the card: its raw bytes and row index in a
    pooled buffer, and the shape ``pack_messages`` would give it (``layout``,
    ``batch`` rows, ``bucket`` blocks a row).  ``sections`` maps each
    staged array's name to (byte offset, numpy dtype, shape); ``nbytes`` is
    the staged length.  ``copy_in`` makes the one copy to the device."""

    __slots__ = ("count", "layout", "batch", "bucket", "lease", "nbytes", "sections",
                 "pool")

    def __init__(self, count, layout, batch, bucket, lease, pool):
        self.count = count
        self.layout = layout
        self.batch = batch
        self.bucket = bucket
        self.lease = lease
        self.pool = pool
        self.nbytes = 0
        self.sections: Dict[str, Tuple[int, np.dtype, tuple]] = {}

    @property
    def blocks_shape(self) -> tuple:
        """The packed words' shape in this wave's layout."""
        if self.layout == "lanes":
            from .sha256_pallas_lanes import LANES, SUB, TILE

            return (self.batch // TILE, self.bucket, 16, SUB, LANES)
        return (self.batch, self.bucket, 16)

    def reserve(self, name: str, dtype, shape) -> np.ndarray:
        """A new section of ``dtype`` and ``shape`` at the staged end, as a
        writable numpy view of the buffer; the buffer grows (into a larger
        lease, the staged bytes copied over) if it must.  Call before
        ``copy_in``: nothing may have copied from the buffer yet."""
        dtype = np.dtype(dtype)
        offset = _aligned(self.nbytes)
        size = math.prod(shape) * dtype.itemsize
        end = offset + size
        if end + _ALIGN > self.lease.flat.numel():
            bigger = self.pool.acquire(end + _ALIGN)
            bigger.host[: self.nbytes] = self.lease.host[: self.nbytes]
            # The smaller buffer is dropped (its memory goes back to torch's
            # caching host allocator): a wave holds one lease, which its
            # collect returns.
            self.lease = bigger
        self.sections[name] = (offset, dtype, tuple(shape))
        self.nbytes = end
        return self.lease.host[offset:end].view(dtype).reshape(shape)

    def add(self, name: str, arr: np.ndarray) -> None:
        """Stage a host array as section ``name``."""
        arr = np.ascontiguousarray(arr)
        self.reserve(name, arr.dtype, arr.shape)[...] = arr

    def copy_in(self, device):
        """The staged buffer on ``device``: one host-to-device copy of the
        whole buffer on the current stream, without waiting (the lease must
        then outlive the copy: the caller sets ``lease.event`` after its
        launches).  On the CPU, the buffer itself."""
        flat = self.lease.flat[: _aligned(self.nbytes)]
        if device.type == "cuda":
            flat = flat.to(device, non_blocking=True)
        return flat

    def views(self, flat, names: Optional[Sequence[str]] = None) -> Dict[str, object]:
        """Sections ``names`` (all by default) of ``flat`` (``copy_in``'s
        buffer) as tensors with the staged bits."""
        import torch

        # One typed view of the buffer a dtype, then a slice a section (the
        # sections are 16-byte aligned): few tensor operations a wave.
        typed, out = {}, {}
        for name in self.sections if names is None else names:
            offset, dtype, shape = self.sections[name]
            view = typed.get(dtype)
            if view is None:
                view = typed[dtype] = flat.view(getattr(torch, _TORCH_DTYPES[dtype]))
            start = offset // dtype.itemsize
            size = math.prod(shape)
            section = view[start : start + size]
            out[name] = section if len(shape) == 1 else section.view(shape)
        return out

    def pack(self, flat):
        """The wave's (blocks, n_blocks) from ``flat`` (``copy_in``'s
        buffer): on the card the pack kernel, launched on pointers into the
        buffer (no tensor a section); on the CPU ``pack_wave`` over the
        sections' views."""
        if flat.device.type == "cuda":
            base = flat.data_ptr()
            return _launch(
                base + self.sections["raw"][0], self.sections["raw"][2][0],
                base + self.sections["offsets"][0], base + self.sections["lengths"][0],
                self.count, self.batch, self.bucket, self.layout, flat.device,
            )
        t = self.views(flat, ("raw", "offsets", "lengths"))
        return pack_wave(t["raw"], t["offsets"], t["lengths"], self.batch, self.bucket,
                         self.layout)

    def section(self, name: str) -> np.ndarray:
        """Section ``name`` as a numpy view of the staged buffer."""
        offset, dtype, shape = self.sections[name]
        size = math.prod(shape) * dtype.itemsize
        return self.lease.host[offset : offset + size].view(dtype).reshape(shape)


def wave_shape(
    lengths: np.ndarray,
    block_bucket: Optional[int],
    batch_bucket: Optional[int],
    layout: str,
    batch_multiple: int = 1,
) -> Tuple[int, int]:
    """(batch, bucket) of a wave of messages of ``lengths`` bytes: the
    buckets ``pack_messages`` gives it (the same rounding, in the same
    order)."""
    n = len(lengths)
    nb_real = (lengths + 8) // 64 + 1
    bucket = _next_pow2(int(nb_real.max())) if n else 1
    if block_bucket is not None:
        bucket = max(bucket, block_bucket)
    batch = _next_pow2(n)
    if batch_bucket is not None:
        batch = max(batch, batch_bucket)
    if layout == "lanes":
        from .sha256_pallas_lanes import TILE

        batch = ((batch + TILE - 1) // TILE) * TILE
    if batch_multiple > 1:
        batch = ((batch + batch_multiple - 1) // batch_multiple) * batch_multiple
    return batch, bucket


def stage_messages(
    messages: Sequence[bytes],
    block_bucket: Optional[int] = None,
    batch_bucket: Optional[int] = None,
    *,
    layout: str = "batch",
    batch_multiple: int = 1,
    pool: StagingPool,
) -> StagedWave:
    """Stage a wave: its raw bytes (``raw``), each row's first byte
    (``offsets``, int64) and length (``lengths``, int32) in one pooled
    buffer, with the buckets of ``pack_messages``.  Vectorized: one join,
    one copy into the buffer, one cumulative sum."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    n = len(messages)
    lengths = np.fromiter(map(len, messages), dtype=np.int64, count=n)
    batch, bucket = wave_shape(lengths, block_bucket, batch_bucket, layout, batch_multiple)
    total = int(lengths.sum())
    # The three sections at fixed places (the buffer is sized for them):
    # no per-section bookkeeping of ``reserve``.
    at_offsets = _aligned(total)
    at_lengths = at_offsets + _aligned(8 * n)
    end = at_lengths + 4 * n
    wave = StagedWave(n, layout, batch, bucket, pool.acquire(end + _ALIGN), pool)
    host = wave.lease.host
    if total:
        host[:total] = np.frombuffer(b"".join(messages), dtype=np.uint8)
    offsets = host[at_offsets : at_offsets + 8 * n].view(np.int64)
    np.cumsum(lengths, out=offsets)
    offsets -= lengths
    host[at_lengths:end].view(np.int32)[:] = lengths
    wave.sections = {"raw": (0, _U8, (total,)), "offsets": (at_offsets, _I64, (n,)),
                     "lengths": (at_lengths, _I32, (n,))}
    wave.nbytes = end
    return wave


# ---------------------------------------------------------------------------
# The kernel's wrapper and its plain version.
# ---------------------------------------------------------------------------


def _check(raw, offsets, lengths, batch, bucket, layout):
    import torch

    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    for name, t, dtype in (("raw", raw, torch.uint8), ("offsets", offsets, torch.int64),
                           ("lengths", lengths, torch.int32)):
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != raw.device:
            raise ValueError("raw, offsets and lengths must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if offsets.shape != lengths.shape:
        raise ValueError("offsets and lengths must have one entry a row")
    if not 0 <= lengths.shape[0] <= batch:
        raise ValueError(f"{lengths.shape[0]} rows do not fit a wave of {batch}")
    if not 1 <= bucket <= 65535:
        raise ValueError(f"block bucket {bucket} outside 1..65535")
    if layout == "lanes":
        from .sha256_pallas_lanes import TILE

        if batch % TILE:
            raise ValueError(f"a lanes wave's batch must be a multiple of {TILE}")


def _outputs(batch, bucket, layout, device):
    import torch

    if layout == "lanes":
        from .sha256_pallas_lanes import LANES, SUB, TILE

        shapes = ((batch // TILE, bucket, 16, SUB, LANES), (batch // TILE, 1, SUB, LANES))
    else:
        shapes = ((batch, bucket, 16), (batch,))
    return tuple(torch.empty(s, dtype=torch.int32, device=device) for s in shapes)


def pack_wave_torch(raw, offsets, lengths, batch: int, bucket: int, layout: str):
    """Plain PyTorch version of the pack kernel: the staged wave (``raw``
    uint8, ``offsets`` int64 and ``lengths`` int32 a row) -> (blocks,
    n_blocks) int32 tensors with the bits ``pack_messages`` gives for
    ``layout`` at ``batch`` rows and ``bucket`` blocks a row."""
    import torch

    device = raw.device
    n = lengths.shape[0]
    row_bytes = bucket * 64
    length = lengths.to(torch.int64)
    out = torch.zeros(batch * row_bytes, dtype=torch.uint8, device=device)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    total = int(length.sum()) if n else 0
    if total:
        row_of = torch.repeat_interleave(rows, length, output_size=total)
        # Each byte's position in its row: its index less its row's start
        # in the concatenation.
        start = torch.cumsum(length, 0) - length
        j = torch.arange(total, dtype=torch.int64, device=device) - start[row_of]
        out[row_of * row_bytes + j] = raw[offsets[row_of] + j]
    nb = (length + 8) // 64 + 1
    out[rows * row_bytes + length] = 0x80
    shifts = torch.arange(56, -8, -8, dtype=torch.int64, device=device)
    length_bytes = ((length * 8)[:, None] >> shifts[None, :]) & 0xFF
    tail = (rows * row_bytes + nb * 64 - 8)[:, None] + torch.arange(8, device=device)[None, :]
    out[tail.reshape(-1)] = length_bytes.reshape(-1).to(torch.uint8)
    # Big-endian words: each word's four bytes reversed, read as int32.
    words = out.view(-1, 4).flip(1).contiguous().view(torch.int32)
    blocks = words.view(batch, bucket, 16)
    n_blocks = torch.zeros(batch, dtype=torch.int32, device=device)
    n_blocks[:n] = nb.to(torch.int32)
    if layout == "lanes":
        from .sha256_pallas_lanes import LANES, SUB, TILE

        tiles = batch // TILE
        blocks = blocks.view(tiles, SUB, LANES, bucket, 16).permute(0, 3, 4, 1, 2).contiguous()
        n_blocks = n_blocks.view(tiles, 1, SUB, LANES)
    return blocks, n_blocks


def _launch(raw, raw_bytes, offsets, lengths, n, batch, bucket, layout, device):
    """The pack kernel on device pointers (``raw`` with ``raw_bytes``
    readable bytes, ``offsets`` int64 and ``lengths`` int32 of ``n`` rows)
    on ``device``'s current stream: (blocks, n_blocks)."""
    import torch

    from . import _build

    blocks, n_blocks = _outputs(batch, bucket, layout, device)
    lib = _build.library("pack")
    code = lib.mirbft_pack_wave(
        raw, raw_bytes, offsets, lengths, n, batch, bucket, LAYOUTS[layout],
        blocks.data_ptr(), n_blocks.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, code, "pack_wave")
    pack_wave.launches += 1
    return blocks, n_blocks


def pack_wave(raw, offsets, lengths, batch: int, bucket: int, layout: str):
    """Pack a staged wave into its layout's words: the CUDA kernel
    (``csrc/pack.cu``) for CUDA tensors, the plain version for CPU tensors.
    Returns (blocks, n_blocks) int32 tensors on ``raw``'s device and counts
    kernel launches in ``pack_wave.launches``."""
    _check(raw, offsets, lengths, batch, bucket, layout)
    if raw.device.type == "cpu":
        return pack_wave_torch(raw, offsets, lengths, batch, bucket, layout)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    return _launch(raw.data_ptr(), raw.numel(), offsets.data_ptr(), lengths.data_ptr(),
                   lengths.shape[0], batch, bucket, layout, raw.device)


pack_wave.launches = 0
