"""Batched SHA-256 on the card: host packing, the plain PyTorch twin, and
the ``TorchHasher`` that drives the CUDA kernels.

The crypto hot path of the framework: every ``ActionHashRequest`` of a
cluster-wide wave becomes one row of a fixed-shape uint32 array and the whole
wave is digested by one kernel launch.  The host side (padding, the
vectorized pooled packer in both layouts, digest unpacking) is the JAX
package's numpy code, copied unchanged: the mesh hasher packs with it, and
it is the reference for the staged waves that ``TorchHasher`` hands the
card instead (raw bytes in one pinned copy, the layout written by the pack
kernel: ``ops/pack.py``).  The device side is two hand-written CUDA kernels
(``csrc/sha256.cu``): the lanes-major kernel (``sha256_pallas_lanes.py``)
for waves at or past the measured crossover (``crossover.py``) and the
batch-major kernel (``sha256_pallas.py``) below it.

``sha256_batch_torch`` is the plain PyTorch version of the
``[B, L, 16] -> [B, 8]`` contract, written in the kernels' two stages: a
schedule pass over every block at once (``schedule_torch``, the producer
warps' work) and the round chain with the kernels' folded adds and Ch/Maj
formulas (``rounds_torch``, the consumer warp's).  Torch has no unsigned 32-bit arithmetic
worth the name and ``>>`` on int32 is arithmetic, so the twin widens every
word to int64 and masks with ``0xFFFFFFFF`` after each add, shift and not.
Tensors cross as int32 bit patterns of the uint32 words (``wave_to_torch``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Round constants (FIPS 180-4).
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
        0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
        0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
        0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
        0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
        0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
        0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
        0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
        0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
        0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
        0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)


# ---------------------------------------------------------------------------
# Plain PyTorch twin: int64 arithmetic masked to 32 bits.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotr(x, n: int):
    # x holds values in [0, 2**32): >> is logical there, and x << 30 still
    # fits in int64.
    return ((x >> n) | (x << (32 - n))) & _M32


def schedule_torch(words):
    """The kernels' producer stage for every block of every row at once:
    ``words`` [L, 16, N] int64 (values < 2**32) -> KW [L, 64, N], the
    expanded message schedule with the round constants added,
    ``KW[t] = W[t] + K[t]``."""
    import torch

    w = list(words.unbind(1))
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    k = torch.from_numpy(_K.astype(np.int64)).to(words.device)
    return (torch.stack(w, 1) + k[:, None]) & _M32


def rounds_torch(kw, n_blocks):
    """The kernels' consumer stage: KW [L, 64, N] int64, ``n_blocks`` [N]
    int64 -> [8, N] int64 state words.  Each block is 64 rounds with the
    kernel's folded adds (h + KW and d summed apart from the loop-carried
    Σ1 + Ch) and its Ch and Maj formulas; blocks at index >= n_blocks leave
    a row's state unchanged (rows with 0 keep H0)."""
    import torch

    count = kw.shape[2]
    state = [
        torch.full((count,), int(h0), dtype=torch.int64, device=kw.device)
        for h0 in _H0
    ]
    for blk in range(kw.shape[0]):
        live = n_blocks > blk
        a, b, c, d, e, f, g, h = state
        for t in range(64):
            hk = h + kw[blk, t]
            hkd = hk + d
            big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = g ^ (e & (f ^ g))
            big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) | (c & (a | b))
            hks = hk + big_s0 + maj
            h, g, f, e = g, f, e, (ch + hkd + big_s1) & _M32
            d, c, b, a = c, b, a, (ch + hks + big_s1) & _M32
        new = (a, b, c, d, e, f, g, h)
        state = [torch.where(live, (s + n) & _M32, s) for s, n in zip(state, new)]
    return torch.stack(state)


def sha256_words_torch(words, n_blocks):
    """Core of both twins, in the kernels' two stages: ``words`` [L, 16, N]
    int64 (values < 2**32), ``n_blocks`` [N] int64 -> [8, N] int64 state
    words.  Only the blocks up to the longest row's last one are expanded
    and hashed."""
    blocks = int(n_blocks.clamp(max=words.shape[0]).max()) if words.shape[2] else 0
    return rounds_torch(schedule_torch(words[:blocks]), n_blocks)


def widen_u32(x):
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    import torch

    return x.to(torch.int64) & _M32


def narrow_u32(x):
    """int64 values in [0, 2**32) -> the same bits as int32."""
    import torch

    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def sha256_batch_torch(blocks, n_blocks):
    """Plain PyTorch digest of a batch: blocks [B, L, 16] int32 (uint32
    bits), n_blocks [B] -> [B, 8] int32 digest words."""
    words = widen_u32(blocks).permute(1, 2, 0)
    state = sha256_words_torch(words, widen_u32(n_blocks.reshape(-1)))
    return narrow_u32(state.t().contiguous())


def words_to_torch(arr: np.ndarray, device):
    """A numpy array of uint32 words -> an int32 tensor with the same bits
    on ``device``: the form every kernel of the port takes words in."""
    import torch

    arr = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def wave_to_torch(blocks: np.ndarray, n_blocks: np.ndarray, device):
    """A packed wave's numpy uint32 arrays (either layout) -> int32 tensors
    with the same bits on ``device``.  The only state that crosses between
    the JAX package and the port: the kernels consume exactly these."""
    return words_to_torch(blocks, device), words_to_torch(n_blocks, device)

# ---------------------------------------------------------------------------
# Host-side packing: bytes -> padded uint32 block arrays (vectorized, pooled).
# ---------------------------------------------------------------------------


def pad_message(message: bytes) -> np.ndarray:
    """SHA-256 padding: message || 0x80 || zeros || 64-bit bit length,
    as an [n_blocks, 16] uint32 (big-endian words) array.

    Per-message reference implementation — the dispatch path uses the
    vectorized ``pack_messages`` and tests pin the two against each other."""
    length = len(message)
    n_blocks = (length + 8) // 64 + 1
    buf = np.zeros(n_blocks * 64, dtype=np.uint8)
    buf[:length] = np.frombuffer(message, dtype=np.uint8)
    buf[length] = 0x80
    bit_len = length * 8
    buf[-8:] = np.frombuffer(bit_len.to_bytes(8, "big"), dtype=np.uint8)
    return buf.view(">u4").astype(np.uint32).reshape(n_blocks, 16)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def digests_from_words(words: np.ndarray) -> List[bytes]:
    """[B, 8] uint32 -> list of 32-byte digests.

    One bulk big-endian conversion + ``memoryview`` slicing — no per-row
    numpy calls (the per-row ``tobytes()`` loop was a measurable slice of
    dispatch wall time at wave sizes)."""
    buf = np.ascontiguousarray(words).astype(">u4").tobytes()
    view = memoryview(buf)
    return [bytes(view[i * 32 : i * 32 + 32]) for i in range(words.shape[0])]


class _Lease:
    """One pooled set of packing buffers, alive from ``acquire`` until the
    matching ``collect`` releases it.  The jax CPU backend may zero-copy
    alias numpy inputs, so a buffer must never be refilled while a dispatch
    that read it is still in flight; ``collect`` blocks on materialization,
    which makes release-at-collect safe on every backend."""

    __slots__ = ("key", "flat", "n_blocks", "scratch")

    def __init__(self, key, flat, n_blocks, scratch):
        self.key = key  # (layout, batch, bucket)
        self.flat = flat  # uint8 [batch * bucket * 64], kernel-layout bytes
        self.n_blocks = n_blocks  # uint32, kernel-layout shaped
        self.scratch = scratch  # uint8 batch-major staging (lanes only)


class _BufferPool:
    """Reusable packing buffers keyed by (layout, batch bucket, block
    bucket).  Dual bucketing means steady-state traffic cycles through a
    handful of shapes, so pooled buffers remove the dominant allocation +
    zero-fill cost from the dispatch path.  At most ``cap`` free buffers are
    kept per key; extras are dropped to the GC."""

    def __init__(self, cap: int = 4):
        self.cap = cap
        self._free: Dict[tuple, List[_Lease]] = {}

    def acquire(self, layout: str, batch: int, bucket: int) -> _Lease:
        key = (layout, batch, bucket)
        free = self._free.get(key)
        if free:
            return free.pop()
        nbytes = batch * bucket * 64
        flat = np.empty(nbytes, dtype=np.uint8)
        if layout == "lanes":
            from .sha256_pallas_lanes import LANES, SUB, TILE

            n_blocks = np.empty((batch // TILE, 1, SUB, LANES), dtype=np.uint32)
            scratch = np.empty(nbytes, dtype=np.uint8)
        else:
            n_blocks = np.empty(batch, dtype=np.uint32)
            scratch = None
        return _Lease(key, flat, n_blocks, scratch)

    def release(self, lease: _Lease) -> None:
        free = self._free.setdefault(lease.key, [])
        if len(free) < self.cap:
            free.append(lease)


class PackedWave:
    """Kernel-ready arrays from ``pack_messages`` plus the pooled lease (if
    any).  Unpacks as ``blocks, n_blocks = pack_messages(...)`` for callers
    that only want the arrays."""

    __slots__ = ("blocks", "n_blocks", "count", "layout", "lease")

    def __init__(self, blocks, n_blocks, count, layout, lease=None):
        self.blocks = blocks
        self.n_blocks = n_blocks
        self.count = count
        self.layout = layout
        self.lease = lease

    def __iter__(self):
        return iter((self.blocks, self.n_blocks))


def pack_messages(
    messages: Sequence[bytes],
    block_bucket: Optional[int] = None,
    batch_bucket: Optional[int] = None,
    *,
    layout: str = "batch",
    batch_multiple: int = 1,
    pool: Optional[_BufferPool] = None,
) -> PackedWave:
    """Vectorized SHA-256 packer: pad + pack a whole wave with bulk numpy
    arithmetic instead of a per-message ``pad_message`` loop.

    Rows are grouped by byte length so each distinct length costs one
    ``b"".join`` + one 2D slice assign; the 0x80 terminator and big-endian
    64-bit bit-length words are written with n-element fancy assignments.
    The uint32 big-endian word view is produced by one in-place byteswap.

    ``layout="batch"`` returns [batch, bucket, 16] / [batch] for the scan
    and batch-major pallas kernels; ``layout="lanes"`` returns
    [tiles, bucket, 16, 8, 128] / [tiles, 1, 8, 128] packed directly for
    the lanes-major pallas kernel (no device-side relayout).

    ``pool`` reuses buffers keyed by the (layout, batch, bucket) shape —
    zero steady-state allocation; the caller must route the returned lease
    through ``TpuHasher.collect`` (or ``_BufferPool.release``) before the
    same shape is packed twice concurrently."""
    n = len(messages)
    lengths = np.fromiter((len(m) for m in messages), dtype=np.int64, count=n)
    nb_real = (lengths + 8) // 64 + 1
    bucket = _next_pow2(int(nb_real.max())) if n else 1
    if block_bucket is not None:
        bucket = max(bucket, block_bucket)
    batch = _next_pow2(n)
    if batch_bucket is not None:
        batch = max(batch, batch_bucket)
    if layout == "lanes":
        from .sha256_pallas_lanes import LANES, SUB, TILE

        batch = ((batch + TILE - 1) // TILE) * TILE
    if batch_multiple > 1:
        batch = ((batch + batch_multiple - 1) // batch_multiple) * batch_multiple
    row_bytes = bucket * 64

    lease = pool.acquire(layout, batch, bucket) if pool is not None else None
    if lease is not None:
        flat, n_blocks_arr, scratch = lease.flat, lease.n_blocks, lease.scratch
    else:
        flat = np.empty(batch * row_bytes, dtype=np.uint8)
        if layout == "lanes":
            n_blocks_arr = np.empty((batch // TILE, 1, SUB, LANES), dtype=np.uint32)
            scratch = np.empty(batch * row_bytes, dtype=np.uint8)
        else:
            n_blocks_arr = np.empty(batch, dtype=np.uint32)
            scratch = None

    staging = scratch if layout == "lanes" else flat
    staging.fill(0)
    rows2d = staging.reshape(batch, row_bytes)

    groups: Dict[int, List[int]] = {}
    for i, m in enumerate(messages):
        groups.setdefault(len(m), []).append(i)
    for length, idx in groups.items():
        if length == 0:
            continue
        cat = np.frombuffer(b"".join(messages[i] for i in idx), dtype=np.uint8)
        rows2d[np.asarray(idx), :length] = cat.reshape(len(idx), length)

    rows = np.arange(n, dtype=np.int64)
    rows2d[rows, lengths] = 0x80
    tail = (nb_real * 64 - 8)[:, None] + np.arange(8, dtype=np.int64)[None, :]
    bits = (lengths * 8).astype(np.uint64)
    be = (
        (bits[:, None] >> (np.arange(8, dtype=np.uint64)[::-1] * np.uint64(8)))
        & np.uint64(0xFF)
    ).astype(np.uint8)
    rows2d[np.broadcast_to(rows[:, None], tail.shape), tail] = be

    nb_flat = n_blocks_arr.reshape(batch)
    nb_flat[:n] = nb_real
    nb_flat[n:] = 0

    if layout == "batch":
        words = staging.view(np.uint32)
        words.byteswap(inplace=True)
        blocks = words.reshape(batch, bucket, 16)
    else:
        tiles = batch // TILE
        blocks = flat.view(np.uint32).reshape(tiles, bucket, 16, SUB, LANES)
        np.copyto(
            blocks,
            staging.view(np.uint32)
            .reshape(tiles, SUB, LANES, bucket, 16)
            .transpose(0, 3, 4, 1, 2),
        )
        blocks.byteswap(inplace=True)
    return PackedWave(blocks, n_blocks_arr, n, layout, lease)


def _metrics():
    from .. import metrics

    return metrics


class DeviceWords:
    """A wave's digest words on the device, with the event recorded after
    its launch: ``is_ready`` polls the event without blocking (CPU results
    are ready at once)."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event=None):
        self.tensor = tensor
        self.event = event

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()


class HashDispatch:
    """An in-flight wave: the result words are still on the device;
    ``TorchHasher.collect`` copies them to the host.  Carries the packing
    lease so ``collect`` can return the pooled buffer."""

    __slots__ = ("words", "count", "layout", "lease")

    def __init__(self, words, count: int, layout: str = "batch", lease=None):
        self.words = words  # DeviceWords over [B, 8] or [tiles, 8, 8, 128]
        self.count = count  # real rows
        self.layout = layout
        self.lease = lease


class TorchHasher:
    """Batched SHA-256 ``processor.Hasher`` backed by the CUDA kernels.

    The surface of the JAX package's ``TpuHasher``: ``hash_batches`` groups
    the messages into (block-bucket, batch-bucket) shaped waves and returns
    digests in input order; ``pack`` / ``dispatch_packed`` / ``collect``
    split one wave into host staging, an asynchronous copy and launches,
    and the blocking copy back.

    ``kernel``: "auto" (the measured crossover of ``crossover.py``: "lanes"
    on the card at or past the crossover wave, "scan" below it and always
    on the CPU), "lanes" (the lanes-major kernel), or "scan" / "pallas"
    (both the batch-major kernel on the card — the two JAX programs share
    its contract).

    ``device``: "cuda" (the default) or "cpu".  On the CPU every wave runs
    the kernels' plain PyTorch twins; asking for "cuda" without a card
    raises.

    ``mesh``: an optional ``parallel.Mesh`` of ``device``'s kind; when set,
    waves shard the batch dimension across the mesh via ``sharded_sha256``
    (forces the batch-major layout) and the ``mesh_hash_dispatches`` /
    ``mesh_hashed_messages`` counters track the traffic."""

    def __init__(
        self,
        min_device_batch: int = 32,
        max_block_bucket: int = 1 << 14,
        kernel: str = "auto",
        device="cuda",
        mesh=None,
    ):
        import torch

        self.min_device_batch = min_device_batch
        self.max_block_bucket = max_block_bucket
        if kernel not in ("auto", "scan", "pallas", "lanes"):
            raise ValueError(f"unknown sha256 kernel {kernel!r}")
        self.kernel = kernel
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchHasher(device='cuda') needs a CUDA device; pass "
                "device='cpu' for the plain PyTorch twins"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self._cpu = None
        self._mesh_fn = None
        self._mesh_size = 0
        if mesh is None:
            from .pack import StagingPool

            self._pool = StagingPool(pinned=self.device.type == "cuda")
        else:
            from ..parallel.mesh import sharded_sha256

            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"a {mesh.device_type} mesh for a {self.device.type} hasher"
                )
            self._pool = _BufferPool()
            self._mesh_fn = sharded_sha256(mesh)
            self._mesh_size = mesh.size
        if kernel == "auto" and self.device.type == "cuda":
            # Take the one-time crossover probe now, not inside a wave.
            from .crossover import hash_crossover_batch

            hash_crossover_batch(self.device.type)

    def kernel_for_batch(self, batch: int) -> str:
        """The kernel one wave of ``batch`` messages will run: explicit
        settings pass through; ``auto`` applies the measured crossover."""
        from .crossover import resolve_hash_kernel

        return resolve_hash_kernel(self.kernel, batch, backend=self.device.type)

    def pack(
        self,
        messages: Sequence[bytes],
        block_bucket: Optional[int] = None,
        batch_bucket: Optional[int] = None,
    ):
        """Phase 1, shaped for the kernel this wave resolves to
        (lanes-major for "lanes").  Without a mesh the wave is staged, not
        packed: its raw bytes and row index go into one pooled (on the card,
        pinned) buffer, and the pack kernel writes the layout on the device
        at dispatch (``ops/pack.py``; returns a ``StagedWave``).  A mesh
        hasher packs on the host (``pack_messages``: the shards take host
        blocks; returns a ``PackedWave``)."""
        start = time.perf_counter()
        batch_hint = max(len(messages), batch_bucket or 0)
        layout = (
            "lanes"
            if self.kernel_for_batch(batch_hint) == "lanes"
            and self._mesh_fn is None
            else "batch"
        )
        if self._mesh_fn is None:
            from .pack import stage_messages

            packed = stage_messages(
                messages, block_bucket, batch_bucket, layout=layout, pool=self._pool
            )
        else:
            packed = pack_messages(
                messages,
                block_bucket,
                batch_bucket,
                layout=layout,
                batch_multiple=self._mesh_size,
                pool=self._pool,
            )
        _metrics().histogram("hash_pack_seconds").observe(
            time.perf_counter() - start
        )
        return packed

    def dispatch_packed(self, packed) -> HashDispatch:
        """Phase 2: one copy of the staged wave to the device, the pack
        kernel and ONE hash kernel on the current stream (with a mesh, the
        host-packed blocks to each shard and a kernel a shard); returns
        without waiting for the kernels."""
        from .sha256_pallas import sha256_batch
        from .sha256_pallas_lanes import sha256_lanes

        start = time.perf_counter()
        if self._mesh_fn is not None:
            words = self._mesh_fn(packed.blocks, packed.n_blocks)
            m = _metrics()
            m.counter("mesh_hash_dispatches").inc()
            m.counter("mesh_hashed_messages").inc(packed.count)
        else:
            blocks, n_blocks = packed.pack(packed.copy_in(self.device))
            if packed.layout == "lanes":
                words = sha256_lanes(blocks, n_blocks)
            else:
                words = sha256_batch(blocks, n_blocks)
        event = None
        if words.is_cuda:
            import torch

            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(words.device))
            if self._mesh_fn is None:
                # The staged buffer is reused only once this event is done.
                packed.lease.event = event
        _metrics().histogram("hash_device_dispatch_seconds").observe(
            time.perf_counter() - start
        )
        return HashDispatch(
            DeviceWords(words, event), packed.count, packed.layout, packed.lease
        )

    def dispatch(
        self,
        messages: Sequence[bytes],
        block_bucket: Optional[int] = None,
        batch_bucket: Optional[int] = None,
    ) -> HashDispatch:
        """Pack + launch one same-bucket wave without blocking."""
        return self.dispatch_packed(
            self.pack(messages, block_bucket, batch_bucket)
        )

    def collect(self, handle: HashDispatch) -> List[bytes]:
        """Block until a wave's digests are on the host; return them in
        input order and release the packing buffers to the pool."""
        words = handle.words.tensor.cpu().numpy().view(np.uint32)
        if handle.layout == "lanes":
            from .sha256_pallas_lanes import TILE

            tiles = words.shape[0]
            words = words.transpose(0, 2, 3, 1).reshape(tiles * TILE, 8)
        digests = digests_from_words(words[: handle.count])
        if handle.lease is not None:
            # The copy to the host above waited for the kernel, and the
            # host-to-device copy of the staged buffer came before it on
            # the same stream: nothing reads the pooled buffer any more.
            self._pool.release(handle.lease)
            handle.lease = None
        return digests

    def _hash_cpu(self, batches: Sequence[Sequence[bytes]]) -> List[bytes]:
        if self._cpu is None:
            from .cpu import CpuHasher

            self._cpu = CpuHasher()
        return self._cpu.hash_batches(batches)

    def hash_batches(self, batches: Sequence[Sequence[bytes]]) -> List[bytes]:
        if len(batches) < self.min_device_batch:
            return self._hash_cpu(batches)

        messages = [b"".join(parts) for parts in batches]

        # Group indices by power-of-two block bucket; degenerate huge
        # messages hash on the host rather than shipping an outsized
        # one-off shape to the device.
        groups: Dict[int, List[int]] = {}
        cpu_indices: List[int] = []
        for i, m in enumerate(messages):
            bucket = _next_pow2((len(m) + 8) // 64 + 1)
            if bucket > self.max_block_bucket:
                cpu_indices.append(i)
            else:
                groups.setdefault(bucket, []).append(i)

        out: List[Optional[bytes]] = [None] * len(messages)
        # Launch every device group before collecting any: the device works
        # through wave k while the host packs wave k+1.
        in_flight: List[Tuple[List[int], HashDispatch]] = []
        for bucket in sorted(groups):
            indices = groups[bucket]
            handle = self.dispatch(
                [messages[i] for i in indices], block_bucket=bucket
            )
            in_flight.append((indices, handle))
        if cpu_indices:
            for i, d in zip(
                cpu_indices, self._hash_cpu([batches[i] for i in cpu_indices])
            ):
                out[i] = d
        for indices, handle in in_flight:
            for i, d in zip(indices, self.collect(handle)):
                out[i] = d
        return out  # type: ignore[return-value]
