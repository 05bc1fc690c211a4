"""Device-resident quorum plane: ack/vote accumulation on the card.

The cluster-wide canonical ack state is a pair of fixed-shape integer
tensors,

    masks  [W, D, 8]  uint32 bits (int32 tensors) — per (req-slot,
                      digest-slot) 256-bit replica bitmask, one word per 32
                      replicas
    counts [W, D]     int32 — popcounts of the masks

and one broadcast wave is a padded touch tensor ``[K, 2]`` of (req-slot,
digest-slot) rows plus its source replica id.  A wave ORs the source bit into
every touched mask, counts the touches whose bit was new, and returns the
per-touch post-counts, so quorum crossings fall out as ``post ∈ {wq-1, wq,
sq-1, sq}`` comparisons (``crossings``).  A whole stream of N waves runs in
one launch.

The host side (``MASK_WORDS``, ``pack_wave_stream``, ``host_accumulate``,
``crossings``) is the JAX package's numpy code, copied unchanged.  The device
side is one hand-written CUDA kernel (``csrc/quorum.cu``,
``quorum_accumulate_kernel``: what bounds it and what its design does about
that are noted there), which also carries the fused wave's digest gate
(``ops/fused.py``).  ``accumulate_torch`` is the plain PyTorch version of
the JAX scan and ``gate_torch`` of the gate; ``quorum_accumulate`` takes
them for CPU tensors only.

The index rules are the JAX program's, not ``host_accumulate``'s (which
raises on them): a negative index is taken from the end; a read still out of
range is clamped to the edge; a write still out of range is dropped.  Every
touch of a wave reads the old words before any writes, so a (slot, digest)
pair touched twice in one wave counts twice (``pack_wave_stream`` rejects
such waves; the fused pipeline's packer does not).

``masks`` and ``counts`` are updated in place, where the JAX program donates
them; ``device_accumulate`` returns the same tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

MASK_WORDS = 8  # 256 replicas


def pack_wave_stream(
    waves: Sequence[Tuple[int, Sequence[Tuple[int, int]]]], k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack [(source, [(req_slot, dig_slot), ...]), ...] into fixed shapes:
    returns (sources [N], touches [N, K, 2], valid [N, K]) with touch rows
    padded to ``k`` per wave (a wave with more than ``k`` touches must be
    split by the caller)."""
    n = len(waves)
    sources = np.zeros(n, dtype=np.int32)
    touches = np.zeros((n, k, 2), dtype=np.int32)
    valid = np.zeros((n, k), dtype=bool)
    for i, (source, rows) in enumerate(waves):
        if len(rows) > k:
            raise ValueError(f"wave {i} exceeds K={k} touches")
        if len(set(rows)) != len(rows):
            # The kernel reads all old words before writing (vectorized), so
            # duplicate rows would double-count; the ledger never emits them
            # (one ack per (req_no, digest) per wave).
            raise ValueError(f"wave {i} has duplicate touch rows")
        sources[i] = source
        for j, (w, d) in enumerate(rows):
            touches[i, j, 0] = w
            touches[i, j, 1] = d
            valid[i, j] = True
    return sources, touches, valid


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernel: the gate and the scan.
# ---------------------------------------------------------------------------


def _as_i32(bit: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    return bit - (1 << 32) if bit >= 1 << 31 else bit


def _read_index(idx, size: int):
    """JAX gather indices: negative ones from the end, then clamped."""
    import torch

    return torch.where(idx < 0, idx + size, idx).clamp(0, max(size - 1, 0))


def _write_index(idx, size: int):
    """JAX scatter indices: negative ones from the end; (index, in range)."""
    import torch

    idx = torch.where(idx < 0, idx + size, idx)
    return idx, (idx >= 0) & (idx < size)


def gate_torch(valid, prev_words, digests, digest_rows, claimed, row_groups, touch_groups):
    """The fused wave's digest gate (the JAX ``_fused_body``'s): a touch
    with ``digest_rows >= 0`` stays valid only if row ``digest_rows`` of
    [prev_words; digests] (clamped to the table) equals its ``claimed``
    words and that row's group equals the touch's.  ``prev_words`` [P, 8],
    ``digests`` [B, 8], ``claimed`` [N, K, 8] int32 words; ``digest_rows``,
    ``touch_groups`` [N, K] and ``row_groups`` [P + B] int32.  With no rows
    at all (P + B = 0) a gated touch fails closed."""
    import torch

    combined = torch.cat([prev_words, digests], dim=0)
    gate = digest_rows >= 0
    if combined.shape[0] == 0:
        return valid & ~gate
    rows = digest_rows.to(torch.int64).clamp(0, combined.shape[0] - 1)
    eq = (combined[rows] == claimed).all(dim=-1)
    grp_ok = row_groups[rows] == touch_groups
    return valid & (~gate | (eq & grp_ok))


def accumulate_torch(masks, counts, sources, touches, valid):
    """Plain PyTorch version of the JAX scan (``quorum._kernel``): masks
    [W, D, 8] and counts [W, D] int32, sources [N], touches [N, K, 2] int32,
    valid [N, K] bool -> new (masks, counts), posts [N, K] int32 and newbits
    [N, K] bool.  The inputs are left as they were.

    Per wave, every touch first reads its old word (indices from the end,
    then clamped); a valid touch whose bit was clear is new.  Then each new
    touch ORs the bit into its word and adds one to its count, where those
    indices are in range (out of range: dropped), and last every touch reads
    its count (clamped) as its post."""
    import torch

    masks = masks.clone()
    counts = counts.clone()
    w_size, d_size, words = masks.shape
    n, k = valid.shape
    posts = torch.zeros((n, k), dtype=torch.int32, device=masks.device)
    newbits = torch.zeros((n, k), dtype=torch.bool, device=masks.device)
    for i in range(n):
        source = int(sources[i])
        word = source // 32  # floor division and modulo, as jnp's
        bit = _as_i32(1 << (source % 32))
        w, d = touches[i, :, 0].to(torch.int64), touches[i, :, 1].to(torch.int64)
        wr, dr = _read_index(w, w_size), _read_index(d, d_size)
        word_r = min(max(word + words if word < 0 else word, 0), words - 1)
        old = masks[wr, dr, word_r]
        new = valid[i] & ((old & bit) == 0)
        (ww, w_in), (dw, d_in) = _write_index(w, w_size), _write_index(d, d_size)
        word_w = word + words if word < 0 else word
        count_at = new & w_in & d_in
        if 0 <= word_w < words:
            # Every new touch of one word writes the same value, old | bit.
            masks[ww[count_at], dw[count_at], word_w] = old[count_at] | bit
        counts.index_put_(
            (ww[count_at], dw[count_at]),
            torch.ones(int(count_at.sum()), dtype=counts.dtype, device=counts.device),
            accumulate=True,
        )
        posts[i] = counts[wr, dr]
        newbits[i] = new
    return masks, counts, posts, newbits


# ---------------------------------------------------------------------------
# The kernel's wrapper and the entry point on tensors.
# ---------------------------------------------------------------------------


def _check(masks, counts, sources, touches, valid, gate):
    import torch

    if masks.dim() != 3 or masks.shape[2] != MASK_WORDS:
        raise ValueError(f"masks must be [W, D, {MASK_WORDS}], got {tuple(masks.shape)}")
    if tuple(counts.shape) != tuple(masks.shape[:2]):
        raise ValueError(f"counts must be [W, D], got {tuple(counts.shape)}")
    if masks.shape[0] == 0 or masks.shape[1] == 0:
        raise ValueError("masks must have at least one slot and one digest slot")
    n = sources.shape[0] if sources.dim() == 1 else -1
    k = valid.shape[1] if valid.dim() == 2 else -1
    prev_words, digests, digest_rows, claimed, row_groups, touch_groups = gate
    expect = (
        ("masks", masks, None, torch.int32),
        ("counts", counts, None, torch.int32),
        ("sources", sources, (n,), torch.int32),
        ("touches", touches, (n, k, 2), torch.int32),
        ("valid", valid, (n, k), torch.bool),
        ("prev_words", prev_words, (prev_words.shape[0], 8), torch.int32),
        ("digests", digests, (digests.shape[0], 8), torch.int32),
        ("digest_rows", digest_rows, (n, k), torch.int32),
        ("claimed", claimed, (n, k, 8), torch.int32),
        ("row_groups", row_groups, (prev_words.shape[0] + digests.shape[0],), torch.int32),
        ("touch_groups", touch_groups, (n, k), torch.int32),
    )
    for name, t, shape, dtype in expect:
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != masks.device:
            raise ValueError("every input must be on the masks' device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def open_gate(valid):
    """The six gate tensors of a stream with no gated touch, on ``valid``'s
    device: no rows, and every ``digest_rows`` -1 (the gate of
    ``device_accumulate``)."""
    import torch

    device = valid.device
    n, k = valid.shape
    empty = torch.zeros((0, 8), dtype=torch.int32, device=device)
    return (
        empty,
        empty,
        torch.full((n, k), -1, dtype=torch.int32, device=device),
        torch.zeros((n, k, 8), dtype=torch.int32, device=device),
        torch.zeros(0, dtype=torch.int32, device=device),
        torch.zeros((n, k), dtype=torch.int32, device=device),
    )


def quorum_accumulate_torch(masks, counts, sources, touches, valid, gate):
    """Plain PyTorch version of the whole kernel: ``gate_torch`` then
    ``accumulate_torch``; returns new (masks, counts, posts, newbits)."""
    return accumulate_torch(masks, counts, sources, touches, gate_torch(valid, *gate))


def quorum_accumulate(masks, counts, sources, touches, valid, gate):
    """One wave stream through the digest gate and the accumulate: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  ``gate``
    is (prev_words, digests, digest_rows, claimed, row_groups,
    touch_groups), see ``gate_torch`` (``open_gate`` for none).  Updates
    ``masks`` and ``counts`` in place and returns (posts [N, K] int32,
    newbits [N, K] bool).  Counts its launches in
    ``quorum_accumulate.launches``."""
    import torch

    _check(masks, counts, sources, touches, valid, gate)
    if masks.device.type == "cpu":
        new_masks, new_counts, posts, newbits = quorum_accumulate_torch(
            masks, counts, sources, touches, valid, gate
        )
        masks.copy_(new_masks)
        counts.copy_(new_counts)
        return posts, newbits
    if masks.device.type != "cuda":
        raise ValueError(f"unsupported device {masks.device}")
    from . import _build

    n, k = valid.shape
    posts = torch.empty((n, k), dtype=torch.int32, device=masks.device)
    newbits = torch.empty((n, k), dtype=torch.bool, device=masks.device)
    if n == 0 or k == 0:
        return posts, newbits  # nothing to launch
    prev_words, digests, digest_rows, claimed, row_groups, touch_groups = gate
    lib = _build.library("quorum")
    code = lib.mirbft_quorum_accumulate(
        masks.data_ptr(),
        counts.data_ptr(),
        masks.shape[0],
        masks.shape[1],
        sources.data_ptr(),
        touches.data_ptr(),
        valid.data_ptr(),
        n,
        k,
        prev_words.data_ptr(),
        prev_words.shape[0],
        digests.data_ptr(),
        digests.shape[0],
        digest_rows.data_ptr(),
        claimed.data_ptr(),
        row_groups.data_ptr(),
        touch_groups.data_ptr(),
        posts.data_ptr(),
        newbits.data_ptr(),
        torch.cuda.current_stream(masks.device).cuda_stream,
    )
    _build.check(lib, code, "quorum_accumulate")
    _counted.launches += 1
    return posts, newbits


quorum_accumulate.launches = 0
# The count stays on this function when an observer rebinds the module's
# name to a wrapper of it (callers go through ``quorum.quorum_accumulate``).
_counted = quorum_accumulate

PLAN_FIELDS = ("capacity", "chunk_waves", "chunks", "rows", "slots", "map_rows", "smem_bytes",
               "threads")


def launch_plan(w: int, d: int, n: int, k: int) -> dict:
    """How the CUDA kernel runs a stream of N waves of K touches on [W, D]
    state (``csrc/quorum.cu``'s ``plan_of``): the table's capacity in
    touches, the whole waves a chunk, the chunks, the largest chunk's
    touches, the hash slots, the rows of the direct map (0: the hash table
    finds the entries), the dynamic shared memory in bytes and the block
    size; ``chunk_waves`` 0 is the global branch.  Builds the kernel's
    library (a card's machine only)."""
    import ctypes

    from . import _build

    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    _build.library("quorum").mirbft_quorum_plan(w, d, n, k, 0, out)
    return dict(zip(PLAN_FIELDS, out))


def quorum_state_to_torch(masks: np.ndarray, counts: np.ndarray, device="cuda"):
    """numpy quorum state (masks [W, D, 8] uint32, counts [W, D] int32, as
    the JAX package keeps it on the host) -> int32 tensors with the same
    bits on ``device``."""
    import torch

    def one(arr, dtype):
        arr = np.ascontiguousarray(arr, dtype=dtype).view(np.int32)
        return torch.from_numpy(arr.copy()).to(device)

    return one(masks, np.uint32), one(counts, np.int32)


def device_accumulate(masks, counts, sources, touches, valid):
    """One launch over a wave stream on tensors: masks and counts (see
    ``quorum_state_to_torch``) stay on their device and are updated in
    place; sources, touches and valid (numpy or tensors) go there too.
    Returns (masks, counts, posts, newbits).

    Precondition (enforced by pack_wave_stream): no duplicate (slot,
    digest) rows within one wave — the ledger never emits them, and the
    read-all-then-write update counts them twice, as the JAX program does.
    """
    import torch

    def on_device(arr, dtype):
        if isinstance(arr, torch.Tensor):
            return arr.to(device=masks.device, dtype=dtype).contiguous()
        return torch.from_numpy(np.ascontiguousarray(arr)).to(masks.device, dtype)

    sources = on_device(sources, torch.int32)
    touches = on_device(touches, torch.int32)
    valid = on_device(valid, torch.bool)
    posts, newbits = quorum_accumulate(
        masks, counts, sources, touches, valid, open_gate(valid)
    )
    return masks, counts, posts, newbits


def host_accumulate(masks, counts, sources, touches, valid):
    """Numpy reference (also the honest host-side A/B contender)."""
    masks = masks.copy()
    counts = counts.copy()
    n, k, _ = touches.shape
    posts = np.zeros((n, k), dtype=np.int32)
    newbits = np.zeros((n, k), dtype=bool)
    for i in range(n):
        word = sources[i] // 32
        bit = np.uint32(1 << (sources[i] % 32))
        for j in range(k):
            if not valid[i, j]:
                posts[i, j] = counts[touches[i, j, 0], touches[i, j, 1]]
                continue
            w, d = touches[i, j]
            if not masks[w, d, word] & bit:
                masks[w, d, word] |= bit
                counts[w, d] += 1
                newbits[i, j] = True
            posts[i, j] = counts[w, d]
    return masks, counts, posts, newbits


def crossings(posts: np.ndarray, wq: int, sq: int) -> np.ndarray:
    """Candidate map: touches whose post-count sits at a quorum edge
    (the ±1 band covers the ledger's own-ack adjustment)."""
    return (
        (posts == wq - 1) | (posts == wq) | (posts == sq - 1) | (posts == sq)
    )
