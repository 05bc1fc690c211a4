"""Lanes-major batched SHA-256: the wave kernel at and past the crossover.

Port of the JAX package's lanes-major Pallas kernel
(ops/sha256_pallas_lanes.py:37, ``_kernel``).  The host packs a wave as
``[tiles, L, 16, 8, 128]`` so that word ``t`` of block ``b`` is contiguous
over a tile's 1024 messages; ``n_blocks`` is ``[tiles, 1, 8, 128]`` and the
digest words come back as ``[tiles, 8, 8, 128]``.  The layout is kept as
it is: on the card, one thread per message reads that word for 32
neighbouring messages in one coalesced transaction.

``sha256_lanes`` is the wrapper of the CUDA kernel (``csrc/sha256.cu``,
``sha256_lanes_kernel``: what bounds it and what its design does about that
are noted there).  ``sha256_lanes_torch`` is its plain PyTorch version,
which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import numpy as np

SUB, LANES = 8, 128
TILE = SUB * LANES  # messages per tile


def pack_lanes_major(blocks, n_blocks):
    """HOST-side lanes-major packing shared by the adapter, the bench, and
    tests: [B, L, 16] batch-major -> ([tiles, L, 16, 8, 128],
    [tiles, 1, 8, 128]) with B padded to a TILE multiple."""
    blocks = np.asarray(blocks)
    n_blocks = np.asarray(n_blocks)
    batch, bucket = blocks.shape[0], blocks.shape[1]
    padded = ((batch + TILE - 1) // TILE) * TILE
    if padded != batch:
        blocks = np.pad(blocks, ((0, padded - batch), (0, 0), (0, 0)))
        n_blocks = np.pad(n_blocks, (0, padded - batch))
    tiles = padded // TILE
    lanes = np.ascontiguousarray(
        blocks.reshape(tiles, SUB, LANES, bucket, 16)
        .transpose(0, 3, 4, 1, 2)
    )
    nb = n_blocks.astype(np.uint32).reshape(tiles, 1, SUB, LANES)
    return lanes, nb


def sha256_lanes_torch(blocks, n_blocks):
    """Plain PyTorch version of the lanes kernel: blocks
    [tiles, L, 16, 8, 128] int32 (uint32 bits), n_blocks [tiles, 1, 8, 128]
    -> [tiles, 8, 8, 128] int32 digest words."""
    from .sha256 import narrow_u32, sha256_words_torch, widen_u32

    tiles, bucket = blocks.shape[0], blocks.shape[1]
    words = widen_u32(blocks).permute(1, 2, 0, 3, 4).reshape(bucket, 16, tiles * TILE)
    state = sha256_words_torch(words, widen_u32(n_blocks.reshape(-1)))
    return narrow_u32(state.reshape(8, tiles, SUB, LANES).permute(1, 0, 2, 3).contiguous())


def _check(blocks, n_blocks):
    import torch

    if blocks.dim() != 5 or tuple(blocks.shape[2:]) != (16, SUB, LANES):
        raise ValueError(f"blocks must be [tiles, L, 16, 8, 128], got {tuple(blocks.shape)}")
    if tuple(n_blocks.shape) != (blocks.shape[0], 1, SUB, LANES):
        raise ValueError(
            f"n_blocks must be [tiles, 1, 8, 128], got {tuple(n_blocks.shape)}"
        )
    for name, t in (("blocks", blocks), ("n_blocks", n_blocks)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (uint32 bits), got {t.dtype}")
        if t.device != blocks.device:
            raise ValueError("blocks and n_blocks must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sha256_lanes(blocks, n_blocks):
    """Digest a lanes-major wave: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Counts its launches in
    ``sha256_lanes.launches``."""
    import torch

    _check(blocks, n_blocks)
    if blocks.device.type == "cpu":
        return sha256_lanes_torch(blocks, n_blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    from . import _build

    tiles, bucket = blocks.shape[0], blocks.shape[1]
    out = torch.empty((tiles, 8, SUB, LANES), dtype=torch.int32, device=blocks.device)
    if tiles == 0:
        return out  # nothing to launch
    lib = _build.library("sha256")
    code = lib.mirbft_sha256_lanes(
        blocks.data_ptr(),
        n_blocks.data_ptr(),
        out.data_ptr(),
        tiles,
        bucket,
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    _build.check(lib, code, "sha256_lanes")
    sha256_lanes.launches += 1
    return out


sha256_lanes.launches = 0
