"""Batch-major batched SHA-256: the wave kernel below the crossover.

Port of the JAX package's batch-major Pallas kernel
(ops/sha256_pallas.py:58, ``_sha256_tile_kernel``) with its
``[B, L, 16] -> [B, 8]`` contract.  On the card this one kernel serves both
``kernel="pallas"`` and ``kernel="scan"``: the JAX package's scan program
is plain JAX with the same contract, and nothing plain runs on the wave
path when a card is present.

``sha256_batch`` is the wrapper of the CUDA kernel (``csrc/sha256.cu``,
``sha256_batch_kernel``: what bounds it and what its design does about that
are noted there).  Its plain PyTorch version is
``sha256.sha256_batch_torch``, which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations


def _check(blocks, n_blocks):
    import torch

    if blocks.dim() != 3 or blocks.shape[2] != 16:
        raise ValueError(f"blocks must be [B, L, 16], got {tuple(blocks.shape)}")
    if tuple(n_blocks.shape) != (blocks.shape[0],):
        raise ValueError(f"n_blocks must be [B], got {tuple(n_blocks.shape)}")
    for name, t in (("blocks", blocks), ("n_blocks", n_blocks)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (uint32 bits), got {t.dtype}")
        if t.device != blocks.device:
            raise ValueError("blocks and n_blocks must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sha256_batch(blocks, n_blocks):
    """Digest a batch-major wave: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Counts its launches in
    ``sha256_batch.launches``."""
    import torch

    _check(blocks, n_blocks)
    if blocks.device.type == "cpu":
        from .sha256 import sha256_batch_torch

        return sha256_batch_torch(blocks, n_blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned (the kernel reads uint4)")
    from . import _build

    rows, bucket = blocks.shape[0], blocks.shape[1]
    out = torch.empty((rows, 8), dtype=torch.int32, device=blocks.device)
    if rows == 0:
        return out  # nothing to launch
    lib = _build.library("sha256")
    code = lib.mirbft_sha256_batch(
        blocks.data_ptr(),
        n_blocks.data_ptr(),
        out.data_ptr(),
        rows,
        bucket,
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    _build.check(lib, code, "sha256_batch")
    sha256_batch.launches += 1
    return out


sha256_batch.launches = 0
