"""Device-mesh sharding of the batched crypto kernels.

The JAX package's mesh (``mirbft_tpu/parallel/mesh.py:42``) is
single-controller: one process drives every device through ``jax.devices()``,
a ``Mesh`` and ``shard_map``, and every caller (the hash and auth planes,
``FastRecording``, the dry run) lives in that one process.  The port keeps
that shape: a ``Mesh`` is a tuple of ``torch.device``s that one process
drives, not a ``torch.distributed`` process group, which would need a
process per device and change the planes' API.

The crypto batch is pure data parallelism — each row (message or signature)
is independent — so the batch dimension splits into equal shards, one a
device, and each shard runs on its device's current stream: the SHA-256 or
Ed25519 kernel, then, in the two verify steps, the count kernel
(``csrc/mesh.cu``, ``shard_count``) over the shard's digests or verdicts.
The reference's ``psum`` of those counts becomes ``all_reduce_counts``:
each shard's one-word count is copied to every device and summed there, so
every device holds the global count (with one card, a copy).  Outputs come
back on the mesh's first device.  No NCCL: the exchange is one word a
shard, and one card could not exercise it.

``make_mesh(device="cpu")`` builds a mesh of ``n`` shards on the CPU, the
counterpart of the virtual CPU devices the JAX package's tests use: every
shard then runs the kernels' plain PyTorch versions.  The caller asks for
it; a CPU mesh never stands in for a missing card.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np

BATCH_AXIS = "batch"


class Mesh:
    """A 1-D mesh: the devices the batch axis shards over, in order."""

    axis_names = (BATCH_AXIS,)

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devices}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must be of one kind, got {sorted(kinds)}")
        self.devices = tuple(devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"Mesh({list(map(str, self.devices))}, axis={BATCH_AXIS!r})"


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` local devices of ``device``'s
    kind (every card when None); the crypto batch shards across it.

    ``device="cpu"``: ``n_devices`` shards on the CPU (one when None)."""
    import torch

    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    elif kind == "cpu":
        devices = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"unsupported device {device!r}")
    if n_devices is not None and len(devices) < n_devices:
        raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
    if not devices:
        raise ValueError(f"requested a {kind} mesh, no {kind} device available")
    return Mesh(devices[:n_devices])


# ---------------------------------------------------------------------------
# The count kernel's wrapper and its plain version.
# ---------------------------------------------------------------------------

_MODES = {"digests": 0, "verdicts": 1}


def _check_count(mode, a, b, c):
    import torch

    if mode not in _MODES:
        raise ValueError(f"unknown count mode {mode!r}")
    if mode == "digests":
        tensors, dtype, width = (("words", a), ("expected", b)), torch.int32, 8
        if a.dim() != 2 or a.shape[1] != width:
            raise ValueError(f"words must be [b, 8], got {tuple(a.shape)}")
    else:
        tensors, dtype, width = (("ok", a), ("valid", b), ("real", c)), torch.bool, None
        if a.dim() != 1:
            raise ValueError(f"ok must be [b], got {tuple(a.shape)}")
    for name, t in tensors:
        if t is None:
            raise ValueError(f"{mode} mode needs {name}")
        if tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"{name} must be {tuple(a.shape)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != a.device:
            raise ValueError("a shard's tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def shard_count_torch(mode: str, a, b, c=None):
    """The plain version of the count kernel on one shard, a 0-d int32.

    ``"digests"``: ``a`` [b, 8] digest words and ``b`` [b, 8] expected words
    (int32 bits of uint32); counts the rows that differ in any word.
    ``"verdicts"``: ``a`` [b] verdicts, ``b`` [b] structural validity and
    ``c`` [b] real-row mask (bool); writes ``a & b`` into ``a`` and counts
    the real rows that are not ok."""
    import torch

    if mode == "digests":
        return (a != b).any(dim=-1).sum(dtype=torch.int32)
    a &= b
    return (c & ~a).sum(dtype=torch.int32)


def shard_count(mode: str, a, b, c=None):
    """Count one shard's mismatched digests or rejected real rows (see
    ``shard_count_torch``): the CUDA kernel (``csrc/mesh.cu``,
    ``mesh_count_kernel``) for CUDA tensors, the plain version for CPU
    tensors.  Returns a 0-d int32 on the shard's device and counts kernel
    launches in ``shard_count.launches``."""
    import torch

    _check_count(mode, a, b, c)
    if a.device.type == "cpu":
        return shard_count_torch(mode, a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from ..ops import _build

    if mode == "digests":
        if a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError("digest words must be 16-byte aligned (the kernel reads uint4)")
        pointers = (a.data_ptr(), b.data_ptr(), None, None, None)
    else:
        pointers = (None, None, a.data_ptr(), b.data_ptr(), c.data_ptr())
    count = torch.empty((), dtype=torch.int32, device=a.device)
    lib = _build.library("mesh")
    code = lib.mirbft_mesh_count(
        _MODES[mode], *pointers, a.shape[0], count.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(lib, code, "mesh_count")
    shard_count.launches += 1
    return count


shard_count.launches = 0


def all_reduce_counts(mesh: Mesh, counts) -> List:
    """The ``psum`` of the shards' counts: each count (a 0-d tensor on its
    shard's device) copied to every device of the mesh and summed there.
    Returns the total on each device, in the mesh's order."""
    totals = []
    for device in mesh.devices:
        total = counts[0].to(device, copy=True)
        for count in counts[1:]:
            total += count.to(device)
        totals.append(total)
    return totals


# ---------------------------------------------------------------------------
# Sharding.
# ---------------------------------------------------------------------------


def _tensor(x, dtype):
    """``x`` (a numpy array or a tensor) as a contiguous tensor of
    ``dtype``; numpy words cross as ``words_to_torch`` makes them."""
    import torch

    from ..ops.sha256 import words_to_torch

    if isinstance(x, torch.Tensor):
        if x.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {x.dtype}")
        return x.contiguous()
    if dtype == torch.bool:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=bool))
    return words_to_torch(x, "cpu")


def _split(mesh: Mesh, tensors):
    """Per device, its shard of each tensor (equal slices of the batch
    axis), on that device."""
    batch = tensors[0].shape[0]
    for t in tensors:
        if t.shape[0] != batch:
            raise ValueError("every input must have the same batch dimension")
    if batch % mesh.size:
        raise ValueError(
            f"batch of {batch} rows does not divide over a mesh of {mesh.size} devices"
        )
    per = batch // mesh.size
    return [
        [t[i * per : (i + 1) * per].to(device) for t in tensors]
        for i, device in enumerate(mesh.devices)
    ]


def _on(device):
    import torch

    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _gather(mesh: Mesh, parts):
    """The shards' outputs, in order, on the mesh's first device."""
    import torch

    if len(parts) == 1:
        return parts[0]
    first = mesh.devices[0]
    return torch.cat([p.to(first) for p in parts])


def sharded_sha256(mesh: Mesh):
    """Batched SHA-256 with the batch dimension sharded over the mesh.
    Inputs [B, L, 16] / [B] uint32 words (numpy, or int32 tensors); B must
    divide by the mesh size.  Returns [B, 8] int32 digest words on the
    mesh's first device."""
    import torch

    from ..ops.sha256_pallas import sha256_batch

    def fn(blocks, n_blocks):
        shards = _split(mesh, [_tensor(blocks, torch.int32), _tensor(n_blocks, torch.int32)])
        parts = []
        for device, (b, n) in zip(mesh.devices, shards):
            with _on(device):
                parts.append(sha256_batch(b, n))
        return _gather(mesh, parts)

    return fn


def distributed_verify_step(mesh: Mesh):
    """The full distributed crypto step: hash every (padded) message
    shard-locally, count the rows whose digest differs from its expected
    words (the count kernel), and all-reduce the counts so every device
    holds the global verdict.

    This is the multi-device shape of the epoch-change / forwarded-batch
    verification flow (``VerifyBatchOrigin``): digests stay on the device;
    only the one-word verdict is exchanged.  Returns (digests [B, 8] int32,
    mismatches 0-d int32), both on the mesh's first device."""
    import torch

    from ..ops.sha256_pallas import sha256_batch

    def step(blocks, n_blocks, expected_words):
        shards = _split(mesh, [
            _tensor(blocks, torch.int32),
            _tensor(n_blocks, torch.int32),
            _tensor(expected_words, torch.int32),
        ])
        parts, counts = [], []
        for device, (b, n, expected) in zip(mesh.devices, shards):
            with _on(device):
                words = sha256_batch(b, n)
                counts.append(shard_count("digests", words, expected))
            parts.append(words)
        return _gather(mesh, parts), all_reduce_counts(mesh, counts)[0]

    return step


def sharded_ed25519_verify(mesh: Mesh, kernel: str = "vpu"):
    """Batched Ed25519 verification with the batch dimension sharded over
    the mesh, plus the byzantine-signer count: every shard verifies its rows
    (the verify kernel), ANDs the verdicts with ``valid`` and counts its
    real rows that are not ok (the count kernel), and the all-reduce gives
    every device the global count of invalid signatures among the REAL rows.

    Inputs: the packed arrays of ``Ed25519BatchVerifier.pack_inputs`` plus
    ``real``, a [B] bool mask of rows that carry actual signatures (padding
    rows are False and are not counted; a real row whose signature is
    structurally invalid — ``valid`` False — counts as invalid).  The mesh
    size must divide the batch.  ``kernel`` picks the field multiply: "vpu"
    (the default) or "mxu", which has no CUDA kernel yet and runs on a CPU
    mesh only.  Returns (ok [B] bool, invalid 0-d int32), both on the mesh's
    first device."""
    import torch

    from ..ops.ed25519 import MXU_NOT_PORTED, ed25519_verify_kernel

    if kernel not in ("mxu", "vpu"):
        raise ValueError(f"unknown ed25519 kernel backend {kernel!r}")
    if kernel == "mxu" and mesh.device_type == "cuda":
        raise NotImplementedError(MXU_NOT_PORTED)

    def step(ax, ay, r_bytes, s_bits, h_bits, valid, real):
        shards = _split(mesh, [
            *(_tensor(a, torch.int32) for a in (ax, ay, r_bytes, s_bits, h_bits)),
            _tensor(valid, torch.bool),
            _tensor(real, torch.bool),
        ])
        parts, counts = [], []
        for device, shard in zip(mesh.devices, shards):
            with _on(device):
                ok = ed25519_verify_kernel(*shard[:5], backend=kernel)
                counts.append(shard_count("verdicts", ok, shard[5], shard[6]))
            parts.append(ok)
        return _gather(mesh, parts), all_reduce_counts(mesh, counts)[0]

    return step
