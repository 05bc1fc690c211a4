"""Crypto kernels on the card and their CPU references.

Batched SHA-256 digesting (batch digests, batch verification, epoch-change
hashing) as hand-written CUDA kernels over fixed-shape uint32 arrays with
length bucketing; each kernel keeps a plain PyTorch twin that CPU tensors
take.  ``CpuHasher`` is the hashlib reference used for equality testing and
small runs.
"""

from .cpu import CpuHasher

__all__ = ["CpuHasher", "TorchHasher"]


def __getattr__(name):
    # Lazy: importing the torch-backed modules pulls in torch, which small
    # host-only embedders should not pay for.
    if name == "TorchHasher":
        from .sha256 import TorchHasher

        return TorchHasher
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
