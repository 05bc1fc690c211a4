"""Device-mesh sharding of the crypto workload.

Consensus messages are small and point-to-point (they ride the ``Link``
abstraction); what scales with replica count and load is the crypto batch —
digests and signature verifications.  This package shards that batch
dimension over a mesh of devices driven by one controller process, so one
hash/verify dispatch spans every local card, and the verify steps reduce
their per-shard verdict counts (``csrc/mesh.cu``) to one global count held
on every device.
"""

from .mesh import (
    BATCH_AXIS,
    Mesh,
    all_reduce_counts,
    distributed_verify_step,
    make_mesh,
    shard_count,
    shard_count_torch,
    sharded_ed25519_verify,
    sharded_sha256,
)

__all__ = [
    "BATCH_AXIS",
    "Mesh",
    "all_reduce_counts",
    "distributed_verify_step",
    "make_mesh",
    "shard_count",
    "shard_count_torch",
    "sharded_ed25519_verify",
    "sharded_sha256",
]
