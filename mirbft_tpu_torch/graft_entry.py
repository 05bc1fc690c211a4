"""Entry points of the port: a one-device kernel check and a mesh dry run.

The counterparts of the JAX package's ``__graft_entry__.py``.  ``entry()``
returns the flagship compute step — the batched SHA-256 kernel that backs
every ``ActionHashRequest`` in the framework — with example arguments shaped
like a realistic dispatch (a 20-request batch's digest list per row), as
tensors on ``device``.

``dryrun_multichip(n)`` builds an n-device mesh and runs the FULL
distributed crypto step on tiny shapes: shard-local batched hashing, the
all-reduced verification count, the sharded Ed25519 byzantine count, and a
signed consensus run whose crypto waves cross the mesh.  On the card the
mesh is ``n`` cards (``torch.cuda.device_count()``); ``device="cpu"`` runs
``n`` CPU shards on the kernels' plain PyTorch versions.

    python -m mirbft_tpu_torch.graft_entry          # entry() on the card
    python -c "from mirbft_tpu_torch.graft_entry import dryrun_multichip; \\
        dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import hashlib

import numpy as np


def entry(device: str = "cuda"):
    """Returns (fn, example_args) for a one-device kernel check: the
    batch-major SHA-256 kernel's wrapper and a wave of 256 messages of 640
    bytes ([256, 16, 16] blocks) on ``device``."""
    from .ops.sha256 import pad_message, wave_to_torch
    from .ops.sha256_pallas import sha256_batch

    batch, max_blocks = 256, 16
    blocks = np.zeros((batch, max_blocks, 16), dtype=np.uint32)
    n_blocks = np.zeros(batch, dtype=np.uint32)
    rng = np.random.default_rng(0)
    for i in range(batch):
        message = rng.integers(0, 256, size=640, dtype=np.uint8).tobytes()
        padded = pad_message(message)
        blocks[i, : padded.shape[0]] = padded
        n_blocks[i] = padded.shape[0]
    return sha256_batch, wave_to_torch(blocks, n_blocks, device)


def _words(tensor) -> np.ndarray:
    return tensor.cpu().numpy().view(np.uint32)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the distributed verify step and a signed consensus run on an
    ``n_devices`` mesh of ``device``'s kind; raises AssertionError on any
    wrong result.  Returns the mesh counters of the consensus run."""
    from .ops.sha256 import digests_from_words, pad_message
    from .parallel import (
        distributed_verify_step,
        make_mesh,
        sharded_ed25519_verify,
        sharded_sha256,
    )

    mesh = make_mesh(n_devices, device=device)

    # Tiny shapes: one 1-block message per device row, batch = 2 * devices.
    batch, max_blocks = 2 * n_devices, 2
    blocks = np.zeros((batch, max_blocks, 16), dtype=np.uint32)
    n_blocks = np.zeros(batch, dtype=np.uint32)
    messages = [b"msg-%d" % i for i in range(batch)]
    for i, message in enumerate(messages):
        padded = pad_message(message)
        blocks[i, : padded.shape[0]] = padded
        n_blocks[i] = padded.shape[0]

    # 1. Sharded hashing: digests computed with the batch dim split over the
    #    mesh must match hashlib exactly.
    words = _words(sharded_sha256(mesh)(blocks, n_blocks))
    for message, digest in zip(messages, digests_from_words(words)):
        assert digest == hashlib.sha256(message).digest(), "sharded digest mismatch"

    # 2. Full distributed verify step (shard-local hash + all-reduced count).
    verify_fn = distributed_verify_step(mesh)
    _, mismatches = verify_fn(blocks, n_blocks, words)
    assert int(mismatches) == 0, "verify step reported mismatches on good data"

    corrupted = words.copy()
    corrupted[0] ^= 1
    _, mismatches = verify_fn(blocks, n_blocks, corrupted)
    assert int(mismatches) == 1, "verify step missed a corrupted digest"

    # 3. Sharded Ed25519 verification with the byzantine-signer count: one
    #    signature row per device, one of them corrupt; every device holds
    #    the global invalid count.
    from .ops.ed25519 import Ed25519BatchVerifier, keypair_from_seed

    pubs, sig_msgs, sigs = [], [], []
    for i in range(n_devices):
        pub, sign = keypair_from_seed((i + 1).to_bytes(4, "big") * 8)
        m = b"graft-%d" % i
        sig = sign(m)
        if i == 0:
            sig = sig[:40] + bytes([sig[40] ^ 0xFF]) + sig[41:]  # byzantine
        pubs.append(pub)
        sig_msgs.append(m)
        sigs.append(sig)
    packed = Ed25519BatchVerifier(min_device_batch=1, device=device).pack_inputs(
        pubs, sig_msgs, sigs, batch=n_devices
    )
    real = np.arange(n_devices) < len(sigs)
    ok, invalid = sharded_ed25519_verify(mesh)(*packed, real)
    ok = ok.cpu().numpy()
    assert int(invalid) == 1, "byzantine count wrong"
    assert not ok[0] and ok[1:].all(), "per-shard verdicts wrong"

    # 4. The PLANE path: a small signed consensus run whose auth-plane
    #    verify waves AND hash-plane hash waves execute on the mesh (batch
    #    sharded; verify adds the all-reduced count) — engine traffic
    #    transits the mesh, not just bare kernels.  Must be step- and
    #    state-identical to the single-device run, byzantine signer
    #    rejected either way.
    from . import metrics
    from .testengine import CryptoConfig, Spec

    def consensus_run(mesh_devices):
        metrics.default_registry.reset()
        spec = Spec(
            node_count=4,
            client_count=2,
            reqs_per_client=5,
            batch_size=2,
            signed_requests=True,
            crypto=CryptoConfig(
                device=True,
                # Tiny hash waves so this small run launches device hash
                # dispatches (and with mesh_devices set, mesh ones).
                hash_wave=4,
                hash_floor=1,
                # A verify wave launches at the floor of 2 rows: on one
                # device, waves of 2 rather than the mesh size.
                auth_wave=max(n_devices, 2),
                auth_floor=2,
                mesh_devices=mesh_devices,
                torch_device=device,
            ),
            tweak_recorder=lambda r: setattr(r.client_configs[1], "corrupt", True),
        )
        rec = spec.recorder().recording()
        steps = rec.drain_clients(timeout=10_000_000)
        state = [
            (n.state.checkpoint_seq_no, dict(n.state.committed_reqs))
            for n in rec.nodes
        ]
        return steps, state, metrics.snapshot()

    steps_one, state_one, _ = consensus_run(0)
    steps_mesh, state_mesh, snap = consensus_run(n_devices)
    assert steps_mesh == steps_one, "mesh plane changed the schedule"
    assert state_mesh == state_one, "mesh plane verdicts diverged"
    assert snap.get("mesh_verify_dispatches", 0) > 0, (
        "consensus verify waves never transited the mesh"
    )
    assert snap.get("mesh_hash_dispatches", 0) >= 1, (
        "consensus hash waves never transited the mesh"
    )
    for _, committed in state_mesh:
        assert committed.get(1, 0) == 0, "byzantine signer committed"

    print(
        f"dryrun_multichip OK: {n_devices} {mesh.device_type} devices, batch={batch}, "
        "digests verified, all-reduced count correct, sharded ed25519 verify "
        "rejected the byzantine signer, and a signed consensus run drove "
        f"{snap.get('mesh_verify_dispatches')} auth-plane verify waves and "
        f"{snap.get('mesh_hash_dispatches')} hash-plane waves through the "
        "mesh with single-device-identical state"
    )
    return {
        key: snap.get(key, 0)
        for key in (
            "mesh_hash_dispatches",
            "mesh_hashed_messages",
            "mesh_verify_dispatches",
            "mesh_verified_signatures",
        )
    }


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry() kernel check OK:", tuple(out.shape), out.dtype)
