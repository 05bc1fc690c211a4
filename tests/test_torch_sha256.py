"""SHA-256 in the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX reference and the port:
the port's plain twins (``sha256_batch_torch``, ``sha256_lanes_torch``)
against the JAX scan program ``sha256_batch_kernel`` (the Pallas kernels'
own parity tests run only on a TPU, so the scan program is their plain
reference here) and against hashlib; the port's packer against the
reference packer, byte for byte in both layouts; ``TorchHasher`` on the CPU
against ``TpuHasher(kernel="scan")``.  Digests are integers: every
comparison is exact equality.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from mirbft_tpu.ops import sha256 as ref
from mirbft_tpu.ops.sha256 import TpuHasher, sha256_batch_kernel
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.ops import sha256 as port
from mirbft_tpu_torch.ops.sha256 import (
    TorchHasher,
    digests_from_words,
    pack_messages,
    pad_message,
    sha256_batch_torch,
    wave_to_torch,
)
from mirbft_tpu_torch.ops.sha256_pallas import sha256_batch
from mirbft_tpu_torch.ops.sha256_pallas_lanes import (
    TILE,
    pack_lanes_major,
    sha256_lanes,
    sha256_lanes_torch,
)

BOUNDARY_LENGTHS = [0, 3, 55, 56, 64, 119, 120, 1000]


@pytest.fixture(autouse=True)
def _reset_port_observability():
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


def ref_digest(parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.digest()


def _words(t):
    return t.numpy().view(np.uint32)


def _batch_of(messages, extra_blocks=0):
    padded = [pad_message(m) for m in messages]
    L = max(p.shape[0] for p in padded) + extra_blocks
    blocks = np.zeros((len(messages), L, 16), dtype=np.uint32)
    n_blocks = np.zeros(len(messages), dtype=np.uint32)
    for i, p in enumerate(padded):
        blocks[i, : p.shape[0]] = p
        n_blocks[i] = p.shape[0]
    return blocks, n_blocks


@pytest.fixture(scope="module")
def boundary():
    """One batch of every boundary length through both packages (one JAX
    compile for the whole module)."""
    messages = [b"a" * n if n != 3 else b"abc" for n in BOUNDARY_LENGTHS]
    blocks, n_blocks = _batch_of(messages)
    jax_words = np.asarray(sha256_batch_kernel(blocks, n_blocks))
    port_words = _words(sha256_batch_torch(*wave_to_torch(blocks, n_blocks, "cpu")))
    return messages, jax_words, port_words


@pytest.mark.parametrize("row", range(len(BOUNDARY_LENGTHS)),
                         ids=[f"len{n}" for n in BOUNDARY_LENGTHS])
def test_batch_twin_matches_jax_and_hashlib(boundary, row):
    messages, jax_words, port_words = boundary
    np.testing.assert_array_equal(port_words[row], jax_words[row])
    assert digests_from_words(port_words[row : row + 1])[0] == (
        hashlib.sha256(messages[row]).digest()
    )


def test_pad_message_matches_reference():
    for n in BOUNDARY_LENGTHS:
        np.testing.assert_array_equal(pad_message(b"q" * n), ref.pad_message(b"q" * n))


def test_twins_mask_padding_and_garbage_rows():
    """Blocks past n_blocks and rows with n_blocks == 0 must not affect the
    digests; zero-block rows keep H0, in the JAX program and both twins."""
    m1, m2 = b"hello", b"x" * 200
    blocks, _ = _batch_of([m1, m2], extra_blocks=2)  # deliberately oversized
    blocks = np.concatenate([blocks, np.zeros_like(blocks[:2])])
    blocks[1, 4:] = 0xDEADBEEF  # garbage past row 1's last block
    blocks[2] = 0xFFFFFFFF  # garbage row, n_blocks = 0
    n_blocks = np.array([1, 4, 0, 0], dtype=np.uint32)
    jax_words = np.asarray(sha256_batch_kernel(blocks, n_blocks))
    batch_words = _words(sha256_batch_torch(*wave_to_torch(blocks, n_blocks, "cpu")))
    np.testing.assert_array_equal(batch_words, jax_words)
    np.testing.assert_array_equal(batch_words[2], port._H0)
    np.testing.assert_array_equal(batch_words[3], port._H0)

    lanes_words = _words(
        sha256_lanes_torch(*wave_to_torch(*pack_lanes_major(blocks, n_blocks), "cpu"))
    )
    flat = lanes_words.transpose(0, 2, 3, 1).reshape(TILE, 8)
    np.testing.assert_array_equal(flat[:4], jax_words)
    np.testing.assert_array_equal(flat[4:], np.broadcast_to(port._H0, (TILE - 4, 8)))
    assert digests_from_words(flat[:2]) == [
        hashlib.sha256(m1).digest(),
        hashlib.sha256(m2).digest(),
    ]


def _random_messages(seed, count, max_len):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, size=count)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]


def test_ragged_lanes_wave_matches_jax_and_hashlib():
    """A ragged 37-message wave packed lanes-major by both packages: the
    lanes twin equals hashlib and the JAX scan program on the batch-major
    packing of the same messages."""
    messages = _random_messages(37, 37, 400)
    ref_packed = ref.pack_messages(messages, layout="lanes")
    packed = pack_messages(messages, layout="lanes")
    np.testing.assert_array_equal(packed.blocks, ref_packed.blocks)
    np.testing.assert_array_equal(packed.n_blocks, ref_packed.n_blocks)
    out = _words(sha256_lanes_torch(*wave_to_torch(packed.blocks, packed.n_blocks, "cpu")))
    flat = out.transpose(0, 2, 3, 1).reshape(-1, 8)[:37]
    assert digests_from_words(flat) == [hashlib.sha256(m).digest() for m in messages]
    batch_blocks, batch_nb = ref.pack_messages(messages)
    jax_words = np.asarray(sha256_batch_kernel(batch_blocks, batch_nb))[:37]
    np.testing.assert_array_equal(flat, jax_words)


def _garbage_past_last_block(blocks, n_blocks, rng):
    """Random words in every batch-major block at or past a row's count."""
    dead = np.arange(blocks.shape[1])[None, :] >= n_blocks[:, None]
    blocks[dead] = rng.integers(0, 2**32, size=(int(dead.sum()), 16), dtype=np.uint32)


# (rows, L): row counts that are no multiple of the kernels' 32 messages per
# CTA, and the smallest and a large block bucket.
EDGE_WAVES = [(1, 4), (31, 4), (33, 4), (63, 4), (33, 1), (33, 128)]


@pytest.mark.parametrize("rows,L", EDGE_WAVES, ids=[f"rows{r}-L{b}" for r, b in EDGE_WAVES])
def test_twins_at_edge_shapes_match_jax_and_hashlib(rows, L):
    """A ragged wave of ``rows`` rows (7/8 real messages of 1..L blocks,
    then padding rows) with garbage past every row's last block: both twins
    equal the JAX scan program and hashlib, and padding rows keep H0."""
    rng = np.random.default_rng(rows * 1000 + L)
    count = max(1, rows - rows // 8)
    messages = [
        rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
        for n in rng.integers(0, 64 * L - 8, size=count)
    ]
    blocks, n_blocks = pack_messages(messages, block_bucket=L, batch_bucket=rows)
    # The packer rounds the batch up to a power of two; cut the padding rows
    # back to ``rows``.
    blocks, n_blocks = blocks[:rows].copy(), n_blocks[:rows].copy()
    assert blocks.shape == (rows, L, 16)
    _garbage_past_last_block(blocks, n_blocks, rng)
    jax_words = np.asarray(sha256_batch_kernel(blocks, n_blocks))
    batch_words = _words(sha256_batch_torch(*wave_to_torch(blocks, n_blocks, "cpu")))
    np.testing.assert_array_equal(batch_words, jax_words)
    assert digests_from_words(batch_words[:count]) == [
        hashlib.sha256(m).digest() for m in messages
    ]
    np.testing.assert_array_equal(batch_words[count:], np.broadcast_to(port._H0, (rows - count, 8)))
    lanes_words = _words(
        sha256_lanes_torch(*wave_to_torch(*pack_lanes_major(blocks, n_blocks), "cpu"))
    )
    flat = lanes_words.transpose(0, 2, 3, 1).reshape(-1, 8)
    np.testing.assert_array_equal(flat[:rows], jax_words)
    np.testing.assert_array_equal(flat[rows:], np.broadcast_to(port._H0, (TILE - rows, 8)))


def test_lanes_tile_with_one_live_row():
    """A lanes tile whose rows all have n_blocks == 0 but one, in the middle
    of the tile, with garbage words everywhere else."""
    rng = np.random.default_rng(5)
    message = rng.integers(0, 256, size=900, dtype=np.uint8).tobytes()
    padded = pad_message(message)
    blocks = rng.integers(0, 2**32, size=(TILE, 16, 16), dtype=np.uint32)
    n_blocks = np.zeros(TILE, dtype=np.uint32)
    blocks[700, : len(padded)] = padded
    n_blocks[700] = len(padded)
    jax_words = np.asarray(sha256_batch_kernel(blocks, n_blocks))
    lanes_words = _words(
        sha256_lanes_torch(*wave_to_torch(*pack_lanes_major(blocks, n_blocks), "cpu"))
    )
    flat = lanes_words.transpose(0, 2, 3, 1).reshape(TILE, 8)
    np.testing.assert_array_equal(flat, jax_words)
    assert digests_from_words(flat[700:701]) == [hashlib.sha256(message).digest()]
    others = np.delete(flat, 700, axis=0)
    np.testing.assert_array_equal(others, np.broadcast_to(port._H0, (TILE - 1, 8)))


@pytest.mark.parametrize(
    "layout,seed,kw",
    [
        ("batch", 0, {}),
        ("batch", 1, {"block_bucket": 16, "batch_bucket": 64}),
        ("lanes", 2, {}),
        ("lanes", 3, {"block_bucket": 4}),
    ],
)
def test_pack_messages_byte_equal_to_reference(layout, seed, kw):
    messages = _random_messages(seed, 50, 250)
    mine = pack_messages(messages, layout=layout, **kw)
    theirs = ref.pack_messages(messages, layout=layout, **kw)
    assert mine.blocks.dtype == theirs.blocks.dtype == np.uint32
    assert mine.blocks.tobytes() == theirs.blocks.tobytes()
    assert mine.n_blocks.tobytes() == theirs.n_blocks.tobytes()
    assert mine.blocks.shape == theirs.blocks.shape
    blocks_t, nb_t = wave_to_torch(theirs.blocks, theirs.n_blocks, "cpu")
    assert blocks_t.dtype == torch.int32
    assert blocks_t.numpy().tobytes() == theirs.blocks.tobytes()
    assert nb_t.numpy().tobytes() == theirs.n_blocks.tobytes()


def test_wrappers_take_twins_for_cpu_tensors_only():
    blocks, n_blocks = wave_to_torch(*ref.pack_messages([b"abc", b"d" * 70]), "cpu")
    before = sha256_batch.launches
    assert torch.equal(sha256_batch(blocks, n_blocks), sha256_batch_torch(blocks, n_blocks))
    assert sha256_batch.launches == before  # the twin ran: no kernel launch
    with pytest.raises(ValueError):
        sha256_batch(blocks.to("meta"), n_blocks.to("meta"))
    with pytest.raises(TypeError):
        sha256_batch(blocks.to(torch.int64), n_blocks)
    lanes_before = sha256_lanes.launches
    lb, lnb = wave_to_torch(*ref.pack_messages([b"abc"], layout="lanes"), "cpu")
    assert torch.equal(sha256_lanes(lb, lnb), sha256_lanes_torch(lb, lnb))
    assert sha256_lanes.launches == lanes_before
    with pytest.raises(ValueError):
        sha256_lanes(blocks, n_blocks)  # batch-major shape


def _hash_batches_cases():
    rng = random.Random(42)
    randomized = [
        [rng.randbytes(rng.randint(0, 200)) for _ in range(rng.randint(1, 5))]
        for _ in range(100)
    ]
    return {
        "randomized": (dict(min_device_batch=1), randomized),
        "mixed_buckets": (
            dict(min_device_batch=1),
            [[b"a" * n] for n in (0, 1, 55, 56, 64, 119, 500, 5000, 3)],
        ),
        "small_batch_cpu_path": (dict(min_device_batch=32), [[b"tiny"]]),
        "giant_message_falls_back": (
            dict(min_device_batch=1, max_block_bucket=4),
            [[b"q" * 10_000], [b"small"]],
        ),
    }


@pytest.mark.parametrize("case", sorted(_hash_batches_cases()))
def test_torch_hasher_matches_tpu_hasher_scan(case):
    kwargs, batches = _hash_batches_cases()[case]
    expected = [ref_digest(b) for b in batches]
    theirs = TpuHasher(kernel="scan", **kwargs).hash_batches(batches)
    mine = TorchHasher(device="cpu", **kwargs).hash_batches(batches)
    assert mine == theirs == expected


def test_torch_hasher_pipelined_phases_and_lease():
    """pack / dispatch_packed / collect on the CPU: the words answer
    is_ready at once, collect returns the pooled lease, and a second wave of
    the same shape reuses it."""
    hasher = TorchHasher(min_device_batch=1, device="cpu")
    messages = [b"m%d" % i * 40 for i in range(20)]
    packed = hasher.pack(messages, block_bucket=4, batch_bucket=64)
    handle = hasher.dispatch_packed(packed)
    assert handle.words.is_ready()
    lease = handle.lease
    assert hasher.collect(handle) == [hashlib.sha256(m).digest() for m in messages]
    assert handle.lease is None
    assert hasher.pack(messages, block_bucket=4, batch_bucket=64).lease is lease
    snap = metrics.snapshot()
    assert snap["hash_pack_seconds_count"] == 2
    assert snap["hash_device_dispatch_seconds_count"] == 1


def test_torch_hasher_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchHasher()
    with pytest.raises(ValueError):
        TorchHasher(kernel="bogus", device="cpu")
    assert TorchHasher(device="cpu").device.type == "cpu"
