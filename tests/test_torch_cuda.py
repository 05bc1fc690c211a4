"""The port's CUDA kernels on the card: each against its plain twin and
hashlib, and the device hash plane end to end.

Marked ``cuda`` and skipped where no card is present (a fixture decides, at
run time).  On the machine with the card, where the JAX package is not
installed, run them without the repo's conftest (which imports jax)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The file imports nothing of JAX or the JAX package.
"""

import hashlib

import numpy as np
import pytest
import torch

from mirbft_tpu_torch import metrics
from mirbft_tpu_torch.ops.sha256 import (
    TorchHasher,
    digests_from_words,
    pack_messages,
    sha256_batch_torch,
    wave_to_torch,
)
from mirbft_tpu_torch.ops.sha256_pallas import sha256_batch
from mirbft_tpu_torch.ops.sha256_pallas_lanes import sha256_lanes, sha256_lanes_torch

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    metrics.default_registry.reset()
    yield


def _messages(seed, count, max_blocks):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 64 * max_blocks - 8, size=count)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]


@pytest.mark.parametrize("L", [4, 16, 64])
@pytest.mark.parametrize("layout", ["batch", "lanes"])
def test_kernel_equals_twin_and_hashlib(layout, L):
    messages = _messages(L, 300, L)
    packed = pack_messages(messages, block_bucket=L, batch_bucket=512, layout=layout)
    blocks, n_blocks = wave_to_torch(packed.blocks, packed.n_blocks, "cuda")
    kernel, twin = (
        (sha256_lanes, sha256_lanes_torch) if layout == "lanes"
        else (sha256_batch, sha256_batch_torch)
    )
    before = kernel.launches
    got = kernel(blocks, n_blocks)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, twin(blocks, n_blocks))
    words = got.cpu().numpy().view(np.uint32)
    if layout == "lanes":
        words = words.transpose(0, 2, 3, 1).reshape(-1, 8)
    assert digests_from_words(words[: len(messages)]) == [
        hashlib.sha256(m).digest() for m in messages
    ]


def test_crossover_probe_on_the_card():
    from mirbft_tpu_torch.ops.crossover import hash_crossover_batch, measure_hash_probe

    lanes_tile_s, batch_fixed_s, _ = measure_hash_probe("cuda")
    assert lanes_tile_s > 0 and batch_fixed_s > 0
    assert 128 <= hash_crossover_batch("cuda") <= 1024


@pytest.mark.parametrize("kernel", ["scan", "lanes"])
def test_hasher_on_the_card(kernel):
    hasher = TorchHasher(min_device_batch=1, kernel=kernel)
    batches = [[b"part-%d" % i, b"x" * (i * 37)] for i in range(200)]
    handle = hasher.dispatch([b"".join(p) for p in batches[:50]], block_bucket=4)
    assert handle.words.event is not None
    assert hasher.hash_batches(batches) == [
        hashlib.sha256(b"".join(p)).digest() for p in batches
    ]
    hasher.collect(handle)
