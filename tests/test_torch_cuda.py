"""The port's CUDA kernels on the card: each against its plain twin and
hashlib or ``verify_one``, and the device hash plane end to end.

Marked ``cuda`` and skipped where no card is present (a fixture decides, at
run time).  On the machine with the card, where the JAX package is not
installed, run them without the repo's conftest (which imports jax)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The file imports nothing of JAX or the JAX package.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import QUORUM_SHAPES, as_tensors, gated_stream
from mirbft_tpu_torch import metrics
from mirbft_tpu_torch.ops import ed25519
from mirbft_tpu_torch.ops.sha256 import (
    _H0,
    TorchHasher,
    digests_from_words,
    pack_messages,
    pad_message,
    sha256_batch_torch,
    wave_to_torch,
)
from mirbft_tpu_torch.ops.sha256_pallas import sha256_batch
from mirbft_tpu_torch.ops.sha256_pallas_lanes import (
    pack_lanes_major,
    sha256_lanes,
    sha256_lanes_torch,
)

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


def _twin_and_rows(layout):
    if layout == "lanes":
        return sha256_lanes, sha256_lanes_torch, lambda w: w.transpose(0, 2, 3, 1).reshape(-1, 8)
    return sha256_batch, sha256_batch_torch, lambda w: w


# (rows, L): row counts that are no multiple of a CTA's 32 messages, the
# smallest and large block buckets; L = 256 wraps the 4-stage ring 64 times.
EDGE_WAVES = [(1, 4), (31, 4), (33, 4), (63, 4), (33, 1), (33, 128), (64, 256)]


@pytest.mark.parametrize("rows,L", EDGE_WAVES, ids=[f"rows{r}-L{b}" for r, b in EDGE_WAVES])
@pytest.mark.parametrize("layout", ["batch", "lanes"])
def test_kernel_at_edge_shapes(layout, rows, L):
    """Ragged waves with garbage past every row's last block: the kernel
    equals its twin bit for bit and hashlib, and padding rows keep H0."""
    rng = np.random.default_rng(rows * 1000 + L)
    count = max(1, rows - rows // 8)
    messages = _messages(rows * 1000 + L, count, L)
    blocks, n_blocks = pack_messages(messages, block_bucket=L, batch_bucket=rows)
    blocks, n_blocks = blocks[:rows].copy(), n_blocks[:rows].copy()
    dead = np.arange(L)[None, :] >= n_blocks[:, None]
    blocks[dead] = rng.integers(0, 2**32, size=(int(dead.sum()), 16), dtype=np.uint32)
    if layout == "lanes":
        blocks, n_blocks = pack_lanes_major(blocks, n_blocks)
    kernel, twin, rows_of = _twin_and_rows(layout)
    bt, nt = wave_to_torch(blocks, n_blocks, "cuda")
    got = kernel(bt, nt)
    torch.cuda.synchronize()
    assert torch.equal(got, twin(bt, nt))
    words = rows_of(got.cpu().numpy().view(np.uint32))
    assert digests_from_words(words[:count]) == [hashlib.sha256(m).digest() for m in messages]
    assert (words[count:] == _H0).all()


@pytest.mark.parametrize("layout", ["batch", "lanes"])
def test_kernel_with_one_live_row(layout):
    """1,024 rows with garbage words, all at n_blocks == 0 but row 700: 31
    of the 32 CTAs write H0 without touching their ring."""
    rng = np.random.default_rng(5)
    message = rng.integers(0, 256, size=900, dtype=np.uint8).tobytes()
    padded = pad_message(message)
    blocks = rng.integers(0, 2**32, size=(1024, 16, 16), dtype=np.uint32)
    n_blocks = np.zeros(1024, dtype=np.uint32)
    blocks[700, : len(padded)] = padded
    n_blocks[700] = len(padded)
    if layout == "lanes":
        blocks, n_blocks = pack_lanes_major(blocks, n_blocks)
    kernel, twin, rows_of = _twin_and_rows(layout)
    bt, nt = wave_to_torch(blocks, n_blocks, "cuda")
    got = kernel(bt, nt)
    torch.cuda.synchronize()
    assert torch.equal(got, twin(bt, nt))
    words = rows_of(got.cpu().numpy().view(np.uint32))
    assert digests_from_words(words[700:701]) == [hashlib.sha256(message).digest()]
    assert (np.delete(words, 700, axis=0) == _H0).all()


def test_pipe_probes():
    from mirbft_tpu_torch.ops import latency_probe

    cycles, clock_hz = latency_probe.dependent_issue_latency(trips=1 << 12)
    assert 1.0 <= cycles <= 32.0
    assert 0.3e9 <= clock_hz <= 3.0e9
    for op in latency_probe.ISSUE_OPS:
        assert 0.5 <= latency_probe.issue_cycles(op, trips=1 << 8) <= 32.0
    for op in latency_probe.FIELD_OPS:
        assert 1.0 <= latency_probe.field_cycles(op, calls=1 << 6) <= 100_000.0
    one = latency_probe.round_cycles(1, blocks=16)
    assert 8.0 <= one <= 200.0
    assert latency_probe.round_cycles(2, blocks=16) > one


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


@functools.lru_cache(maxsize=None)
def _signed_rows():
    """48 signed rows (a quarter tampered in R, a quarter in the message),
    packed to 64 with 16 padding rows, and their ``verify_one`` verdicts."""
    pubs, msgs, sigs = [], [], []
    for i in range(48):
        pub, sign = ed25519.keypair_from_seed((i + 1).to_bytes(4, "big") * 8)
        msg = b"card-%d" % i
        sig = sign(msg)
        if i % 4 == 1:
            sig = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
        elif i % 4 == 2:
            msg += b"!"
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
    arrays = ed25519.Ed25519BatchVerifier(device="cpu").pack_inputs(pubs, msgs, sigs, batch=64)
    expected = [ed25519.verify_one(*row) for row in zip(pubs, msgs, sigs)]
    return (pubs, msgs, sigs), arrays, expected


@pytest.mark.parametrize("rows", [1, 7, 9, 16, 33, 1024, 4096])
def test_ed25519_kernel_equals_twin_and_verify_one(rows):
    _, arrays, expected = _signed_rows()
    pick = np.arange(rows) % 64
    inputs = [torch.from_numpy(np.ascontiguousarray(a[pick])).cuda() for a in arrays[:5]]
    before = ed25519.ed25519_verify_kernel.launches
    got = ed25519.ed25519_verify_kernel(*inputs)
    torch.cuda.synchronize()
    assert ed25519.ed25519_verify_kernel.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got, ed25519.verify_torch(*inputs))
    verdicts = got.cpu().numpy() & arrays[5][pick]
    for i, row in enumerate(pick):
        assert verdicts[i] == (expected[row] if row < 48 else False)


def test_ed25519_wrapper_rejects_what_the_kernel_does_not_take():
    limbs = torch.zeros((8, 32), dtype=torch.int32, device="cuda")
    bits = torch.zeros((8, 256), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        ed25519.ed25519_verify_kernel(limbs.to(torch.int64), limbs, limbs, bits, bits)
    with pytest.raises(ValueError):
        ed25519.ed25519_verify_kernel(limbs, limbs, limbs, bits[:, :32].contiguous(), bits)
    with pytest.raises(ValueError):
        ed25519.ed25519_verify_kernel(limbs, limbs.cpu(), limbs, bits, bits)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ed25519.ed25519_verify_kernel(limbs, limbs, limbs, bits, bits, backend="mxu")


def test_ed25519_verifier_on_the_card():
    (pubs, msgs, sigs), _, expected = _signed_rows()
    verifier = ed25519.Ed25519BatchVerifier(min_device_batch=1)
    handle = verifier.dispatch(pubs, msgs, sigs)
    assert handle.event is not None and handle.ok.is_cuda
    assert verifier.collect(handle).tolist() == expected
    assert verifier.verify_batch(pubs[:20], msgs[:20], sigs[:20]).tolist() == expected[:20]


@pytest.mark.parametrize("W,D,N,K", QUORUM_SHAPES, ids=[
    f"N{n}-K{k}" if w == 4096 else f"W{w}-N{n}-K{k}" for w, _, n, k in QUORUM_SHAPES])
def test_quorum_kernel_equals_twin(W, D, N, K):
    from mirbft_tpu_torch.ops import quorum

    arrays = gated_stream(np.random.default_rng(N * 100 + K), W, D, N, K)
    cpu = as_tensors(arrays, "cpu")
    want = quorum.quorum_accumulate_torch(*cpu[:5], tuple(cpu[5:]))
    cuda = as_tensors(arrays, "cuda")
    before = quorum.quorum_accumulate.launches
    posts, newbits = quorum.quorum_accumulate(*cuda[:5], tuple(cuda[5:]))
    torch.cuda.synchronize()
    assert quorum.quorum_accumulate.launches == before + 1
    for got, expect in zip((cuda[0], cuda[1], posts, newbits), want):
        assert torch.equal(got.cpu(), expect)
    assert 0 < int(want[3].sum()) < want[3].numel()


def test_fused_wave_on_the_card():
    """A lanes wave with signed rows and gated touches, chained into a
    batch wave, against the host oracle; each stage launched its kernel."""
    from mirbft_tpu_torch.ops import quorum
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline, host_fused_reference
    from mirbft_tpu_torch.ops.sha256_pallas import sha256_batch
    from mirbft_tpu_torch.ops.sha256_pallas_lanes import sha256_lanes

    (pubs, msgs, sigs), _, expected = _signed_rows()
    messages = _messages(11, 1500, 4)
    d1 = [hashlib.sha256(m).digest() for m in messages]
    quorum1 = [(s, [(s % 16, 0, s, d1[s]), (3, 1, 7, d1[8])]) for s in range(8)]
    pipe = FusedCryptoPipeline(n_slots=16, n_digest_slots=2, kernel="lanes")
    launches = [k.launches for k in (sha256_lanes, ed25519.ed25519_verify_kernel,
                                     quorum.quorum_accumulate)]
    h1 = pipe.dispatch_wave(messages, signed=(pubs, msgs, sigs), quorum=quorum1)
    assert [k.launches for k in (sha256_lanes, ed25519.ed25519_verify_kernel,
                                 quorum.quorum_accumulate)] == [n + 1 for n in launches]
    assert h1.words.tensor.is_cuda and h1.rows == 2048
    scan = FusedCryptoPipeline(n_slots=16, n_digest_slots=2, kernel="scan")
    before = sha256_batch.launches
    messages2 = messages[:5]
    quorum2 = [(9, [(1, 1, 100, d1[100]), (2, 1, h1.rows + 3, d1[3])])]
    scan.masks.copy_(pipe.masks)
    scan.counts.copy_(pipe.counts)
    h2 = scan.dispatch_wave(messages2, quorum=quorum2, chain=h1)
    assert sha256_batch.launches == before + 1 and h2.ok is None
    r1 = pipe.collect(h1)
    masks0 = np.zeros((16, 2, 8), np.uint32)
    counts0 = np.zeros((16, 2), np.int32)
    rd, _, rm, rc, rp, rn = host_fused_reference(
        messages, None, quorum1, masks0, counts0)
    assert r1.digests == rd and r1.verdicts.tolist() == expected
    assert (r1.posts[:8] == rp[:8]).all() and (r1.newbits[:8] == rn[:8]).all()
    _, _, rm2, rc2, rp2, rn2 = host_fused_reference(
        messages2, None, quorum2, rm, rc, prev_digests=rd, prev_rows=h1.rows)
    part = scan.collect_ready(h2, [4, 0])
    assert part.digests == [d1[4], d1[0]]
    assert (part.posts[:1] == rp2[:1]).all() and (part.newbits[:1] == rn2[:1]).all()
    dm, dc = scan.quorum_state()
    assert (dm == rm2).all() and (dc == rc2).all()
    assert scan.collect(h2).digests == d1[:5] and h2.lease is None and h1.lease is None
