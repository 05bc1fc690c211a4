"""The port's CUDA kernels on the card: each against its plain twin and
hashlib or ``verify_one``, the device hash plane end to end, the native
fast engine's hash and verdict waves, and the cohost plane's shared waves
and deployment.

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
    alone = latency_probe.mma_cycles(4, trips=1 << 6)
    assert 1.0 <= alone <= 200.0
    assert latency_probe.mma_cycles(8, trips=1 << 6) >= alone  # two share one
    assert alone <= latency_probe.tile_cycles(4, trips=1 << 6) <= 2_000.0  # two MMAs a tile


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
    # The "mxu" kernel takes the same inputs and refuses the same.
    with pytest.raises(TypeError):
        ed25519.ed25519_verify_kernel(limbs.to(torch.int64), limbs, limbs, bits, bits,
                                      backend="mxu")
    with pytest.raises(ValueError):
        ed25519.ed25519_verify_kernel(limbs, limbs.cpu(), limbs, bits, bits, backend="mxu")
    before = ed25519.ed25519_verify_mxu_kernel.launches
    assert ed25519.ed25519_verify_kernel(limbs[:0], limbs[:0], limbs[:0], bits[:0], bits[:0],
                                         backend="mxu").shape == (0,)
    assert ed25519.ed25519_verify_mxu_kernel.launches == before  # 0 rows launch nothing


@pytest.mark.parametrize("rows", [1, 7, 16, 17, 33, 64, 1024])
def test_ed25519_mxu_kernel_equals_twin_and_verify_one(rows):
    """The tensor-core ("mxu") kernel against ``verify_torch`` with
    ``_mul_mxu`` on the card, bit for bit, and ``verify_one``: partial
    groups of 8 rows, padding rows, tampered rows."""
    _, arrays, expected = _signed_rows()
    pick = np.arange(rows) % 64
    inputs = [torch.from_numpy(np.ascontiguousarray(a[pick])).cuda() for a in arrays[:5]]
    before = (ed25519.ed25519_verify_kernel.launches, ed25519.ed25519_verify_mxu_kernel.launches)
    got = ed25519.ed25519_verify_kernel(*inputs, backend="mxu")
    torch.cuda.synchronize()
    assert (ed25519.ed25519_verify_kernel.launches,
            ed25519.ed25519_verify_mxu_kernel.launches) == (before[0], before[1] + 1)
    want = ed25519.verify_torch(*inputs, mul=ed25519._mul_mxu)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert torch.equal(got, ed25519.ed25519_verify_kernel(*inputs))
    verdicts = got.cpu().numpy() & arrays[5][pick]
    for i, row in enumerate(pick):
        assert verdicts[i] == (expected[row] if row < 48 else False)


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


def _fast_run(spec, **kwargs):
    """Drain a FastRecording of ``spec`` on the card; returns its steps and
    per-node (checkpoint, active hash, committed requests)."""
    import fcntl

    from mirbft_tpu_torch import _native
    from mirbft_tpu_torch.testengine import FastRecording

    with open(_native._FAST_SRC, "rb") as source:
        fcntl.flock(source, fcntl.LOCK_EX)
        assert _native.load_fast() is not None
    fast = FastRecording(spec, torch_device="cuda", **kwargs)
    steps = fast.drain_clients(timeout=10_000_000)
    state = [(n.checkpoint_seq_no, n.checkpoint_hash, n.active_hash_digest,
              dict(n.committed_reqs)) for n in fast.nodes]
    return steps, state, fast


def _hash_launches():
    return sha256_batch.launches + sha256_lanes.launches


@pytest.mark.parametrize("authoritative", [False, True], ids=["mirror", "authoritative"])
def test_fast_engine_hash_waves_on_the_card(authoritative):
    """The native engine's 4-node run with its hash waves on the card (the
    mirror, every digest checked against the engine's; or authoritative,
    the card producing them) equals its host path, one kernel launch a
    dispatch."""
    from mirbft_tpu_torch.testengine import Spec

    spec = Spec(node_count=4, client_count=4, reqs_per_client=20, batch_size=5)
    host_steps, host_state, host = _fast_run(spec)
    metrics.default_registry.reset()
    before = _hash_launches()
    steps, state, fast = _fast_run(spec, device=True, pipeline=True,
                                   device_authoritative=authoritative)
    dispatches = metrics.counter("device_hash_dispatches").value
    assert (steps, state) == (host_steps, host_state)
    assert dispatches > 0 and _hash_launches() - before == dispatches
    if authoritative:
        assert fast._engine.stats()[3] <= host._engine.stats()[3]


def test_fast_engine_streaming_verdicts_on_the_card():
    """Streaming verdict waves equal the pre-run bitmap pass, more than one
    verify launch, and the corrupt signer commits nothing."""
    from mirbft_tpu_torch.testengine import Spec

    def corrupt(recorder):
        recorder.client_configs[1].corrupt = True

    spec = Spec(node_count=4, client_count=2, reqs_per_client=40, batch_size=5,
                signed_requests=True, tweak_recorder=corrupt)
    bitmap_steps, bitmap_state, _ = _fast_run(spec, device=True, auth_wave=64)
    metrics.default_registry.reset()
    before = ed25519.ed25519_verify_kernel.launches
    steps, state, _ = _fast_run(spec, device=True, streaming_auth=True, auth_wave=64)
    dispatches = metrics.counter("device_verify_dispatches").value
    assert (steps, state) == (bitmap_steps, bitmap_state)
    assert dispatches > 1 and ed25519.ed25519_verify_kernel.launches - before == dispatches
    assert all(node[3].get(1, 0) == 0 and node[3].get(0, 0) == 40 for node in state)


def test_cohost_plane_on_the_card():
    """The cohost plane's shared wave on the card: two tenants' 608-byte
    rows (past the host fast path) in one wave, one tenant collecting on
    another thread, digests equal hashlib's, and each wave launches the
    hash kernel and the quorum kernel once."""
    import threading

    from chip_smoke import MUX_GROUPS, MUX_ROWS, mux_rows
    from mirbft_tpu_torch.groups.cohost import CohostCryptoPlane
    from mirbft_tpu_torch.ops import quorum

    plane = CohostCryptoPlane(MUX_GROUPS, wave_size=MUX_GROUPS * MUX_ROWS, adaptive=False)
    hashers = [plane.hasher_for(g) for g in range(MUX_GROUPS)]
    before = (_hash_launches(), quorum.quorum_accumulate.launches)
    for r in range(3):
        batches = mux_rows(b"card-test", r)
        handles = [hashers[g].dispatch_batches(batches[g]) for g in range(MUX_GROUPS)]
        out = {}
        worker = threading.Thread(target=lambda: out.update(last=hashers[-1].collect_batches(
            handles[-1])))
        worker.start()
        got = [hashers[g].collect_batches(handles[g]) for g in range(MUX_GROUPS - 1)]
        worker.join()
        got.append(out["last"])
        assert got == [[hashlib.sha256(p[0]).digest() for p in batches[g]]
                       for g in range(MUX_GROUPS)]
    assert metrics.counter("fused_wave_dispatches").value == 3
    assert (_hash_launches() - before[0], quorum.quorum_accumulate.launches - before[1]) == (3, 3)


def test_mux_waves_on_the_card():
    """chip_smoke.py's phase-7 wave checks: the shared stream across
    threads, the cohost plane against hashlib and solo pipelines, one mux
    wave carrying both tenants' signatures against verify_torch with the
    forgery in its own group, and a multi-group gated quorum wave against
    its plain version."""
    from chip_smoke import check_mux_waves

    times = check_mux_waves()
    assert times["mux_wave_ms"] > 0 and times["signed_mux_wave_ms"] > 0


def test_cohost_deployment_on_the_card(tmp_path, monkeypatch):
    """tools/mirnet.py's cohost deployment, its plane probed onto the card
    in each host process: the gauge says so on every host and both groups
    commit.  At this load the plane launches no wave: the harness's rows
    take its host fast path."""
    import os

    from mirbft_tpu_torch.tools import mirnet

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("MIRNET_SHARED_WAVE", raising=False)
    monkeypatch.delenv("MIRNET_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("PYTHONPATH", root)
    res = mirnet.run_sharded_deployment(root_dir=str(tmp_path), groups=2, nodes_per_group=2,
                                        reqs_per_group=20, layout="cohost", timeout_s=120)
    assert res["unique_reqs_total"] == 40
    for host in range(2):
        prom = tmp_path / "group-0" / f"node-{host}" / "metrics.prom"
        assert mirnet._metric_file_value(prom, "wave_mux_active") == 1


@pytest.mark.parametrize("rows", [1, 7, 33, 4097])
@pytest.mark.parametrize("mask", ["all", "none", "random"])
def test_mesh_count_kernel_equals_plain_version(rows, mask):
    from mirbft_tpu_torch.parallel import shard_count, shard_count_torch

    rng = np.random.default_rng(rows + len(mask))
    pick = {"all": np.ones(rows, bool), "none": np.zeros(rows, bool),
            "random": rng.random(rows) < 0.3}[mask]
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(rows, 8), dtype=np.int64)
                             .astype(np.int32)).cuda()
    expected = words.clone()
    flip = torch.from_numpy(pick).cuda()
    expected[flip, 3] ^= 1
    before = shard_count.launches
    got = shard_count("digests", words, expected)
    assert shard_count.launches == before + 1
    assert int(got) == int(shard_count_torch("digests", words, expected)) == int(pick.sum())
    ok = torch.from_numpy(rng.random(rows) < 0.6).cuda()
    valid = torch.from_numpy(rng.random(rows) < 0.8).cuda()
    ok_plain = ok.clone()
    got = shard_count("verdicts", ok, valid, flip)
    want = shard_count_torch("verdicts", ok_plain, valid, flip)
    torch.cuda.synchronize()
    assert int(got) == int(want) and torch.equal(ok, ok_plain)


def test_mesh_on_the_card():
    """The mesh of every card: sharded digests equal the unsharded kernel's,
    the verify step counts corrupted rows, sharded verification equals the
    kernel's and counts the corrupt real rows, and the dry run passes."""
    from mirbft_tpu_torch import graft_entry, parallel

    mesh = parallel.make_mesh(torch.cuda.device_count())
    with pytest.raises(ValueError):
        parallel.make_mesh(torch.cuda.device_count() + 1)
    messages = _messages(7, 64 * mesh.size, 4)
    packed = pack_messages(messages, block_bucket=4)
    words = parallel.sharded_sha256(mesh)(packed.blocks, packed.n_blocks)
    assert words.device == mesh.devices[0]
    blocks, n_blocks = wave_to_torch(packed.blocks, packed.n_blocks, "cuda")
    assert torch.equal(words, sha256_batch(blocks, n_blocks))
    host = words.cpu().numpy().view(np.uint32)
    corrupted = host.copy()
    corrupted[[0, 5]] ^= 1
    _, count = parallel.distributed_verify_step(mesh)(packed.blocks, packed.n_blocks, corrupted)
    assert int(count) == 2
    (pubs, msgs, sigs), arrays, expected = _signed_rows()
    real = np.arange(64) < 48
    ok, invalid = parallel.sharded_ed25519_verify(mesh)(*arrays, real)
    inputs = [torch.from_numpy(a).cuda() for a in arrays[:5]]
    plain = ed25519.verify_torch(*inputs).cpu().numpy() & arrays[5]
    assert np.array_equal(ok.cpu().numpy(), plain)
    assert int(invalid) == sum(1 for e in expected if not e)
    graft_entry.dryrun_multichip(mesh.size)


def test_mesh_mxu_verify_on_the_card():
    """sharded_ed25519_verify(kernel="mxu") over every card: each shard
    launches the "mxu" kernel, and the verdicts equal the twin's (with
    ``_mul_mxu``) and the count the corrupt real rows."""
    from mirbft_tpu_torch import parallel

    mesh = parallel.make_mesh(torch.cuda.device_count())
    (_, _, _), arrays, expected = _signed_rows()
    real = np.arange(64) < 48
    before = ed25519.ed25519_verify_mxu_kernel.launches
    ok, invalid = parallel.sharded_ed25519_verify(mesh, kernel="mxu")(*arrays, real)
    assert ed25519.ed25519_verify_mxu_kernel.launches == before + mesh.size
    inputs = [torch.from_numpy(a).cuda() for a in arrays[:5]]
    plain = ed25519.verify_torch(*inputs, mul=ed25519._mul_mxu).cpu().numpy() & arrays[5]
    assert np.array_equal(ok.cpu().numpy(), plain)
    assert int(invalid) == sum(1 for e in expected if not e)


def test_mesh_count_back_to_back_launches_leave_the_ticket_zero():
    """Counts of several blocks, back to back on one stream: each equals
    the plain version and every launch leaves the stream's accumulator at
    zero."""
    from mirbft_tpu_torch.parallel import mesh as mesh_ops

    rng = np.random.default_rng(3)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(4097, 8), dtype=np.int64)
                             .astype(np.int32)).cuda()
    counts, wants = [], []
    for flips in range(1, 11):
        expected = words.clone()
        expected[:flips * 300, 5] ^= 4
        counts.append(mesh_ops.shard_count("digests", words, expected))
        wants.append(min(flips * 300, 4097))
    torch.cuda.synchronize()
    assert [int(c) for c in counts] == wants
    acc = mesh_ops._accumulator(words.device, torch.cuda.current_stream())
    assert int(acc) == 0


@functools.lru_cache(maxsize=None)
def _pack_cases():
    rng = np.random.default_rng(17)
    boundary = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
                for n in (0, 1, 55, 56, 63, 64, 119, 120, 640)]
    fused = [rng.integers(0, 256, size=640, dtype=np.uint8).tobytes() for _ in range(4096)]
    c3 = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
          for n in rng.integers(0, 64 * 64 - 8, size=64)]
    return {"boundary": (boundary, {}), "fused": (fused, {}),
            "c3": (c3, {"block_bucket": 64, "batch_bucket": 64})}


@pytest.mark.parametrize("case", ["boundary", "fused", "c3"])
@pytest.mark.parametrize("layout", ["batch", "lanes"])
def test_pack_kernel_equals_plain_version_and_host_packer(layout, case):
    from mirbft_tpu_torch.ops.pack import StagingPool, pack_wave, pack_wave_torch, stage_messages

    messages, kw = _pack_cases()[case]
    wave = stage_messages(messages, layout=layout, pool=StagingPool(pinned=True), **kw)
    t = wave.views(wave.copy_in(torch.device("cuda")))
    inputs = (t["raw"], t["offsets"], t["lengths"], wave.batch, wave.bucket, layout)
    before = pack_wave.launches
    blocks, n_blocks = pack_wave(*inputs)
    assert pack_wave.launches == before + 1
    plain_blocks, plain_n = pack_wave_torch(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(blocks, plain_blocks) and torch.equal(n_blocks, plain_n)
    want = pack_messages(messages, layout=layout, **kw)
    assert blocks.cpu().numpy().view(np.uint32).tobytes() == want.blocks.tobytes()
    assert n_blocks.cpu().numpy().view(np.uint32).tobytes() == want.n_blocks.tobytes()


def test_pipelined_waves_never_refill_a_staged_buffer_in_flight():
    """Twenty fused waves of 4,096 x 640 bytes, two message sets in turn,
    queued behind a spin kernel so every copy is still pending when its
    lease goes back to the pool: no wave refills a buffer whose copy has
    not run, and every wave's digests equal hashlib."""
    from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline

    messages = _pack_cases()["fused"][0]
    sets = [messages, messages[::-1]]
    expect = [[hashlib.sha256(m).digest() for m in s] for s in sets]
    pipe = FusedCryptoPipeline(n_slots=64, n_digest_slots=2)
    pipe.collect(pipe.dispatch_wave(sets[0]))  # builds and probes outside the window
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s: holds the stream while the host stages
    handles, buffers = [], set()
    for i in range(20):
        handle = pipe.dispatch_wave(sets[i % 2])
        buffers.add(handle.lease.flat.data_ptr())
        pipe._release_lease(handle)  # back to the pool while its copy waits
        handles.append(handle)
    assert len(buffers) == 20
    for i, handle in enumerate(handles):
        assert pipe.collect(handle).digests == expect[i % 2], i


def test_hasher_waves_are_packed_on_the_card():
    """TorchHasher on the card stages each wave and launches the pack
    kernel once a wave, before its hash kernel."""
    from mirbft_tpu_torch.ops.pack import StagedWave, pack_wave

    hasher = TorchHasher(min_device_batch=1, kernel="scan")
    messages = [b"staged-%d" % i * (i % 9) for i in range(300)]
    packed = hasher.pack(messages)
    assert isinstance(packed, StagedWave) and packed.lease.flat.is_pinned()
    before = (pack_wave.launches, sha256_batch.launches)
    handle = hasher.dispatch_packed(packed)
    assert (pack_wave.launches, sha256_batch.launches) == (before[0] + 1, before[1] + 1)
    assert packed.lease.event is handle.words.event
    assert hasher.collect(handle) == [hashlib.sha256(m).digest() for m in messages]
