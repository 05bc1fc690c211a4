"""The port's fused hash→verify→quorum wave (``mirbft_tpu_torch/ops/fused.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_fused_wave.py``'s parity cases against the port's copy
of the host oracle ``host_fused_reference`` (boundary lengths, mixed batch
sizes, signed rows with a digest-gated quorum, both packed layouts, lease
discipline across pipelined waves, chained waves, the released-handle error,
partial collects); holds the port's ``FusedCryptoPipeline`` to the JAX one
on one shared set of waves (digests, verdicts, posts, newbits, masks,
counts), whose quorum streams carry what the JAX program clamps, drops or
counts twice; and runs fused ``Recording``s, unsigned and signed, against
the JAX package's fused ``Recording``s.  The port runs its kernels' plain
PyTorch versions here (``device="cpu"``).  Everything compared is bytes or
integers: every comparison is exact.
"""

import hashlib

import numpy as np
import pytest
import torch

from mirbft_tpu import metrics as ref_metrics
from mirbft_tpu.ops.fused import FusedCryptoPipeline as RefPipeline
from mirbft_tpu.testengine import CryptoConfig as RefCryptoConfig
from mirbft_tpu.testengine import Spec as RefSpec
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.ops.ed25519 import keypair_from_seed
from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline, host_fused_reference
from mirbft_tpu_torch.testengine import CryptoConfig, Spec

# SHA-256 padding boundaries: 55/56 straddle the one-block limit, 119/120
# the two-block limit, and so on every 64 bytes.
BOUNDARY_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 183, 184, 247, 248)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # The twins run many small ops; under several test workers, each with a
    # pool of intra-op threads, the pools oversubscribe the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_port_observability():
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


def _pipe(**kwargs):
    return FusedCryptoPipeline(device="cpu", **kwargs)


def _fresh_states(n_slots, n_digest_slots):
    return (
        np.zeros((n_slots, n_digest_slots, 8), dtype=np.uint32),
        np.zeros((n_slots, n_digest_slots), dtype=np.int32),
    )


def _parity(msgs, signed=None, quorum=None, kernel="auto", n_slots=16,
            n_digest_slots=2):
    """One fused dispatch vs the host oracle; asserts every output equal."""
    pipe = _pipe(n_slots=n_slots, n_digest_slots=n_digest_slots, kernel=kernel)
    handle = pipe.dispatch_wave(msgs, signed=signed, quorum=quorum)
    res = pipe.collect(handle)
    masks0, counts0 = _fresh_states(n_slots, n_digest_slots)
    rd, rv, rm, rc, rp, rn = host_fused_reference(
        msgs, signed, quorum, masks0, counts0
    )
    assert res.digests == rd
    assert list(res.verdicts) == list(rv)
    dm, dc = pipe.quorum_state()
    assert (dm == rm).all()
    assert (dc == rc).all()
    if quorum:
        nq = len(quorum)
        assert (res.posts[:nq] == rp[:nq]).all()
        assert (res.newbits[:nq] == rn[:nq]).all()
    return res, handle


def test_fused_parity_boundary_lengths():
    msgs = [
        bytes([97 + i % 26]) * length
        for i, length in enumerate(BOUNDARY_LENGTHS)
    ]
    _parity(msgs)


@pytest.mark.parametrize("batch", [1, 2, 3, 7, 16, 33])
def test_fused_parity_mixed_batch_sizes(batch):
    msgs = [b"fused-%d" % i + b"x" * (i * 29 % 200) for i in range(batch)]
    _, handle = _parity(msgs)
    assert handle.ok is None  # no signed rows: no verify launch


def test_fused_parity_verify_and_gated_quorum():
    """Signed rows (incl. a forged one) and digest-gated touches (incl. a
    mismatched claimed digest) match the host oracle exactly."""
    msgs = [bytes([i + 1]) * (50 + 37 * i) for i in range(7)]
    pub, sign = keypair_from_seed(b"\x01" * 32)
    payloads = [b"payload-%d" % i for i in range(3)]
    sigs = [sign(m) for m in payloads]
    sigs[1] = b"\x00" * 64  # forged
    signed = ([pub] * 3, payloads, sigs)
    good_claim = hashlib.sha256(msgs[2]).digest()
    quorum = [
        (5, [(0, 0, 2, good_claim), (1, 0, None, None)]),  # gate passes
        (9, [(0, 0, 2, b"\xff" * 32)]),  # gate rejects: wrong claim
        (9, [(1, 0, None, None)]),  # ungated from the rejected source
    ]
    res, _ = _parity(msgs, signed=signed, quorum=quorum, n_slots=8)
    assert list(res.verdicts) == [True, False, True]


def test_fused_parity_batch_layout_explicit():
    """kernel="scan" pins the batch layout regardless of crossover."""
    msgs = [b"layout-%d" % i * 10 for i in range(12)]
    _, handle = _parity(msgs, kernel="scan")
    assert handle.layout == "batch"


def test_fused_parity_lanes_layout():
    """The lanes layout: one tile of 1,024 rows, permuted to one digest row
    per message before the gate (the JAX package runs this case on a TPU
    only; the port's plain lanes version runs on the CPU)."""
    msgs = [b"lanes-%d" % i + b"z" * (i % 120) for i in range(100)]
    pub, sign = keypair_from_seed(b"\x02" * 32)
    signed = ([pub], [b"m"], [sign(b"m")])
    quorum = [(3, [(0, 0, 5, hashlib.sha256(msgs[5]).digest())])]
    res, handle = _parity(msgs, signed=signed, quorum=quorum, kernel="lanes")
    assert handle.layout == "lanes" and handle.rows == 1024
    assert tuple(handle.words.tensor.shape) == (1024, 8)
    assert list(res.verdicts) == [True] and res.newbits[0, 0]


def test_fused_lease_discipline_across_pipelined_waves():
    """Every pipelined wave holds its own pool lease until ITS collect;
    collects return every lease, and a fresh same-shape dispatch reuses a
    pooled buffer instead of allocating a fifth one."""
    pipe = _pipe(n_slots=4, n_digest_slots=1, kernel="scan")
    pool = pipe.hasher._pool

    def msgs(k):
        return [b"lease-%d-%d" % (k, i) for i in range(8)]

    handles = [pipe.dispatch_wave(msgs(k)) for k in range(4)]
    assert all(h.lease is not None for h in handles)
    # Four concurrent leases of one shape: four distinct buffers.
    assert len({id(h.lease.flat) for h in handles}) == 4
    results = [pipe.collect(h) for h in handles]
    assert all(h.lease is None for h in handles)
    for k, res in enumerate(results):
        assert res.digests == [hashlib.sha256(m).digest() for m in msgs(k)]
    (key, free), = pool._free.items()
    assert len(free) == 4  # every lease came back
    pipe.collect(pipe.dispatch_wave(msgs(9)))
    assert len(pool._free[key]) == 4  # reused, not grown


def test_fused_chained_wave_gates_on_previous_wave_digests():
    """Wave 2's quorum gates reference wave 1's digests WITHOUT wave 1
    ever being collected: the chained handle keeps wave 1's digest words on
    the device and the gate reads the combined [chain; current] row
    space."""
    pipe = _pipe(n_slots=8, n_digest_slots=1, kernel="scan")
    msgs1 = [b"chain-a-%d" % i for i in range(4)]
    msgs2 = [b"chain-b-%d" % i for i in range(4)]
    h1 = pipe.dispatch_wave(msgs1)
    rows1 = h1.rows
    quorum = [
        # Gates on WAVE 1's row 2 (still on the device, never collected).
        (3, [(0, 0, 2, hashlib.sha256(msgs1[2]).digest())]),
        # Rejected: wrong claim against wave 1's row 1.
        (5, [(1, 0, 1, b"\xff" * 32)]),
        # Gates on THIS wave's row 1 (offset past the chained rows).
        (6, [(2, 0, rows1 + 1, hashlib.sha256(msgs2[1]).digest())]),
    ]
    h2 = pipe.dispatch_wave(msgs2, quorum=quorum, chain=h1)
    assert h2.chain is h1
    res2 = pipe.collect(h2)
    masks0, counts0 = _fresh_states(8, 1)
    rd, _, rm, rc, rp, rn = host_fused_reference(
        msgs2, None, quorum, masks0, counts0,
        prev_digests=[hashlib.sha256(m).digest() for m in msgs1],
        prev_rows=rows1,
    )
    assert res2.digests == rd
    nq = len(quorum)
    assert (res2.posts[:nq] == rp[:nq]).all()
    assert (res2.newbits[:nq] == rn[:nq]).all()
    dm, dc = pipe.quorum_state()
    assert (dm == rm).all() and (dc == rc).all()
    # The chained wave's own digests stayed collectable throughout.
    res1 = pipe.collect(h1)
    assert res1.digests == [hashlib.sha256(m).digest() for m in msgs1]


def test_fused_chained_wave_rejects_released_handle():
    pipe = _pipe(n_slots=4, n_digest_slots=1, kernel="scan")
    h1 = pipe.dispatch_wave([b"gone"])
    pipe.collect(h1)
    h1.words = None
    with pytest.raises(ValueError, match="released"):
        pipe.dispatch_wave([b"next"], chain=h1)


def test_fused_collect_ready_partial_rows_keep_handle_chainable():
    """collect_ready copies only the requested (commit-ready) rows; the
    handle's digest words stay on the device, still feed a chained
    follow-up wave, and a later full collect yields everything."""
    pipe = _pipe(n_slots=4, n_digest_slots=1, kernel="scan")
    msgs = [b"ready-%d" % i for i in range(6)]
    expect = [hashlib.sha256(m).digest() for m in msgs]
    h = pipe.dispatch_wave(msgs)
    part = pipe.collect_ready(h, [4, 1])
    assert part.digests == [expect[4], expect[1]]  # result follows ``rows``
    assert h.lease is None  # pooled packing slab returned
    assert h.words is not None  # the wave's digests never left the device
    # The partially-collected handle still chains the next wave's gate.
    quorum = [(2, [(0, 0, 0, expect[0])])]
    h2 = pipe.dispatch_wave([b"ready-follow"], quorum=quorum, chain=h)
    res2 = pipe.collect(h2)
    masks0, counts0 = _fresh_states(4, 1)
    _, _, _, _, rp, rn = host_fused_reference(
        [b"ready-follow"], None, quorum, masks0, counts0,
        prev_digests=expect, prev_rows=h.rows,
    )
    assert (res2.posts[:1] == rp[:1]).all()
    assert (res2.newbits[:1] == rn[:1]).all()
    assert pipe.collect_ready(h, []).digests == []
    full = pipe.collect(h)
    assert full.digests == expect
    with pytest.raises(ValueError, match="outside"):
        pipe.collect_ready(h, [len(msgs)])
    assert metrics.snapshot().get("fused_partial_collects", 0) >= 2


# ---------------------------------------------------------------------------
# The port against the JAX pipeline on one shared set of waves.
# ---------------------------------------------------------------------------

SHARED_SLOTS, SHARED_DIGEST_SLOTS = 8, 2


def _shared_waves():
    """Two waves and a partial collect: wave 1 unsigned, its quorum stream
    gated on its own rows, with an out-of-range slot, source 300, source -1
    and a (slot, digest) touched twice; wave 2 chained on wave 1, with
    signed rows (one forged) and gates on both waves' rows."""
    msgs1 = [b"shared-a-%d" % i + b"q" * (i * 23 % 150) for i in range(20)]
    msgs2 = [b"shared-b-%d" % i + b"r" * (i * 41 % 130) for i in range(9)]
    d1 = [hashlib.sha256(m).digest() for m in msgs1]
    d2 = [hashlib.sha256(m).digest() for m in msgs2]
    quorum1 = [
        (4, [(0, 0, 3, d1[3]), (1, 1, None, None), (1, 1, None, None)]),
        (300, [(0, 0, None, None), (2, 1, 7, d1[7])]),
        (-1, [(SHARED_SLOTS + 2, 0, None, None), (3, 1, 5, d1[6])]),
        (37, [(-1, 1, 19, d1[19]), (5, 0, 25, b"\x00" * 32)]),
        (4, [(0, 0, 3, d1[3])]),
    ]
    pub, sign = keypair_from_seed(b"\x05" * 32)
    payloads = [b"shared-payload-%d" % i for i in range(3)]
    sigs = [sign(m) for m in payloads]
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 4]) + sigs[2][41:]
    signed = ([pub] * 3, payloads, sigs)

    def quorum2(rows1):
        return [
            (9, [(0, 0, 3, d1[3]), (6, 1, rows1 + 2, d2[2])]),
            (10, [(6, 1, rows1 + 2, d2[3]), (7, 0, 11, d1[11])]),
            (255, [(7, 0, rows1 - 1, b"\x00" * 32)]),  # a padding row of wave 1
        ]

    return msgs1, msgs2, quorum1, quorum2, signed


def _run_shared(pipe, to_np):
    msgs1, msgs2, quorum1, quorum2, signed = _shared_waves()
    h1 = pipe.dispatch_wave(msgs1, quorum=quorum1)
    # Wave 2 through ``pack`` then ``dispatch_wave(packed=)``, as the hash
    # plane drives it; the port's wave is staged, the JAX one host-packed.
    packed2 = pipe.hasher.pack(msgs2)
    h2 = pipe.dispatch_wave([], signed=signed, quorum=quorum2(h1.rows), chain=h1,
                            packed=packed2)
    out = {"rows": (h1.rows, h2.rows),
           "staged": {name: section[2] for name, section in
                      getattr(packed2, "sections", {}).items()}}
    r2 = pipe.collect(h2)
    part = pipe.collect_ready(h1, [19, 0, 7])
    r1 = pipe.collect(h1)
    for name, res in (("wave1", r1), ("wave2", r2), ("ready", part)):
        out[name] = (res.digests, np.asarray(res.verdicts), to_np(res.posts), to_np(res.newbits))
    out["state"] = tuple(np.asarray(a) for a in pipe.quorum_state())
    return out


@pytest.fixture(scope="module")
def shared_runs():
    ref = RefPipeline(n_slots=SHARED_SLOTS, n_digest_slots=SHARED_DIGEST_SLOTS)
    port = _pipe(n_slots=SHARED_SLOTS, n_digest_slots=SHARED_DIGEST_SLOTS)
    return _run_shared(ref, np.asarray), _run_shared(port, np.asarray)


@pytest.mark.parametrize("wave", ["wave1", "wave2", "ready"])
@pytest.mark.parametrize("field", ["digests", "verdicts", "posts", "newbits"])
def test_port_pipeline_equals_jax_pipeline(shared_runs, wave, field):
    ref, port = shared_runs
    assert port["rows"] == ref["rows"]
    i = ("digests", "verdicts", "posts", "newbits").index(field)
    want, got = ref[wave][i], port[wave][i]
    if field == "digests":
        assert got == want
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_port_fused_wave_crosses_in_one_staged_buffer(shared_runs):
    """The port's chained signed wave was staged whole: its raw bytes and
    row index, the verify inputs, the quorum stream, the row groups (no
    dummy row: it is chained) in one buffer, one copy; the JAX wave was
    packed on the host."""
    ref, port = shared_runs
    assert ref["staged"] == {}
    staged = port["staged"]
    msgs2, quorum2 = _shared_waves()[1], _shared_waves()[3](port["rows"][0])
    assert list(staged) == ["raw", "offsets", "lengths", "ax", "ay", "r_bytes", "s_bits",
                            "h_bits", "sources", "touches", "valid", "digest_rows", "claimed",
                            "touch_groups", "row_groups"]
    assert staged["raw"] == (sum(map(len, msgs2)),) and staged["lengths"] == (len(msgs2),)
    # Three signed rows and three quorum waves, each padded to four.
    assert staged["ax"] == (4, 32) and staged["touches"] == (4, 8, 2) and len(quorum2) == 3
    assert staged["row_groups"] == (port["rows"][0] + port["rows"][1],)


def test_port_quorum_state_equals_jax_pipeline(shared_runs):
    ref, port = shared_runs
    for got, want in zip(port["state"], ref["state"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # The streams reached what the numpy oracle cannot: a doubled touch
    # (post 2 from one source) and source 300's count without its bit.
    posts1, newbits1 = port["wave1"][2], port["wave1"][3]
    assert newbits1[0, 1] and newbits1[0, 2] and posts1[0, 2] == 2
    assert port["wave2"][1].tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# Fused Recordings against the JAX package's.
# ---------------------------------------------------------------------------


def _fingerprint(spec, registry):
    registry.default_registry.reset()
    recording = spec.recorder().recording()
    steps = recording.drain_clients(timeout=200_000)
    finals = sorted(
        (node.state.checkpoint_seq_no, node.state.checkpoint_hash)
        for node in recording.nodes
    )
    return steps, finals, registry.snapshot()


ENGINE_CASES = {
    "unsigned": (
        dict(node_count=4, client_count=4, reqs_per_client=20, batch_size=5),
        dict(device=True, hash_wave=4, hash_floor=1, fused=True, defer_unready=False),
    ),
    "signed": (
        dict(node_count=4, client_count=2, reqs_per_client=10, batch_size=5,
             signed_requests=True),
        # auth_wave above the traffic: the signatures drain via fused waves.
        dict(device=True, hash_wave=4, hash_floor=1, auth_wave=64, auth_floor=4,
             lookahead=16, fused=True, defer_unready=False),
    ),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_fused_engine_equals_jax_fused_engine(case):
    shape, plane = ENGINE_CASES[case]
    ref_steps, ref_finals, ref_snap = _fingerprint(
        RefSpec(**shape, crypto=RefCryptoConfig(**plane)), ref_metrics
    )
    steps, finals, snap = _fingerprint(
        Spec(**shape, crypto=CryptoConfig(**plane, torch_device="cpu")), metrics
    )
    assert (steps, finals) == (ref_steps, ref_finals)
    assert snap.get("fused_wave_dispatches", 0) > 0
    assert snap.get("fused_wave_messages", 0) > 0
    if case == "signed":
        # Every signature was verified by a device wave, as in the JAX
        # package's run.
        assert snap.get("device_verified_signatures", 0) == 20
        assert ref_snap.get("device_verified_signatures", 0) == 20


def test_partial_then_full_collect_harvests_verdicts_once():
    """A fused wave that carries signatures and is collected in two parts
    (the hash plane's partial collect, then the rest) writes its verdicts
    into the auth plane exactly once; a client removed meanwhile gets no
    memo entry."""
    from mirbft_tpu_torch.testengine.crypto import DeviceHashPlane

    pub, sign = keypair_from_seed(b"\x07" * 32)
    memo = []

    class Auth:
        """The surface of DeviceAuthPlane that the fused plane uses."""

        keys = {7: pub}
        verified_count = 0

        def take_pending(self):
            items = [(7, 1, b"env-a"), (9, 1, b"env-b")]
            keys = [(c, r, id(e)) for c, r, e in items]
            return keys, items, ([pub, pub], [b"a", b"b"], [sign(b"a"), sign(b"b")])

        def _memo_put(self, key, envelope, verdict):
            memo.append((key[0], envelope, verdict))

    auth = Auth()
    plane = DeviceHashPlane(device=True, wave_size=1000, device_floor=1000,
                            kernel="scan", torch_device="cpu")
    plane.attach_fused(_pipe(n_slots=4, n_digest_slots=1, kernel="scan"), auth)
    batches = [[b"part-%d" % i, b"x" * i] for i in range(6)]
    expect = [hashlib.sha256(b"".join(p)).digest() for p in batches]
    plane.enqueue(batches)
    assert plane.launch_partial()
    assert plane.hash_batches(batches[:2]) == expect[:2]
    assert metrics.snapshot().get("fused_partial_collects", 0) == 1
    assert plane.hash_batches(batches) == expect
    assert auth.verified_count == 2
    assert memo == [(7, b"env-a", True)]
