"""The port's shared cross-group wave mux against the JAX package's, on the CPU.

The seven cases of ``tests/test_wave_mux.py`` on the port: its
``SharedWaveMux`` over a multi-tenant ``FusedCryptoPipeline`` with
``device="cpu"`` (the kernels' plain PyTorch twins).  Mixed-group waves must
give hashlib's digests, the host oracle's quorum state and per-group
verdicts; gates and forged signatures stay in their tenant; pooled leases
come back once a shared wave; the wave controller's per-group floor holds;
and two co-hosted Recordings, interleaved step for step, take the steps and
reach the final states of the JAX package's mux run on the same specs.
"""

import hashlib

import numpy as np
import pytest
import torch

from mirbft_tpu import metrics as ref_metrics
from mirbft_tpu.ops.fused import FusedCryptoPipeline as RefPipeline
from mirbft_tpu.testengine import CryptoConfig as RefCryptoConfig
from mirbft_tpu.testengine import Spec as RefSpec
from mirbft_tpu.testengine.crypto import SharedWaveMux as RefMux
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.ops.ed25519 import keypair_from_seed
from mirbft_tpu_torch.ops.fused import FusedCryptoPipeline, host_fused_reference
from mirbft_tpu_torch.processor.verify import seal, signing_payload
from mirbft_tpu_torch.testengine import CryptoConfig, DeviceAuthPlane, Spec
from mirbft_tpu_torch.testengine.crypto import (
    DeviceHashPlane,
    SharedWaveMux,
    WaveController,
)

# SHA-256 padding boundaries (see tests/test_fused_wave.py).
BOUNDARY_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 183, 184, 247, 248)
DEVICE = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # The twins run many small ops: under several test workers the intra-op
    # pools oversubscribe the cores (see tests/test_torch_recording.py).
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


def _mux_pair(wave_size, n_groups=2, kernel="scan", auth=None, **pipe_kw):
    """A multi-tenant pipeline, its mux, and one attached plane per group."""
    pipe = FusedCryptoPipeline(kernel=kernel, n_groups=n_groups, device=DEVICE, **pipe_kw)
    mux = SharedWaveMux(pipe, wave_size=wave_size, adaptive=False)
    planes = []
    for g in range(n_groups):
        plane = DeviceHashPlane(
            device=True, wave_size=wave_size, device_floor=1, kernel=kernel,
            torch_device=DEVICE,
        )
        plane.attach_mux(mux, g, auth[g] if auth else None)
        planes.append(plane)
    return pipe, mux, planes


def _digest(parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.digest()


def test_mux_mixed_group_digest_parity_boundary_lengths():
    """Two tenants' rows at every padding boundary ride shared waves; the
    second tenant's enqueue crosses the aggregate threshold and launches
    for both; each tenant's digests equal hashlib's."""
    pipe, mux, planes = _mux_pair(wave_size=2 * len(BOUNDARY_LENGTHS))
    batches = []
    for g in range(2):
        rows = []
        for length in BOUNDARY_LENGTHS:
            msg = bytes([65 + g]) * length
            rows.append([msg[: length // 2], msg[length // 2 :]])
        batches.append(rows)

    planes[0].enqueue(batches[0])
    assert planes[0].pending_count() == len(BOUNDARY_LENGTHS)
    planes[1].enqueue(batches[1])
    assert planes[0].pending_count() == 0
    assert planes[1].pending_count() == 0
    assert metrics.gauge("wave_mux_groups_per_wave").value == 2
    assert metrics.gauge("fused_wave_occupancy").value > 0

    for g, plane in enumerate(planes):
        assert plane.hash_batches(batches[g]) == [_digest(parts) for parts in batches[g]]
    for plane in planes:
        assert not plane._inflight
    # Lengths <= 247 bucket together, 248 overflows to the next bucket: two
    # shared waves, each lease back once.
    assert sum(len(v) for v in pipe.hasher._pool._free.values()) == 2


def test_pipeline_multigroup_quorum_digest_gating_parity():
    """Group-tagged rows and quorum slabs on one wave equal the host oracle,
    and a gate on another tenant's row stays closed with the right claim."""
    n_slots, n_digest_slots = 8, 2
    pipe = FusedCryptoPipeline(
        n_slots=n_slots, n_digest_slots=n_digest_slots, kernel="scan", n_groups=2,
        device=DEVICE,
    )
    msgs = [b"mux-%d" % i + b"q" * (i * 31 % 200) for i in range(8)]
    groups = [0, 1, 0, 1, 0, 1, 0, 1]
    claim2 = hashlib.sha256(msgs[2]).digest()
    claim3 = hashlib.sha256(msgs[3]).digest()
    quorum = [
        (0, 5, [(0, 0, 2, claim2)]),
        (1, 5, [(0, 0, 3, claim3)]),
        (1, 6, [(1, 0, 2, claim2)]),  # right digest, wrong tenant: closed
        (0, 6, [(1, 1, 4, b"\xff" * 32)]),
        (0, 7, [(2, 0, None, None)]),
    ]
    res = pipe.collect(pipe.dispatch_wave(msgs, quorum=quorum, groups=groups))
    masks0 = np.zeros((2 * n_slots, n_digest_slots, 8), dtype=np.uint32)
    counts0 = np.zeros((2 * n_slots, n_digest_slots), dtype=np.int32)
    rd, _rv, rm, rc, rp, rn = host_fused_reference(
        msgs, None, quorum, masks0, counts0, groups=groups, n_slots=n_slots
    )
    assert res.digests == rd
    dm, dc = pipe.quorum_state()
    assert (dm == rm).all()
    assert (dc == rc).all()
    nq = len(quorum)
    assert (res.posts[:nq] == rp[:nq]).all()
    assert (res.newbits[:nq] == rn[:nq]).all()
    assert dc[0 * n_slots + 0, 0] == 1
    assert dc[1 * n_slots + 0, 0] == 1
    assert dc[1 * n_slots + 1, 0] == 0


def test_mux_forged_signature_isolated_per_group():
    """Both tenants' signatures ride one shared wave's verify stage (one
    twin call); a forgery in group 0's slice flips only that row, and both
    harvests come from the wave, not a host re-verify."""
    pub0, sign0 = keypair_from_seed(b"\x03" * 32)
    pub1, sign1 = keypair_from_seed(b"\x04" * 32)

    def envelopes(cid, sign, n, forge=()):
        out = []
        for i in range(n):
            payload = b"req-%d-%d" % (cid, i)
            sig = b"\x00" * 64 if i in forge else sign(signing_payload(cid, i, payload))
            out.append(seal(payload, sig))
        return out

    envs0 = envelopes(7, sign0, 4, forge=(2,))
    envs1 = envelopes(9, sign1, 3)
    chunks = {(7, 0): list(enumerate(envs0)), (9, 0): list(enumerate(envs1))}

    def provider(client_id, start_req):
        return chunks.get((client_id, start_req), [])

    auths = []
    for cid, pub in ((7, pub0), (9, pub1)):
        auth = DeviceAuthPlane(
            provider, device=True, wave_size=64, device_floor=64, lookahead=8,
            torch_device=DEVICE,
        )
        auth.register(cid, pub)
        auths.append(auth)
    auth0, auth1 = auths
    pipe, mux, planes = _mux_pair(wave_size=4, auth=(auth0, auth1))

    auth0.note(7, 0)
    auth1.note(9, 0)
    hash_batches = [[[b"h%d" % g, bytes([g]) * 600]] for g in range(2)]
    for g in range(2):
        planes[g].enqueue(hash_batches[g])
    mux.launch()
    for g in range(2):
        assert planes[g].hash_batches(hash_batches[g]) == [_digest(hash_batches[g][0])]
    assert auth0.verified_count == 4
    assert auth1.verified_count == 3
    assert [auth0.authenticate(7, i, envs0[i]) for i in range(4)] == [True, True, False, True]
    assert all(auth1.authenticate(9, i, envs1[i]) for i in range(3))
    assert auth0.verified_count == 4
    assert auth1.verified_count == 3


def test_mux_partial_collect_lease_discipline_across_waves():
    """A partial collect returns the shared wave's lease once while its
    words stay for the other tenant; later waves reuse the pool."""
    pipe, mux, planes = _mux_pair(wave_size=8)

    def round_batches(tag):
        return [
            [[b"%s-%d-%d" % (tag, g, i), bytes([g + 1]) * 520] for i in range(4)]
            for g in range(2)
        ]

    first = round_batches(b"r0")
    planes[0].enqueue(first[0])
    planes[1].enqueue(first[1])
    sub0 = planes[0]._inflight[0][2]
    sub1 = planes[1]._inflight[0][2]
    assert sub0.wave is sub1.wave

    part = mux.collect_ready(sub0, [0])
    assert part.digests == [_digest(first[0][0])]
    assert sub0.wave.lease is None
    assert sub0.wave.words is not None

    assert planes[1].hash_batches(first[1]) == [_digest(p) for p in first[1]]
    assert planes[0].hash_batches(first[0]) == [_digest(p) for p in first[0]]
    free_counts = {k: len(v) for k, v in pipe.hasher._pool._free.items() if v}
    assert sum(free_counts.values()) == 1

    for tag in (b"r1", b"r2"):
        batches = round_batches(tag)
        planes[0].enqueue(batches[0])
        planes[1].enqueue(batches[1])
        for g in range(2):
            assert planes[g].hash_batches(batches[g]) == [_digest(p) for p in batches[g]]
    assert {k: len(v) for k, v in pipe.hasher._pool._free.items() if v} == free_counts
    for plane in planes:
        assert not plane._inflight
        assert not plane._issued


def test_wave_controller_group_floor_blocks_idle_shrink_starvation():
    wc = WaveController(initial=256, floor=16, ceiling=512, group_floor=64)
    assert wc.effective_floor(1) == 64
    assert wc.effective_floor(3) == 192
    size = 256
    for _ in range(4):
        size = wc.observe(10, 8, 8e-5, active_groups=3)
    assert size == 192
    for _ in range(8):
        size = wc.observe(10, 8, 8e-5, active_groups=3)
    assert size == 192
    for _ in range(4):
        size = wc.observe(10, 8, 8e-5, active_groups=1)
    assert size == 96
    wc2 = WaveController(initial=256, floor=16, ceiling=512, group_floor=64)
    wc2.observe(256, 256, 256e-5, active_groups=3)
    assert wc2.observe(600, 128, 128 * 5e-5, active_groups=3) == 192


def test_wave_controller_group_floor_zero_keeps_legacy_trajectory():
    legacy = WaveController(initial=64, floor=16, ceiling=512)
    tagged = WaveController(initial=64, floor=16, ceiling=512, group_floor=0)
    trace = [
        (200, 64, 64e-5), (600, 128, 128e-5), (10, 8, 8e-5),
        (10, 8, 8e-5), (10, 8, 8e-5), (10, 8, 8e-5), (2000, 128, 128e-5),
    ]
    for depth, n, secs in trace:
        assert legacy.observe(depth, n, secs) == tagged.observe(
            depth, n, secs, active_groups=4
        )


def _final_states(recording):
    return sorted(
        (node.state.checkpoint_seq_no, node.state.checkpoint_hash)
        for node in recording.nodes
    )


def _drain_interleaved(recordings, timeout=200_000):
    """Round-robin ``step()`` across co-hosted recordings until each meets
    drain_clients' completion condition; per-recording step counts."""

    def done(rec):
        target_reqs = {
            c.config.id: 0 if c.config.corrupt else c.config.total
            for c in rec.clients.values()
        }
        for node in rec.nodes:
            for client_state in node.state.checkpoint_state.clients:
                target = target_reqs.get(client_state.id)
                if target is not None and target != client_state.low_watermark:
                    return False
        finished = {
            cid
            for cid, total in target_reqs.items()
            if total == 0
            or any(node.state.committed_reqs.get(cid, 0) >= total for node in rec.nodes)
        }
        return finished >= set(target_reqs)

    steps = [0] * len(recordings)
    finished = [False] * len(recordings)
    while not all(finished):
        for k, rec in enumerate(recordings):
            if finished[k]:
                continue
            steps[k] += 1
            rec.step()
            if done(rec):
                finished[k] = True
            assert steps[k] <= timeout, "interleaved drain stalled"
    return steps


SPEC0 = dict(node_count=4, client_count=2, reqs_per_client=8, batch_size=4,
             signed_requests=True)
SPEC1 = dict(node_count=4, client_count=3, reqs_per_client=5, batch_size=5)
MUX_PLANE = dict(device=True, hash_wave=4, hash_floor=1, kernel="scan",
                 defer_unready=False, auth_wave=64, auth_floor=4, lookahead=16)


def _mux_run(spec_cls, crypto_cls, registry, mux, **plane):
    registry.default_registry.reset()
    recordings = [
        spec_cls(**base, crypto=crypto_cls(**MUX_PLANE, **plane, mux=mux, mux_group=g))
        .recorder().recording()
        for g, base in enumerate((SPEC0, SPEC1))
    ]
    steps = _drain_interleaved(recordings)
    return steps, [_final_states(r) for r in recordings], registry.snapshot()


def test_mux_two_group_engine_differential():
    """Two co-hosted groups (one signed) share one mux and run interleaved:
    the port's steps and final states equal its solo runs' and the JAX
    package's mux run on the same specs, with both tenants on the waves."""
    solo = []
    for base in (SPEC0, SPEC1):
        metrics.default_registry.reset()
        recording = Spec(**base).recorder().recording()
        solo.append((recording.drain_clients(timeout=200_000), _final_states(recording)))

    ref_steps, ref_finals, ref_snap = _mux_run(
        RefSpec, RefCryptoConfig, ref_metrics,
        RefMux(RefPipeline(kernel="scan", n_groups=2), wave_size=8, adaptive=False),
    )
    pipe = FusedCryptoPipeline(kernel="scan", n_groups=2, device=DEVICE)
    steps, finals, snap = _mux_run(
        Spec, CryptoConfig, metrics, SharedWaveMux(pipe, wave_size=8, adaptive=False),
        torch_device=DEVICE,
    )
    assert steps == ref_steps == [s for s, _ in solo]
    assert finals == ref_finals == [f for _, f in solo]
    for s in (snap, ref_snap):
        assert s.get("fused_wave_dispatches", 0) > 0
        assert s.get('wave_mux_rows_total{group="0"}', 0) > 0
        assert s.get('wave_mux_rows_total{group="1"}', 0) > 0
    assert snap["fused_wave_dispatches"] == ref_snap["fused_wave_dispatches"]
