"""The port's Recording against the JAX package's, on the CPU.

A 4-node Spec runs through both packages with the device hash plane on
(the port's plane on its plain PyTorch twins, the reference's on the JAX
scan program) and blocking collects (``defer_unready=False``), so wave
grouping cannot touch the simulated schedule: both must take the same
number of steps and end with the same per-node (checkpoint seq, checkpoint
hash), and so must the port's host-path run; so must the port's fused
Recording and the JAX package's.  The parts later slices port (the shared
wave mux, mesh sharding) raise ``NotImplementedError``.
"""

import pytest
import torch

from mirbft_tpu import metrics as ref_metrics
from mirbft_tpu.testengine import CryptoConfig as RefCryptoConfig
from mirbft_tpu.testengine import Spec as RefSpec
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.ops.ed25519 import Ed25519BatchVerifier
from mirbft_tpu_torch.testengine import CryptoConfig, DeviceAuthPlane, Spec

BASE = dict(node_count=4, client_count=4, reqs_per_client=20, batch_size=5)
PLANE = dict(device=True, hash_wave=4, hash_floor=1, defer_unready=False)
# Signed: 16 envelopes, verified as one wave of 16 rows.  Client 0's
# corrupt signatures at requests 1 and 2 have S < L, so they pass the host
# screen and the kernel's twin rejects them.
SIGNED = dict(node_count=4, client_count=4, reqs_per_client=4, batch_size=2,
              signed_requests=True)
SIGNED_PLANE = dict(PLANE, auth_wave=16, auth_floor=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # The twins run many small ops; under several test workers, each with a
    # pool of intra-op threads, the pools oversubscribe the cores and the
    # ops slow down tenfold or more.
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


def _fingerprint(spec, registry, committed=None):
    registry.default_registry.reset()
    recording = spec.recorder().recording()
    steps = recording.drain_clients(timeout=200_000)
    finals = sorted(
        (node.state.checkpoint_seq_no, node.state.checkpoint_hash)
        for node in recording.nodes
    )
    if committed is not None:
        committed.extend(dict(node.state.committed_reqs) for node in recording.nodes)
    return steps, finals, registry.snapshot()


def _corrupt_client_0(recorder):
    recorder.client_configs[0].corrupt = True


@pytest.fixture(scope="module")
def reference_run():
    return _fingerprint(RefSpec(**BASE, crypto=RefCryptoConfig(**PLANE)), ref_metrics)


def test_device_run_matches_reference_and_engages(reference_run):
    ref_steps, ref_finals, _ = reference_run
    steps, finals, snap = _fingerprint(
        Spec(**BASE, crypto=CryptoConfig(**PLANE, torch_device="cpu")), metrics
    )
    assert steps == ref_steps
    assert finals == ref_finals
    assert snap.get("device_hash_dispatches", 0) > 0
    assert snap.get("device_hashed_messages", 0) > 0
    # Every 4-block multi-part digest went through the plane; request-body
    # digests take the designed host fast path.
    assert snap.get("host_hashed_fast_messages", 0) > 0


def test_host_path_run_matches_reference(reference_run):
    ref_steps, ref_finals, _ = reference_run
    steps, finals, snap = _fingerprint(Spec(**BASE), metrics)
    assert (steps, finals) == (ref_steps, ref_finals)
    assert snap.get("device_hash_dispatches", 0) == 0


@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "corrupt"])
def test_signed_runs_match_reference(corrupt, monkeypatch):
    tweak = _corrupt_client_0 if corrupt else None
    ref_steps, ref_finals, _ = _fingerprint(
        RefSpec(**SIGNED, tweak_recorder=tweak), ref_metrics
    )
    host = _fingerprint(Spec(**SIGNED, tweak_recorder=tweak), metrics)
    assert host[:2] == (ref_steps, ref_finals)
    assert host[2].get("device_verify_dispatches", 0) == 0

    verdicts = []
    real_collect = Ed25519BatchVerifier.collect

    def collect(self, handle):
        out = real_collect(self, handle)
        verdicts.append((handle.valid[: handle.count], handle.ok.numpy()[: handle.count]))
        return out

    monkeypatch.setattr(Ed25519BatchVerifier, "collect", collect)
    committed = []
    steps, finals, snap = _fingerprint(
        Spec(**SIGNED, tweak_recorder=tweak,
             crypto=CryptoConfig(**SIGNED_PLANE, torch_device="cpu")),
        metrics,
        committed,
    )
    assert (steps, finals) == (ref_steps, ref_finals)
    assert snap.get("device_verify_dispatches", 0) == 1
    assert snap.get("device_verified_signatures", 0) == 16
    live = {0: 0 if corrupt else 4, 1: 4, 2: 4, 3: 4}
    for reqs in committed:
        assert {c: reqs.get(c, 0) for c in live} == live
    # Rows that passed the host screens and that the twin rejected.
    rejected = sum(int((valid & ~ok).sum()) for valid, ok in verdicts)
    assert rejected == (2 if corrupt else 0)


def test_auth_plane_asks_for_the_card_only_on_the_device_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = DeviceAuthPlane(lambda client, req: [], device=False)
    assert host.verifier.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceAuthPlane(lambda client, req: [], device=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DeviceAuthPlane(lambda client, req: [], mesh_devices=2, torch_device="cpu")


def test_fused_run_matches_reference_fused_run(reference_run):
    """CryptoConfig(fused=True): the port's FusedCryptoPipeline on the
    twins against the JAX package's fused Recording (and so the host path's
    steps and checkpoints), with fused waves carrying the traffic."""
    ref_steps, ref_finals, ref_snap = _fingerprint(
        RefSpec(**BASE, crypto=RefCryptoConfig(**PLANE, fused=True)), ref_metrics
    )
    steps, finals, snap = _fingerprint(
        Spec(**BASE, crypto=CryptoConfig(**PLANE, torch_device="cpu", fused=True)), metrics
    )
    assert (steps, finals) == (ref_steps, ref_finals) == reference_run[:2]
    assert ref_snap.get("fused_wave_dispatches", 0) > 0
    assert snap.get("fused_wave_dispatches", 0) > 0
    assert snap.get("fused_wave_messages", 0) > 0
    assert snap.get("device_hash_dispatches", 0) == snap["fused_wave_dispatches"]


@pytest.mark.parametrize(
    "spec_kw",
    [
        dict(crypto=CryptoConfig(**PLANE, torch_device="cpu", mux=object())),
        dict(crypto=CryptoConfig(**PLANE, torch_device="cpu", mesh_devices=2)),
    ],
    ids=["mux", "mesh"],
)
def test_later_slices_raise_naming_the_roadmap(spec_kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Spec(**BASE, **spec_kw).recorder().recording()
