"""The port's Recording against the JAX package's, on the CPU.

A 4-node Spec runs through both packages with the device hash plane on
(the port's plane on its plain PyTorch twins, the reference's on the JAX
scan program) and blocking collects (``defer_unready=False``), so wave
grouping cannot touch the simulated schedule: both must take the same
number of steps and end with the same per-node (checkpoint seq, checkpoint
hash), and so must the port's host-path run.  The parts later slices port
raise ``NotImplementedError``.
"""

import pytest

from mirbft_tpu import metrics as ref_metrics
from mirbft_tpu.testengine import CryptoConfig as RefCryptoConfig
from mirbft_tpu.testengine import Spec as RefSpec
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.testengine import CryptoConfig, Spec

BASE = dict(node_count=4, client_count=4, reqs_per_client=20, batch_size=5)
PLANE = dict(device=True, hash_wave=4, hash_floor=1, defer_unready=False)


@pytest.fixture(autouse=True)
def _reset_port_observability():
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


def _fingerprint(spec, registry):
    registry.default_registry.reset()
    recording = spec.recorder().recording()
    steps = recording.drain_clients(timeout=200_000)
    finals = sorted(
        (node.state.checkpoint_seq_no, node.state.checkpoint_hash)
        for node in recording.nodes
    )
    return steps, finals, registry.snapshot()


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


@pytest.mark.parametrize(
    "spec_kw",
    [
        dict(signed_requests=True),
        dict(crypto=CryptoConfig(**PLANE, torch_device="cpu", fused=True)),
        dict(crypto=CryptoConfig(**PLANE, torch_device="cpu", mux=object())),
        dict(crypto=CryptoConfig(**PLANE, torch_device="cpu", mesh_devices=2)),
    ],
    ids=["signed", "fused", "mux", "mesh"],
)
def test_later_slices_raise_naming_the_roadmap(spec_kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Spec(**BASE, **spec_kw).recorder().recording()
