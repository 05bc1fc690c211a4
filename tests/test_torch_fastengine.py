"""The port's native fast engine against the JAX package's, on the CPU.

``mirbft_tpu_torch.testengine.FastRecording`` runs the same C++ engine as
the reference (its ``_native/fastengine.cpp`` is a copy, pinned by
``tests/test_torch_copies.py``) behind the port's device hooks: the hash
mirror, the authoritative hashing and the Ed25519 verdict waves run on the
port's ``TorchHasher`` and ``Ed25519BatchVerifier``, here on their plain
PyTorch twins (``torch_device="cpu"``).  Every case holds the port's run to
the port's Python ``Recording`` or to the reference's ``FastRecording`` on
the same Spec: steps, fake time and per-node (checkpoint, epoch, active
hash, committed requests).

The port's ``_fast.so`` builds with g++ on first use (~35 s); the module
fixture takes a lock on the source first, so that test workers which start
together build it once.
"""

from __future__ import annotations

import dataclasses
import fcntl

import pytest
import torch

from mirbft_tpu import _native as ref_native
from mirbft_tpu.testengine import Spec as RefSpec
from mirbft_tpu.testengine.fastengine import FastRecording as RefFastRecording
from mirbft_tpu_torch import _native, metrics, tracing
from mirbft_tpu_torch.processor.pipeline import PipelineConfig
from mirbft_tpu_torch.testengine import (
    CryptoConfig,
    FastEngineUnsupported,
    FastRecording,
    For,
    Spec,
    matching,
)

TIMEOUT = 10_000_000


@pytest.fixture(scope="module", autouse=True)
def _engines_built():
    # One intra-op thread: the twins run many small ops, and under several
    # test workers the default pools oversubscribe the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with open(_native._FAST_SRC, "rb") as source:
        fcntl.flock(source, fcntl.LOCK_EX)
        port = _native.load_fast()
    assert port is not None, "g++ could not build mirbft_tpu_torch/_native/_fast.so"
    assert ref_native.load_fast() is not None
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_port_observability():
    # tests/conftest.py resets the JAX package's registry only.
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


def _summary(nodes):
    return [
        (
            n.checkpoint_seq_no,
            n.checkpoint_hash,
            n.epoch,
            n.last_seq_no,
            n.active_hash_digest,
            dict(n.committed_reqs),
        )
        for n in nodes
    ]


def _fast_run(cls, spec, **kwargs):
    fr = cls(spec, **kwargs)
    steps = fr.drain_clients(timeout=TIMEOUT)
    return steps, fr.stats()[1], _summary(fr.nodes)


def _port_fast(spec, **kwargs):
    return _fast_run(FastRecording, spec, torch_device="cpu", **kwargs)


def _ref_fast(spec, **kwargs):
    return _fast_run(RefFastRecording, _as_reference(spec), **kwargs)


def _as_reference(spec):
    assert spec.crypto is None and spec.pipeline is None
    return RefSpec(
        node_count=spec.node_count,
        client_count=spec.client_count,
        reqs_per_client=spec.reqs_per_client,
        batch_size=spec.batch_size,
        signed_requests=spec.signed_requests,
        tweak_recorder=spec.tweak_recorder,
    )


def _python_run(spec):
    rec = spec.recorder().recording()
    steps = rec.drain_clients(timeout=TIMEOUT)
    state = [
        (
            n.state.checkpoint_seq_no,
            n.state.checkpoint_hash,
            n.state_machine.epoch_tracker.current_epoch.number,
            n.state.last_seq_no,
            n.state.active_hash.digest(),
            dict(n.state.committed_reqs),
        )
        for n in rec.nodes
    ]
    return steps, rec.event_queue.fake_time, state


def _corrupt_client_1(recorder):
    recorder.client_configs[1].corrupt = True


def test_both_engines_load_under_their_own_names():
    assert _native.fast.__name__ == "mirbft_tpu_torch._native._fast"
    assert ref_native.fast.__name__ == "mirbft_tpu._native._fast"
    assert _native.fast.FastEngine is not ref_native.fast.FastEngine
    assert _native.fast.FastEngine.__module__ == "mirbft_tpu_torch._native._fast"


# A subset of tests/test_fastengine.py's DIFFERENTIAL_SPECS, the signed
# spec included.
DIFFERENTIAL_SPECS = [
    Spec(node_count=1, client_count=1, reqs_per_client=3, batch_size=1),
    Spec(node_count=4, client_count=4, reqs_per_client=20, batch_size=5),
    Spec(node_count=7, client_count=3, reqs_per_client=50, batch_size=10),
    Spec(
        node_count=16,
        client_count=16,
        reqs_per_client=10,
        batch_size=100,
        signed_requests=True,
    ),
]


@pytest.mark.parametrize(
    "spec",
    DIFFERENTIAL_SPECS,
    ids=lambda s: f"n{s.node_count}c{s.client_count}r{s.reqs_per_client}"
    f"b{s.batch_size}{'s' if s.signed_requests else ''}",
)
def test_bit_identical_to_python_engine_and_reference(spec):
    """Host path: the port's FastRecording, the port's Recording and the
    reference's FastRecording agree.  Unsigned specs also run the device
    hash mirror on the twins (every device digest checked against the
    engine's); the signed spec's verdict waves are
    test_byzantine_signer_rejected's."""
    fast = _port_fast(spec)
    assert fast == _python_run(spec)
    assert fast == _ref_fast(spec)
    if not spec.signed_requests:
        assert _port_fast(spec, device=True) == fast
        assert metrics.counter("device_hash_dispatches").value > 0


def test_deterministic_across_runs():
    spec = Spec(node_count=4, client_count=4, reqs_per_client=50, batch_size=10)
    assert _port_fast(spec) == _port_fast(spec)


def test_byzantine_signer_rejected():
    """A corrupt signer's requests never commit: its verdicts come from
    one verify wave of the device path (the twin), and the run equals the
    port's Recording and the reference's host-path FastRecording."""
    spec = Spec(
        node_count=4,
        client_count=2,
        reqs_per_client=5,
        batch_size=2,
        signed_requests=True,
        tweak_recorder=_corrupt_client_1,
    )
    fast = _port_fast(spec, device=True)
    assert metrics.counter("device_verify_dispatches").value == 1
    assert metrics.counter("device_verified_signatures").value == 10
    assert fast == _python_run(spec)
    assert fast == _ref_fast(spec)
    for committed in (node[5] for node in fast[2]):
        assert committed.get(1, 0) == 0  # byzantine client never commits
        assert committed.get(0, 0) == 5


def test_device_authoritative_hashing_bit_identical():
    """With device_authoritative=True the card (its twin here) produces
    every wave-eligible protocol digest; the engine pauses on wall-clock
    only, so the schedule is bit-identical to mirror mode, and the engine
    hashes nothing above the floor."""
    spec = Spec(node_count=4, client_count=4, reqs_per_client=20, batch_size=5)
    mirror = FastRecording(spec, device=False, torch_device="cpu")
    steps_mirror = mirror.drain_clients(timeout=TIMEOUT)
    metrics.default_registry.reset()
    auth = FastRecording(
        spec, device=True, device_authoritative=True, torch_device="cpu"
    )
    steps_auth = auth.drain_clients(timeout=TIMEOUT)
    assert steps_auth == steps_mirror
    assert _summary(auth.nodes) == _summary(mirror.nodes)
    assert auth.stats() == mirror.stats()
    assert metrics.counter("device_hash_dispatches").value > 0
    assert auth._engine.stats()[3] <= mirror._engine.stats()[3]
    assert auth.device_stall_s > 0


def test_streaming_auth_matches_bitmap_mode():
    """Streaming Ed25519: verdicts arrive in lookahead waves during the run
    (two lookahead passes of 32 requests a client, so more than one
    dispatch), the schedule equals the pre-run bitmap mode's, and the
    byzantine signer stays rejected.  Waves of 64 rows keep the twin's
    cost to four calls."""
    spec = Spec(node_count=4, client_count=2, reqs_per_client=40, batch_size=5,
                signed_requests=True, tweak_recorder=_corrupt_client_1)
    bitmap = FastRecording(spec, device=True, auth_wave=64, torch_device="cpu")
    steps_bitmap = bitmap.drain_clients(timeout=TIMEOUT)
    assert metrics.counter("device_verify_dispatches").value == 2
    metrics.default_registry.reset()
    stream = FastRecording(
        spec, device=True, streaming_auth=True, auth_wave=64, torch_device="cpu"
    )
    steps_stream = stream.drain_clients(timeout=TIMEOUT)
    assert steps_stream == steps_bitmap
    assert _summary(stream.nodes) == _summary(bitmap.nodes)
    assert metrics.counter("device_verify_dispatches").value > 1
    for n in stream.nodes:
        assert n.committed_reqs.get(1, 0) == 0  # byzantine never commits
        assert n.committed_reqs.get(0, 0) == 40


def test_pipelined_device_mirror_matches_serial_and_reference():
    """tests/test_sched_differential.py's c1-small shape: the pipelined run
    (FastStageDriver's rolling window of mirror waves, collected and
    digest-checked as it slides) equals the serial host run and the
    reference's pipelined run."""
    spec = Spec(node_count=4, client_count=4, reqs_per_client=20, batch_size=2)
    serial = _port_fast(spec)
    piped = _port_fast(spec, pipeline=PipelineConfig(), device=True)
    assert metrics.counter("device_hash_dispatches").value > 0
    assert piped == serial
    from mirbft_tpu.processor.pipeline import PipelineConfig as RefPipelineConfig

    assert _ref_fast(spec, pipeline=RefPipelineConfig()) == serial


@pytest.mark.parametrize("partitions", [2, 4])
def test_pdes_bit_identical(partitions):
    """tests/test_pdes.py's n4c4r20b5 spec: the partitioned engine equals
    the sequential one, and the reference's partitioned run."""
    spec = Spec(node_count=4, client_count=4, reqs_per_client=20, batch_size=5)
    sequential = _port_fast(spec)
    pdes = FastRecording(spec, pdes_partitions=partitions, torch_device="cpu")
    steps = pdes.drain_clients(timeout=100_000_000)
    assert (steps, pdes.stats()[1], _summary(pdes.nodes)) == sequential
    assert _ref_fast(spec, pdes_partitions=partitions) == sequential


def test_unsupported_configs_raise():
    spec = Spec(node_count=257, client_count=1, reqs_per_client=1)
    with pytest.raises(FastEngineUnsupported):
        FastRecording(spec)

    # A custom (non-DSL) mangler action cannot be compiled natively.
    spec = Spec(node_count=4, client_count=1, reqs_per_client=1)

    def add_custom(recorder):
        from mirbft_tpu_torch.testengine.manglers import MangleResult

        recorder.mangler = For(matching.msgs()).do(lambda r, e: [MangleResult(e)])

    spec.tweak_recorder = add_custom
    with pytest.raises(FastEngineUnsupported):
        FastRecording(spec)

    # A reconfiguration changing the node set stays outside the envelope.
    from mirbft_tpu_torch.messages import ReconfigNewConfig
    from mirbft_tpu_torch.testengine import ReconfigPoint

    def add_node_reconfig(recorder):
        cfg = dataclasses.replace(recorder.network_state.config, nodes=(0, 1, 2, 3, 4))
        recorder.reconfig_points = [
            ReconfigPoint(client_id=0, req_no=0,
                          reconfiguration=ReconfigNewConfig(config=cfg))
        ]

    spec = Spec(node_count=4, client_count=1, reqs_per_client=1,
                tweak_recorder=add_node_reconfig)
    with pytest.raises(FastEngineUnsupported):
        FastRecording(spec)

    spec = Spec(node_count=4, client_count=1, reqs_per_client=1,
                tweak_recorder=lambda r: setattr(r, "forwarding", True))
    with pytest.raises(FastEngineUnsupported):
        FastRecording(spec)

    # Device-paced modes need device=True.
    spec = Spec(node_count=4, client_count=1, reqs_per_client=1)
    with pytest.raises(FastEngineUnsupported):
        FastRecording(spec, device_authoritative=True, torch_device="cpu")


def test_mesh_sharded_verdicts_match_reference():
    """spec.crypto.mesh_devices: the verdict pass's verify waves shard over
    8 CPU shards (the twins); the run equals the reference's FastRecording
    with its verify waves on the JAX package's 8-device CPU mesh, and the
    byzantine signer's requests never commit."""
    from mirbft_tpu import metrics as ref_metrics
    from mirbft_tpu.testengine import CryptoConfig as RefCryptoConfig

    shape = dict(node_count=4, client_count=2, reqs_per_client=5, batch_size=2,
                 signed_requests=True, tweak_recorder=_corrupt_client_1)
    fast = _port_fast(Spec(**shape, crypto=CryptoConfig(mesh_devices=8, torch_device="cpu")),
                      device=True)
    ref_metrics.default_registry.reset()
    ref = _fast_run(RefFastRecording, RefSpec(**shape, crypto=RefCryptoConfig(mesh_devices=8)),
                    device=True)
    assert fast == ref
    assert fast == _ref_fast(Spec(**shape))
    snap, ref_snap = metrics.snapshot(), ref_metrics.snapshot()
    assert snap["mesh_verify_dispatches"] == ref_snap["mesh_verify_dispatches"] == 1
    assert snap["mesh_verified_signatures"] == ref_snap["mesh_verified_signatures"] == 10
    assert snap["device_verify_dispatches"] == 1
    for committed in (node[5] for node in fast[2]):
        assert committed.get(1, 0) == 0 and committed.get(0, 0) == 5


def test_torch_device_defaults_to_the_spec_then_the_card():
    spec = Spec(node_count=1, client_count=1, reqs_per_client=1)
    assert FastRecording(spec).torch_device == "cuda"
    on_cpu = dataclasses.replace(spec, crypto=CryptoConfig(torch_device="cpu"))
    assert FastRecording(on_cpu).torch_device == "cpu"
    assert FastRecording(on_cpu, torch_device="cuda").torch_device == "cuda"
