"""The port's measured hash-kernel crossover (mirbft_tpu_torch/ops/crossover.py).

Mirrors tests/test_kernel_crossover.py's injected-probe tests with
``backend="cuda"``: the resolution logic is pinned on the CPU by injecting
the backend name and probe timings; the probe itself runs on the card
(chip_smoke.py).  Also pins that CPU tensors always resolve to the plain
twin ("scan") and that the port reads its own environment override, not the
JAX package's.  The verifier's backend resolves to "vpu" on the CPU; on
the card "auto" takes the one-time probe that races the two verify kernels
(monkeypatched here) and keeps the faster, as the JAX package's resolver
does on its accelerator with the same probe times.
"""

import hashlib

import pytest

from mirbft_tpu.ops.crossover import resolve_hash_kernel as ref_resolve
from mirbft_tpu.ops.crossover import resolve_verify_backend as ref_resolve_verify
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.ops import crossover
from mirbft_tpu_torch.ops.crossover import (
    ENV_HASH_KERNEL,
    ENV_VERIFY_KERNEL,
    hash_crossover_batch,
    resolve_hash_kernel,
    resolve_verify_backend,
)
from mirbft_tpu_torch.ops.ed25519 import Ed25519BatchVerifier
from mirbft_tpu_torch.ops.sha256 import TorchHasher

# One lanes tile costs as much as the batch-major kernel's fixed cost and
# 300 of its messages: crossover 300.
PROBE = (301e-5, 1e-5, 1e-5)


@pytest.fixture(autouse=True)
def _reset_port_observability(monkeypatch):
    monkeypatch.delenv(ENV_HASH_KERNEL, raising=False)
    monkeypatch.delenv("MIRBFT_TPU_HASH_KERNEL", raising=False)
    monkeypatch.delenv(ENV_VERIFY_KERNEL, raising=False)
    monkeypatch.delenv("MIRBFT_TPU_VERIFY_KERNEL", raising=False)
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


def test_cpu_hasher_always_resolves_the_plain_twin():
    hasher = TorchHasher(min_device_batch=1, device="cpu")
    assert hasher.kernel == "auto"
    assert hasher.kernel_for_batch(4096) == "scan"
    assert hasher.kernel_for_batch(1) == "scan"


def test_crossover_batch_off_cuda_is_never():
    assert hash_crossover_batch(backend="cpu") == 1 << 30


def test_crossover_batch_from_injected_probe():
    assert hash_crossover_batch(backend="cuda", probe=PROBE) == 300
    # Clamped below an eighth of a tile (padding waste dominates) ...
    assert hash_crossover_batch(backend="cuda", probe=(2e-5, 1e-5, 1e-5)) == 128
    # ... also where a tile costs no more than the batch kernel's fixed cost ...
    assert hash_crossover_batch(backend="cuda", probe=(9e-6, 1e-5, 0.0)) == 128
    # ... and above one tile (lanes amortizes by construction).
    assert hash_crossover_batch(backend="cuda", probe=(1.0, 0.0, 1e-9)) == 1024
    assert hash_crossover_batch(backend="cuda", probe=(1.0, 0.0, 0.0)) == 1024


def test_resolve_hash_kernel_applies_crossover():
    assert resolve_hash_kernel("auto", 300, backend="cuda", probe=PROBE) == "lanes"
    assert resolve_hash_kernel("auto", 299, backend="cuda", probe=PROBE) == "scan"
    assert resolve_hash_kernel("auto", 4096, backend="cpu") == "scan"


@pytest.mark.parametrize("explicit", ["scan", "pallas", "lanes"])
def test_resolve_hash_kernel_explicit_passthrough(explicit):
    assert resolve_hash_kernel(explicit, 1, backend="cuda", probe=PROBE) == explicit
    assert resolve_hash_kernel(explicit, 1 << 20, backend="cpu") == explicit


def test_resolve_hash_kernel_env_override(monkeypatch):
    monkeypatch.setenv(ENV_HASH_KERNEL, "lanes")
    assert resolve_hash_kernel("auto", 1, backend="cpu") == "lanes"
    assert hash_crossover_batch(backend="cpu") == 1
    monkeypatch.setenv(ENV_HASH_KERNEL, "scan")
    assert resolve_hash_kernel("auto", 1 << 20, backend="cuda", probe=PROBE) == "scan"
    assert hash_crossover_batch(backend="cuda", probe=PROBE) == 1 << 30


def test_env_overrides_are_per_package(monkeypatch):
    """The JAX package's override does not steer the port, and the port's
    does not steer the JAX package: the two can be A/B'd in one process."""
    monkeypatch.setenv("MIRBFT_TPU_HASH_KERNEL", "lanes")
    assert resolve_hash_kernel("auto", 1, backend="cpu") == "scan"
    monkeypatch.delenv("MIRBFT_TPU_HASH_KERNEL")
    monkeypatch.setenv(ENV_HASH_KERNEL, "lanes")
    assert ref_resolve("auto", 1, backend="cpu") == "scan"


def test_env_override_lanes_routes_cpu_waves_through_the_lanes_twin(monkeypatch):
    monkeypatch.setenv(ENV_HASH_KERNEL, "lanes")
    hasher = TorchHasher(min_device_batch=1, device="cpu")
    messages = [b"crossover-%d" % i * 9 for i in range(5)]
    packed = hasher.pack(messages)
    assert packed.layout == "lanes"
    handle = hasher.dispatch_packed(packed)
    assert hasher.collect(handle) == [hashlib.sha256(m).digest() for m in messages]


def _fake_probe(monkeypatch, times):
    """Stand in for the card's probe: record each call, return ``times``."""
    calls = []

    def probe(backend=None):
        calls.append(backend)
        return times

    monkeypatch.setattr(crossover, "measure_verify_probe", probe)
    return calls


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_verify_backend_auto_is_vpu(monkeypatch, backend):
    # On the card the probe decides: here the "mxu" kernel is the slower.
    calls = _fake_probe(monkeypatch, (5.3e-4, 9.0e-3))
    assert resolve_verify_backend("auto", backend=backend) == "vpu"
    assert calls == ([] if backend == "cpu" else ["cuda"])
    assert Ed25519BatchVerifier(device="cpu").resolved_kernel() == "vpu"


@pytest.mark.parametrize("probe", [(2e-3, 1e-3), (1e-3, 2e-3), (1e-3, 1e-3), (5.3e-4, 9.0e-3)])
def test_verify_backend_auto_on_the_card_takes_the_probe(monkeypatch, probe):
    """With no probe given, "auto" on "cuda" measures one (cached for the
    process in the real ``measure_verify_probe``) and keeps the faster
    kernel, ties to "vpu": the JAX resolver's answer on its accelerator for
    the same times.  The environment override skips the probe."""
    calls = _fake_probe(monkeypatch, probe)
    want = ref_resolve_verify("auto", backend="tpu", probe=probe)
    assert resolve_verify_backend("auto", backend="cuda") == want
    assert resolve_verify_backend("auto", backend="cuda", probe=probe) == want
    assert calls == ["cuda"]
    monkeypatch.setenv(ENV_VERIFY_KERNEL, "vpu")
    assert resolve_verify_backend("auto", backend="cuda") == "vpu"
    assert calls == ["cuda"]


def test_verify_backend_explicit_and_injected_probe():
    for explicit in ("vpu", "mxu"):
        assert resolve_verify_backend(explicit, backend="cuda") == explicit
        assert Ed25519BatchVerifier(device="cpu", kernel=explicit).resolved_kernel() == explicit
    # A probe in which "mxu" is the slower keeps "vpu" ...
    assert resolve_verify_backend("auto", backend="cuda", probe=(2e-3, float("inf"))) == "vpu"
    # ... and a faster mxu kernel wins it, as on the reference's chip.
    assert resolve_verify_backend("auto", backend="cuda", probe=(2e-3, 1e-3)) == "mxu"
    assert resolve_verify_backend("auto", backend="cpu", probe=(2e-3, 1e-3)) == "vpu"


def test_verify_env_overrides_are_per_package(monkeypatch):
    monkeypatch.setenv(ENV_VERIFY_KERNEL, "mxu")
    assert resolve_verify_backend("auto", backend="cpu") == "mxu"
    assert ref_resolve_verify("auto", backend="cpu") == "vpu"
    monkeypatch.delenv(ENV_VERIFY_KERNEL)
    monkeypatch.setenv("MIRBFT_TPU_VERIFY_KERNEL", "mxu")
    assert resolve_verify_backend("auto", backend="cpu") == "vpu"


@pytest.mark.parametrize("probe", [(5.3e-4, 9.0e-3), (2e-3, 1e-3)])
def test_card_verifier_binds_auto_when_built(monkeypatch, probe):
    """A card's verifier resolves "auto" at construction, so the probe is
    never taken inside a dispatch (nor counted in its latency); an explicit
    backend takes no probe."""
    import torch

    calls = _fake_probe(monkeypatch, probe)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    verifier = Ed25519BatchVerifier(device="cuda")
    want = ref_resolve_verify("auto", backend="tpu", probe=probe)
    assert calls == ["cuda"]
    assert verifier.kernel == want and verifier.resolved_kernel() == want
    assert calls == ["cuda"]
    assert Ed25519BatchVerifier(device="cuda", kernel="vpu").resolved_kernel() == "vpu"
    assert calls == ["cuda"]


def test_verify_probe_is_taken_by_one_thread_at_a_time(monkeypatch):
    """Threads that resolve "auto" together do not probe at once (each
    would time the other's kernels): the probe runs under a lock."""
    import threading
    import time

    active, most = [0], [0]

    def probe(backend):
        active[0] += 1
        most[0] = max(most[0], active[0])
        time.sleep(0.02)
        active[0] -= 1
        return (1e-3, 2e-3)

    monkeypatch.setattr(crossover, "_verify_probe", probe)
    threads = [threading.Thread(target=crossover.measure_verify_probe, args=("cuda",))
               for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert most[0] == 1
