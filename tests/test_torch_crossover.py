"""The port's measured hash-kernel crossover (mirbft_tpu_torch/ops/crossover.py).

Mirrors tests/test_kernel_crossover.py's injected-probe tests with
``backend="cuda"``: the resolution logic is pinned on the CPU by injecting
the backend name and probe timings; the probe itself runs on the card
(chip_smoke.py).  Also pins that CPU tensors always resolve to the plain
twin ("scan") and that the port reads its own environment override, not the
JAX package's.
"""

import hashlib

import pytest

from mirbft_tpu.ops.crossover import resolve_hash_kernel as ref_resolve
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.ops.crossover import (
    ENV_HASH_KERNEL,
    hash_crossover_batch,
    resolve_hash_kernel,
)
from mirbft_tpu_torch.ops.sha256 import TorchHasher

# One lanes tile costs as much as the batch-major kernel's fixed cost and
# 300 of its messages: crossover 300.
PROBE = (301e-5, 1e-5, 1e-5)


@pytest.fixture(autouse=True)
def _reset_port_observability(monkeypatch):
    monkeypatch.delenv(ENV_HASH_KERNEL, raising=False)
    monkeypatch.delenv("MIRBFT_TPU_HASH_KERNEL", raising=False)
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
