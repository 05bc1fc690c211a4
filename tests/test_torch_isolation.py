"""The port stands alone: ``mirbft_tpu_torch``, ``chip_smoke.py``,
``ab_sha256.py``, ``ab_ed25519.py`` and ``ab_mesh_count.py`` import neither ``jax`` nor anything
of the JAX package ``mirbft_tpu``.

One subprocess makes both unimportable (``sys.modules[name] = None``),
imports every module of the port and runs the 4-node recording with the
device hash plane on the CPU twins, then a signed 4-node recording with
the device auth plane on the Ed25519 twin, then the 4-node recording
through the fused pipeline and one quorum wave stream.  A second
subprocess runs a signed 4-node ``FastRecording`` on the twins, a third a
signed 4-node recording whose waves shard over a mesh of two CPU shards,
and a fourth a cohost deployment of ``tools/mirnet.py`` whose host process
inherits the block.  A text scan of the sources catches imports that the run does not
reach.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mirbft_tpu_torch")

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["mirbft_tpu"] = None
import mirbft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mirbft_tpu_torch.__path__, "mirbft_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mirbft_tpu_torch import metrics
from mirbft_tpu_torch.testengine import CryptoConfig, Spec
spec = Spec(node_count=4, client_count=4, reqs_per_client=20, batch_size=5,
            crypto=CryptoConfig(device=True, hash_wave=4, hash_floor=1,
                                defer_unready=False, torch_device="cpu"))
steps = spec.recorder().recording().drain_clients(timeout=200_000)
assert metrics.snapshot().get("device_hash_dispatches", 0) > 0
metrics.default_registry.reset()
signed = Spec(node_count=4, client_count=4, reqs_per_client=4, batch_size=2,
              signed_requests=True,
              crypto=CryptoConfig(device=True, hash_wave=4, hash_floor=1, auth_wave=16,
                                  auth_floor=1, defer_unready=False, torch_device="cpu"))
signed_steps = signed.recorder().recording().drain_clients(timeout=200_000)
assert metrics.snapshot().get("device_verify_dispatches", 0) > 0
metrics.default_registry.reset()
fused = Spec(node_count=4, client_count=4, reqs_per_client=20, batch_size=5,
             crypto=CryptoConfig(device=True, hash_wave=4, hash_floor=1, fused=True,
                                 defer_unready=False, torch_device="cpu"))
fused_steps = fused.recorder().recording().drain_clients(timeout=200_000)
assert metrics.snapshot().get("fused_wave_dispatches", 0) > 0
import numpy as np
from mirbft_tpu_torch.ops import quorum
masks, counts = quorum.quorum_state_to_torch(np.zeros((4, 2, 8), np.uint32),
                                             np.zeros((4, 2), np.int32), "cpu")
stream = quorum.pack_wave_stream([(3, [(0, 0), (1, 1)]), (40, [(0, 0)])], 4)
posts = quorum.device_accumulate(masks, counts, *stream)[2]
assert posts[:, 0].tolist() == [1, 2]
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")))
print("modules", len(names), "steps", steps, "signed_steps", signed_steps,
      "fused_steps", fused_steps, "leaked", leaked)
"""


def test_port_runs_with_jax_and_reference_unimportable():
    # One intra-op thread: the child's twins run many small ops beside the
    # other test workers.
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "leaked []" in out.stdout, out.stdout
    assert "steps 746 signed_steps 1169 fused_steps 746" in out.stdout, out.stdout


_FAST_CHILD = r"""
import fcntl, sys
sys.modules["jax"] = None
sys.modules["mirbft_tpu"] = None
from mirbft_tpu_torch import _native, metrics
from mirbft_tpu_torch.testengine import FastRecording, Spec
with open(_native._FAST_SRC, "rb") as source:
    fcntl.flock(source, fcntl.LOCK_EX)
    assert _native.load_fast() is not None
spec = Spec(node_count=4, client_count=4, reqs_per_client=4, batch_size=2,
            signed_requests=True)
fast = FastRecording(spec, device=True, auth_wave=16, torch_device="cpu")
fast_steps = fast.drain_clients(timeout=200_000)
assert metrics.snapshot().get("device_verify_dispatches", 0) == 1
steps = spec.recorder().recording().drain_clients(timeout=200_000)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")))
print("fast_steps", fast_steps, "steps", steps, "leaked", leaked)
"""


def test_fast_engine_runs_with_jax_and_reference_unimportable():
    """A signed 4-node FastRecording, its verdicts from one wave of the
    Ed25519 twin, takes the steps of the port's Recording.  The child waits
    on the lock the fast-engine tests take, so that the port's _fast.so
    builds once."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _FAST_CHILD],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "fast_steps 1169 steps 1169 leaked []" in out.stdout, out.stdout


_MESH_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["mirbft_tpu"] = None
import mirbft_tpu_torch
from mirbft_tpu_torch import metrics
from mirbft_tpu_torch.testengine import CryptoConfig, Spec
signed = Spec(node_count=4, client_count=4, reqs_per_client=4, batch_size=2,
              signed_requests=True,
              crypto=CryptoConfig(device=True, hash_wave=4, hash_floor=1, auth_wave=16,
                                  auth_floor=1, defer_unready=False, mesh_devices=2,
                                  torch_device="cpu"))
steps = signed.recorder().recording().drain_clients(timeout=200_000)
snap = metrics.snapshot()
assert snap.get("mesh_verify_dispatches", 0) > 0 and snap.get("mesh_hash_dispatches", 0) > 0
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")))
print("mesh_steps", steps, "leaked", leaked)
"""


def test_signed_mesh_run_with_jax_and_reference_unimportable():
    """A signed 4-node Recording whose hash and verify waves shard over a
    mesh of two CPU shards takes the steps of the one-device signed run."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _MESH_CHILD],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh_steps 1169 leaked []" in out.stdout, out.stdout


_COHOST_CHILD = r"""
import sys, tempfile
import mirbft_tpu_torch.groups, mirbft_tpu_torch.node, mirbft_tpu_torch.tools.mirnet as mirnet
from pathlib import Path
root = Path(tempfile.mkdtemp(dir=sys.argv[1]))
res = mirnet.run_sharded_deployment(root_dir=str(root), groups=2, nodes_per_group=1,
                                    reqs_per_group=3, layout="cohost", timeout_s=120)
prom = root / "group-0" / "node-0" / "metrics.prom"
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")))
print("committed", res["unique_reqs_total"], "mux", mirnet._metric_file_value(prom, "wave_mux_active"),
      "leaked", leaked)
"""


def test_cohost_deployment_runs_with_jax_and_reference_unimportable(tmp_path):
    """The harness and a cohost host process (both groups' nodes and their
    shared crypto plane, forced onto the CPU twins) with ``jax`` and
    ``mirbft_tpu`` shadowed by packages that raise on import: the host
    process inherits the shadowing through PYTHONPATH, and it commits."""
    blocker = tmp_path / "blocked"
    for name in ("jax", "mirbft_tpu"):
        (blocker / name).mkdir(parents=True)
        (blocker / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = dict(os.environ, PYTHONPATH=f"{blocker}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1",
               MIRNET_SHARED_WAVE="force", MIRNET_TORCH_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _COHOST_CHILD, str(tmp_path)],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "committed 6 mux 1.0 leaked []" in out.stdout, out.stdout
    (host_log,) = tmp_path.glob("tmp*/host-0.log")
    assert "Error" not in host_log.read_text()


_JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
# A file:line citation of a reference kernel (chip_smoke.py's "replaces"
# field, the kernels' source notes) names the package without importing it.
_REFERENCE = re.compile(r"mirbft_tpu(?!_torch)(?!/[\w/]+\.py:\d+)")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        if "_build" in dirpath or "__pycache__" in dirpath:
            continue
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "ab_sha256.py")
    yield os.path.join(ROOT, "ab_ed25519.py")
    yield os.path.join(ROOT, "ab_mesh_count.py")


def test_sources_never_name_jax_or_the_reference_package():
    offenders = []
    sources = list(_port_sources())
    assert len(sources) > 40
    for path in sources:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for pattern in (_JAX_IMPORT, _REFERENCE):
            for match in pattern.finditer(text):
                line = text.count("\n", 0, match.start()) + 1
                offenders.append(f"{os.path.relpath(path, ROOT)}:{line}")
    assert not offenders, offenders
