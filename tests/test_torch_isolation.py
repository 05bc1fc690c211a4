"""The port stands alone: ``mirbft_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``mirbft_tpu``.

One subprocess makes both unimportable (``sys.modules[name] = None``),
imports every module of the port and runs the 4-node recording with the
device hash plane on the CPU twins.  A text scan of the sources catches
imports that the run does not reach.
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
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.") or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")))
print("modules", len(names), "steps", steps, "leaked", leaked)
"""


def test_port_runs_with_jax_and_reference_unimportable():
    env = dict(os.environ, PYTHONPATH=ROOT)
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
    assert "steps 746" in out.stdout, out.stdout


_JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
# A file:line citation of a reference kernel (chip_smoke.py's "replaces"
# field, the kernels' source notes) names the package without importing it.
_REFERENCE = re.compile(r"mirbft_tpu(?!_torch)(?!/[\w/]+\.py:\d+)")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        if "_build" in dirpath or "__pycache__" in dirpath:
            continue
        for name in files:
            if name.endswith((".py", ".cu", ".cpp")):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


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
