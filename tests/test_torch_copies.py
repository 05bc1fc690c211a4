"""Drift guard for the port's verbatim host modules.

The port imports nothing of the JAX package, so it carries its own copy of
every host module it runs.  Each copy must equal its reference file after
the package-name rewrite (``mirbft_tpu`` -> ``mirbft_tpu_torch``): a later
change to the reference's host code then fails here instead of silently
forking the two packages.  Pure text comparison, no imports.
"""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "mirbft_tpu")
PORT = os.path.join(ROOT, "mirbft_tpu_torch")

VERBATIM = [
    "config.py",
    "logger.py",
    "messages.py",
    "metrics.py",
    "state.py",
    "status.py",
    "tracing.py",
    "wire.py",
    "health.py",
    "processor/__init__.py",
    "processor/clients.py",
    "processor/interfaces.py",
    "processor/pipeline.py",
    "processor/replicas.py",
    "processor/serial.py",
    "processor/work.py",
    "_native/__init__.py",
    "_native/ackplane.cpp",
    "_native/.gitignore",
    "ops/cpu.py",
    "testengine/queue.py",
    "testengine/sched.py",
] + [
    f"statemachine/{name}"
    for name in (
        "__init__.py", "actions.py", "batch_tracker.py", "checkpoints.py",
        "client_tracker.py", "commitstate.py", "disseminator.py",
        "epoch_active.py", "epoch_change.py", "epoch_target.py",
        "epoch_tracker.py", "machine.py", "msgbuffers.py", "outstanding.py",
        "persisted.py", "proposer.py", "sequence.py", "stateless.py",
        "voteplane.py",
    )
]


def _rewrite(text: str) -> str:
    return re.sub(r"mirbft_tpu(?!_torch)", "mirbft_tpu_torch", text)


@pytest.mark.parametrize("module", VERBATIM)
def test_copy_equals_reference_after_rename(module):
    with open(os.path.join(REF, module), encoding="utf-8") as fh:
        expected = _rewrite(fh.read())
    with open(os.path.join(PORT, module), encoding="utf-8") as fh:
        actual = fh.read()
    assert actual == expected, f"mirbft_tpu_torch/{module} drifted from its reference"


def test_every_statemachine_module_is_copied():
    ref = {n for n in os.listdir(os.path.join(REF, "statemachine")) if n.endswith(".py")}
    assert {f"statemachine/{n}" for n in ref} <= set(VERBATIM)


def test_packed_host_side_of_sha256_is_copied():
    """The numpy host side of ops/sha256.py (constants, padding, pooled
    packing) is carried as a block copy inside the port's module."""
    with open(os.path.join(REF, "ops", "sha256.py"), encoding="utf-8") as fh:
        ref = fh.read()
    with open(os.path.join(PORT, "ops", "sha256.py"), encoding="utf-8") as fh:
        port = fh.read()
    start = ref.index("# Round constants (FIPS 180-4).")
    assert ref[start : ref.index("\n\n\ndef _rotr", start)] in port
    start = ref.index("def pad_message(")
    end = ref.index("@functools.partial(jax.jit, donate_argnums")
    assert ref[start:end].rstrip() in port
