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
    "processor/verify.py",
    "_native/__init__.py",
    "_native/ackplane.cpp",
    "_native/.gitignore",
    "_native/fastengine.cpp",
    "ops/cpu.py",
    "testengine/queue.py",
    "testengine/sched.py",
    "testengine/manglers.py",
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


def _blocks(ref, starts_ends):
    for start, end in starts_ends:
        i = ref.index(start)
        yield ref[i : ref.index(end, i)].rstrip()


def test_host_side_of_ed25519_is_copied():
    """The host half of ops/ed25519.py (curve constants, limb helpers, nibble
    matrices, the pure-Python RFC 8032 code, the key caches and the S < L
    screen, and the verifier's key and packing methods) is carried as block
    copies inside the port's module."""
    with open(os.path.join(REF, "ops", "ed25519.py"), encoding="utf-8") as fh:
        ref = fh.read()
    with open(os.path.join(PORT, "ops", "ed25519.py"), encoding="utf-8") as fh:
        port = fh.read()
    blocks = list(_blocks(ref, [
        ("P = 2**255 - 19", "\n\n\ndef int_to_limbs"),
        ("def int_to_limbs(", "\n\n\n# ----"),
        ("def _build_nibble_mats(", "\n\n\ndef _dot_bf16"),
        ("def _sc_from_bytes_le(", "\n\n\ndef _next_pow2"),
        ("def _next_pow2(", "\n\n\nclass Ed25519BatchVerifier"),
        ("    def _decompress_pub(", "\n\n    def dispatch("),
    ]))
    assert len(blocks) == 6 and all(len(b) > 300 for b in blocks)
    for block in blocks:
        assert block in port


def _read(package, path):
    with open(os.path.join(package, path), encoding="utf-8") as fh:
        return fh.read()


# (module, [(start, end or None for the end of the file)]): the reference's
# host code that the port's modules of the fused wave carry unchanged.
FUSED_BLOCKS = {
    "ops/quorum.py": [
        ("MASK_WORDS = 8", "\n\n\ndef _kernel"),
        ("def host_accumulate(", None),
    ],
    "ops/fused.py": [
        ("class FusedResult:", "\n\n\nclass FusedCryptoPipeline"),
        ("    def _pack_quorum(", "\n\n    def _stage("),
        ("def host_fused_reference(", None),
    ],
    "testengine/crypto.py": [
        ("    def attach_fused(", "\n\n    def attach_mux("),
        ("            if self._fused is not None and hasattr(handle, \"verify_count\"):",
         "\n            for key, ref, digest in zip(keys, refs, digests):"),
        ("    def _harvest_auth(", "\n\n    def _host_hash("),
    ],
}


@pytest.mark.parametrize("module", list(FUSED_BLOCKS))
def test_host_side_of_the_fused_wave_is_copied(module):
    """The host code of the quorum plane (the packer, the numpy reference,
    the crossing band), of the fused pipeline (its result type, its quorum
    packer and the host oracle) and the fused branches of the hash plane
    (attach, the partial and full collects, the exactly-once verdict
    harvest) are carried as block copies, after the package rename."""
    ref = _rewrite(_read(REF, module))
    port = _read(PORT, module)
    for start, end in FUSED_BLOCKS[module]:
        i = ref.index(start)
        block = ref[i:] if end is None else ref[i : ref.index(end, i)]
        assert len(block) > 300 and block.rstrip() in port, (module, start)


# The reference's testengine/fastengine.py, from its imports to its end, in
# blocks that the port carries unchanged.  Between them lie the device
# hooks: the torch_device keyword and its default, the verifier
# (_make_verifier: mesh raises) and the two lazy hashers (TorchHasher).
FASTENGINE_BLOCKS = [
    ("from __future__ import annotations", '    ):\n        """``device_authoritative``'),
    ('        """``device_authoritative``', '"""\n        _require(_native.load_fast()'),
    ("        _require(_native.load_fast()", "        self._py_crypto_s = 0.0"),
    ("        self._py_crypto_s = 0.0", "    def _make_verifier(self):"),
    ("\n\n    def _device_verdicts(", "            from ..ops.sha256 import TpuHasher"),
    ("        for message, digest in log:", "                from ..ops.sha256 import TpuHasher"),
    ("            host_side: List[bytes] = []", None),
]


def test_fast_engine_wrapper_is_the_reference_outside_its_device_hooks():
    ref = _rewrite(_read(REF, "testengine/fastengine.py"))
    port = _read(PORT, "testengine/fastengine.py")
    covered_to = ref.index(FASTENGINE_BLOCKS[0][0])
    gaps = []
    for start, end in FASTENGINE_BLOCKS:
        i = ref.index(start, covered_to)
        gaps.append(ref[covered_to:i])
        j = len(ref) if end is None else ref.index(end, i)
        block = ref[i:j]
        assert len(block) > 300 and block in port, start
        covered_to = j
    assert covered_to == len(ref)
    # What the blocks leave out is the hooks and nothing else: the ends of
    # the signature and of its docstring (torch_device goes before each),
    # the verifier and the two hashers.
    hooks = [gap for gap in gaps if gap]
    assert hooks[:2] == ["    ):\n", '"""\n'] and len(hooks) == 5
    assert "mesh" in hooks[2] and hooks[2].count("\n") < 16
    assert all("TpuHasher" in gap and gap.count("\n") < 5 for gap in hooks[3:])
