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
    # The threaded node runtime, its stores and transports, and the
    # deployment harness's host modules.
    "reqstore.py",
    "simplewal.py",
    "node.py",
    "fleet.py",
    "storage/__init__.py",
    "storage/wal.py",
    "storage/logstore.py",
    "storage/segments.py",
    "storage/snapshot.py",
    "eventlog/__init__.py",
    "eventlog/record.py",
    "eventlog/journal.py",
    "eventlog/incident.py",
    "net/__init__.py",
    "net/framing.py",
    "net/tcp.py",
    "net/faults.py",
    "net/byzantine.py",
    "net/telemetry.py",
    "groups/__init__.py",
    "groups/routing.py",
    "groups/ship.py",
    "groups/observer.py",
    "groups/reshard.py",
    "tools/__init__.py",
    "tools/textmarshal.py",
    "tools/mircat.py",
    # The static-analysis plane and the native-build CLI.
    "tools/mirlint.py",
    "tools/check_metric_names.py",
    "tools/build_native.py",
] + [
    f"statemachine/{name}"
    for name in (
        "__init__.py", "actions.py", "batch_tracker.py", "checkpoints.py",
        "client_tracker.py", "commitstate.py", "disseminator.py",
        "epoch_active.py", "epoch_change.py", "epoch_target.py",
        "epoch_tracker.py", "machine.py", "msgbuffers.py", "outstanding.py",
        "persisted.py", "proposer.py", "stateless.py", "voteplane.py",
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
    assert {f"statemachine/{n}" for n in ref} <= set(VERBATIM) | {"statemachine/sequence.py"}


# The port's one deviation from the reference's state machine: a follower's
# batch digest that arrives after the owner's Commit advances the sequence
# (statemachine/sequence.py, apply_batch_hash_result).  In the reference the
# owner's implicit prepare is dropped as a duplicate there and the READY
# sequence waits for an epoch change (ROADMAP.md Queue 3).  To tell that
# drop apart, apply_prepare_msg's vote count moves into _count_prepare.
SEQUENCE_HOOKS = (
    (
        '        return self.apply_prepare_msg(self.owner, digest)\n',
        '        count = self._count_prepare(self.owner, digest)\n'
        '        if count is None:\n'
        "            # The owner's Commit counted its vote before this digest\n"
        '            # arrived (a follower whose hashing lags the network), so the\n'
        '            # implicit prepare is a duplicate.  The sequence still needs\n'
        "            # the digest's arrival to leave READY, or it waits for an\n"
        '            # epoch change.\n'
        '            state = self._state\n'
        '            if state is SeqState.READY or state is SeqState.PENDING_REQUESTS:\n'
        '                return self.advance_state()\n'
        '            return EMPTY_ACTIONS\n'
        '        return self._advance_on_prepare(count)\n',
    ),
    (
        'We count each node at most once."""\n'
        '        if self.plane is not None:\n'
        '            count = self.plane.apply_vote(\n'
        '                0, self.seq_no, digest if digest is not None else b"", source\n'
        '            )\n'
        '            if count is None:\n'
        '                return EMPTY_ACTIONS  # duplicate\n'
        '            if source == self.my_id:\n'
        '                self.my_prepare_digest = digest\n'
        '        else:\n'
        '            bit = 1 << source\n'
        '            if (self.prep_mask | self.commit_mask) & bit:\n'
        '                return EMPTY_ACTIONS\n'
        '            self.prep_mask |= bit\n'
        '            if source == self.my_id:\n'
        '                self.my_prepare_digest = digest\n'
        '            key = digest if digest is not None else b""\n'
        '            count = self.prepares.get(key, 0) + 1\n'
        '            self.prepares[key] = count\n'
        '        # advance_state can only',
        'We count each node at most once."""\n'
        '        count = self._count_prepare(source, digest)\n'
        '        if count is None:\n'
        '            return EMPTY_ACTIONS  # duplicate\n'
        '        return self._advance_on_prepare(count)\n'
        '\n'
        '    def _count_prepare(self, source: int, digest: Optional[bytes]) -> Optional[int]:\n'
        '        """Record ``source``\'s prepare; the votes now on ``digest``, or None\n'
        '        for a node that already voted."""\n'
        '        if self.plane is not None:\n'
        '            count = self.plane.apply_vote(\n'
        '                0, self.seq_no, digest if digest is not None else b"", source\n'
        '            )\n'
        '            if count is None:\n'
        '                return None\n'
        '            if source == self.my_id:\n'
        '                self.my_prepare_digest = digest\n'
        '        else:\n'
        '            bit = 1 << source\n'
        '            if (self.prep_mask | self.commit_mask) & bit:\n'
        '                return None\n'
        '            self.prep_mask |= bit\n'
        '            if source == self.my_id:\n'
        '                self.my_prepare_digest = digest\n'
        '            key = digest if digest is not None else b""\n'
        '            count = self.prepares.get(key, 0) + 1\n'
        '            self.prepares[key] = count\n'
        '        return count\n'
        '\n'
        '    def _advance_on_prepare(self, count: int) -> Actions:\n'
        '        # advance_state can only',
    ),
)


def test_sequence_is_the_reference_but_for_the_late_digest_advance():
    expected = _rewrite(_read(REF, "statemachine/sequence.py"))
    for ref_text, port_text in SEQUENCE_HOOKS:
        assert expected.count(ref_text) == 1
        expected = expected.replace(ref_text, port_text)
    assert _read(PORT, "statemachine/sequence.py") == expected


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


# The shared cross-group wave mux in the reference's testengine/crypto.py:
# the hash plane's attach and its three mux branches (the aggregate launch
# threshold in enqueue, the forced flush of the whole shared wave, the
# deferred sub-threshold launch of dispatch_batches), and the sub-handle
# and mux classes.
MUX_BLOCKS = [
    ("        # Shared cross-group multiplexer (attach_mux)", "        # When True the scheduler"),
    ("    def attach_mux(", "\n    # -- scheduler-side"),
    ("        if self._mux is not None:\n            # Mux tenants launch", "        if join_time:"),
    ("        if self._mux is not None:\n            # Forced flushes", "        queue_depth = len("),
    ("            # Mux-attached planes defer", "        return batches\n"),
    ("class _MuxSubHandle:", "\n\n\nclass SharedWaveMux"),
    ("class SharedWaveMux", "\n\n\nclass DeviceAuthPlane"),
]


@pytest.mark.parametrize("block", range(len(MUX_BLOCKS)))
def test_shared_wave_mux_is_copied(block):
    ref = _rewrite(_read(REF, "testengine/crypto.py"))
    port = _read(PORT, "testengine/crypto.py")
    start, end = MUX_BLOCKS[block]
    i = ref.index(start)
    text = ref[i : ref.index(end, i)]
    assert len(text) > 150 and text in port, start
    assert "NOT_PORTED[\"mux\"]" not in port


# The device hooks of the port's groups/cohost.py: (the reference's text,
# the port's).  Each one threads the ``torch_device`` keyword through.
COHOST_HOOKS = [
    ('    independently (``SharedWaveMux``)."""\n',
     '    independently (``SharedWaveMux``).\n\n'
     '    ``torch_device``: "cuda" (the default) launches the port\'s CUDA kernels,\n'
     '    "cpu" runs their plain PyTorch twins (the CPU tests)."""\n'),
    ("        adaptive: bool = True,\n    ):\n",
     '        adaptive: bool = True,\n        torch_device: str = "cuda",\n    ):\n'),
    ("        self.pipeline = FusedCryptoPipeline(kernel=kernel, n_groups=n_groups)\n",
     "        self.pipeline = FusedCryptoPipeline(\n"
     "            kernel=kernel, n_groups=n_groups, device=torch_device\n        )\n"),
    ("        self.wave_size = wave_size\n        self._planes",
     "        self.wave_size = wave_size\n        self.torch_device = torch_device\n"
     "        self._planes"),
    ("                    kernel=self.kernel,\n",
     "                    kernel=self.kernel,\n                    torch_device=self.torch_device,\n"),
]


def test_cohost_plane_is_the_reference_outside_its_device_hooks():
    """groups/cohost.py: the reference with its ``torch_device`` hooks
    applied, and nothing else."""
    expected = _rewrite(_read(REF, "groups/cohost.py"))
    for ref_text, port_text in COHOST_HOOKS:
        assert expected.count(ref_text) == 1, ref_text
        assert "torch_device" in port_text
        expected = expected.replace(ref_text, port_text)
    assert _read(PORT, "groups/cohost.py") == expected


def test_mirnet_is_the_reference_outside_its_cuda_probe():
    """tools/mirnet.py: the reference but for ``_build_cohost_plane``,
    whose probe asks torch for a card and never imports JAX."""
    ref = _rewrite(_read(REF, "tools/mirnet.py"))
    port = _read(PORT, "tools/mirnet.py")
    head, tail = "def _build_cohost_plane(", "\n\n\ndef run_host("
    assert port[: port.index(head)] == ref[: ref.index(head)]
    assert port[port.index(tail):] == ref[ref.index(tail):]
    probe = port[port.index(head) : port.index(tail)]
    assert "jax" not in probe and "JAX_PLATFORMS" not in probe
    assert "torch.cuda.is_available()" in probe and "MIRNET_TORCH_DEVICE" in probe
