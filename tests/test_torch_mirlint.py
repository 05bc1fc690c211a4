"""The port's copy of the static-analysis plane run over the port.

``mirbft_tpu_torch/tools/mirlint.py`` is the JAX package's linter after the
package rename (``tests/test_torch_copies.py`` pins the text), so it walks
``mirbft_tpu_torch/`` with the reference's rules and the repo's shared
``docs/OBSERVABILITY.md``.  Its findings on the port must be exactly the
three ``host_hashed_*`` counters: the port's hash plane counts the digests
it hashes on the host in three counters that the JAX package does not have
(ROADMAP.md Queue 3), and the docs are the reference's.  Anything else is
a fault the reference does not carry.
"""

import re

import pytest

from mirbft_tpu_torch.tools import build_native, check_metric_names, mirlint

PORT_ONLY_COUNTERS = (
    "host_hashed_fast_messages",
    "host_hashed_oversize_messages",
    "host_hashed_straggler_messages",
)


def test_port_lint_finds_only_the_port_only_counters():
    findings = mirlint.lint()
    named = sorted(re.search(r"'([a-z_]+)'", f.message).group(1) for f in findings)
    assert named == list(PORT_ONLY_COUNTERS), [f.render() for f in findings]
    assert {(f.path, f.rule) for f in findings} == {
        ("mirbft_tpu_torch/testengine/crypto.py", "metric-names")
    }


def test_port_lint_covers_the_mesh_counters_and_the_build_lock():
    # The mesh counters are emitted again, the fast engine reads no native
    # key named 'mesh', and the build module maps its lock.
    findings = mirlint.lint()
    text = "\n".join(f.render() for f in findings)
    for gone in ("mesh_hash_dispatches", "mesh_hashed_messages", "'mesh'", "_build.py"):
        assert gone not in text
    assert mirlint.repo_root().joinpath("mirbft_tpu_torch", "parallel", "mesh.py").exists()


def test_check_metric_names_shim_reports_the_same_three():
    violations = check_metric_names.check()
    assert len(violations) == 3
    assert all(any(name in v for name in PORT_ONLY_COUNTERS) for v in violations)
    assert check_metric_names.REQUIRED_NAMES == mirlint.REQUIRED_METRIC_NAMES


def test_build_native_rejects_unknown_sanitizers():
    with pytest.raises(SystemExit):
        build_native.main(["--sanitize=bogus"])
