"""The port's deployment harness (``mirbft_tpu_torch.tools.mirnet``) on the CPU.

Real OS processes over localhost TCP, as ``tests/test_mirnet.py`` and the
cohost case of ``tests/test_sharded.py`` run the JAX package's: a 4-node
single-group deployment, and a 2-group x 4-node cohost deployment whose four
host processes each share one crypto plane (``CohostCryptoPlane``: one
multi-tenant fused pipeline under one ``SharedWaveMux``), forced onto the
kernels' CPU twins.  Then the plane probe of the cohost host, which decides
by torch's view of CUDA and ``MIRNET_*`` variables only.
"""

import hashlib

import pytest

from mirbft_tpu_torch import metrics
from mirbft_tpu_torch.tools import mirnet


def _batch_digests_are_hashlibs(commit_log):
    """Every ``<seq> <digest> <client:req,...>`` line's batch digest is the
    processor's: SHA-256 over the request digests, each SHA-256 of the
    request bytes the harness submits (``b"mirnet-%d" % req_no``).
    Returns the request numbers the log committed."""
    lines = [line for line in commit_log.read_text().splitlines() if line]
    committed = set()
    for line in lines:
        _seq, digest, refs = line.split(" ", 2)
        reqs = [int(ref.split(":")[1]) for ref in refs.split(",") if ref]
        committed.update(reqs)
        want = hashlib.sha256(
            b"".join(hashlib.sha256(b"mirnet-%d" % r).digest() for r in reqs)
        ).digest() if reqs else b""
        assert digest == want.hex(), line
    return committed


def test_mirnet_four_process_agreement(tmp_path):
    result = mirnet.run_deployment(root_dir=str(tmp_path), node_count=4, reqs=5, timeout_s=60)
    assert result["agreement_problems"] == []
    committed = [n for n, count in result["commits"].items() if count > 0]
    assert len(committed) >= 3
    for n in committed:
        _batch_digests_are_hashlibs(tmp_path / f"node-{n}" / "commits.log")
    prom = (tmp_path / "node-0" / "metrics.prom").read_text()
    assert "net_tx_bytes_total" in prom
    assert "net_rx_bytes_total" in prom


def test_cohost_deployment_shares_one_plane_per_host(tmp_path, monkeypatch):
    """Four host processes, each serving its node of both groups through
    one shared crypto plane on the CPU twins: the gauge says so on every
    host, the plane (not per-group CPU hashers) served the hash rows, both
    groups committed all their requests in agreement, and every batch
    digest is hashlib's.

    At this load the plane's mux launches no wave, in either package: the
    harness's requests are single parts under 512 B and its batches hold
    one request, so their digests take the plane's host fast path, and the
    few multi-part rows (null batches) are collected right after their
    dispatch, below both the aggregate wave size (192) and the straggler
    floor (64), so the plane hashes them on the host.  Its fused waves are
    held to hashlib in tests/test_torch_wave_mux.py."""
    monkeypatch.setenv("MIRNET_SHARED_WAVE", "force")
    monkeypatch.setenv("MIRNET_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = mirnet.run_sharded_deployment(
        root_dir=str(tmp_path), groups=2, nodes_per_group=4, reqs_per_group=4,
        layout="cohost", timeout_s=240,
    )
    assert res["redirects_followed"] == 0
    complete = {0: 0, 1: 0}
    for host in range(4):
        prom = tmp_path / "group-0" / f"node-{host}" / "metrics.prom"
        assert mirnet._metric_file_value(prom, "wave_mux_active") == 1
        # Counters only the plane (testengine.crypto.DeviceHashPlane) keeps.
        assert mirnet._metric_file_value(prom, "host_hashed_fast_messages") > 0
        assert mirnet._metric_file_value(prom, "device_hashed_messages") == \
            mirnet._metric_file_value(prom, "fused_wave_messages")
        for g in range(2):
            log = tmp_path / f"group-{g}" / f"node-{host}" / "commits.log"
            complete[g] += _batch_digests_are_hashlibs(log) == set(range(4))
    # The harness waits for a quorum (3 of 4) of each group's nodes to
    # commit every request; the fourth may still trail.
    assert min(complete.values()) >= 3, complete


@pytest.mark.parametrize(
    "case",
    ["shared_wave_off", "no_cuda", "pinned_off_the_card", "forced_cpu", "forced_cuda_no_card"],
)
def test_cohost_plane_probe(case, monkeypatch):
    """The probe asks torch for CUDA and reads MIRNET_* only (JAX_PLATFORMS,
    here set to "tpu", means nothing to it): with no card it reports the
    per-group CPU hashers in the gauge; forced onto "cpu" it builds the
    plane on the twins; forced onto "cuda" with no card it raises, so that
    the host process fails instead of dropping to the CPU."""
    import torch

    metrics.default_registry.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("JAX_PLATFORMS", "tpu")
    monkeypatch.delenv("MIRNET_SHARED_WAVE", raising=False)
    monkeypatch.delenv("MIRNET_TORCH_DEVICE", raising=False)
    shard = {"shared_wave": case != "shared_wave_off"}
    if case == "pinned_off_the_card":
        monkeypatch.setenv("MIRNET_TORCH_DEVICE", "cpu")
    if case.startswith("forced"):
        monkeypatch.setenv("MIRNET_SHARED_WAVE", "force")
    if case == "forced_cpu":
        monkeypatch.setenv("MIRNET_TORCH_DEVICE", "cpu")
    gauge = metrics.default_registry.gauge("wave_mux_active")
    gauge.set(-1)
    if case == "forced_cuda_no_card":
        with pytest.raises(RuntimeError, match="CUDA"):
            mirnet._build_cohost_plane(2, shard)
        assert gauge.value == -1
        return
    plane = mirnet._build_cohost_plane(2, shard)
    if case == "forced_cpu":
        assert plane.pipeline.device.type == "cpu" and plane.n_groups == 2
        hasher = plane.hasher_for(1)
        parts = [b"probe", b"x" * 600]
        assert hasher.hash_batches([parts]) == [hashlib.sha256(b"".join(parts)).digest()]
        assert gauge.value == 1
    else:
        assert plane is None and gauge.value == 0
