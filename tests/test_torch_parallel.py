"""The port's device mesh (``mirbft_tpu_torch/parallel``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_parallel.py``: the port's mesh is 8 CPU shards
(``make_mesh(8, device="cpu")``, every shard on the kernels' plain PyTorch
versions) and the JAX package's is conftest's 8 virtual CPU devices.  The
same numpy-seeded inputs go through both; digest words, counts and verdicts
must be exactly equal, and the consensus runs must take the same steps to
the same checkpoints with the same committed requests.  Beyond the
reference: a mesh of 6 (the verifier pads its batch to a multiple of the
mesh), a batch that does not divide over the mesh (both raise), the "mxu"
field multiply on a CPU mesh, and ``csrc/mesh.cu`` compiled for the host
with the C++ compiler against ``shard_count_torch`` (the count kernel's
grid, its grid-stride loop and its reduction order run thread by thread).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from mirbft_tpu import metrics as ref_metrics
from mirbft_tpu import parallel as ref
from mirbft_tpu.ops.ed25519 import Ed25519BatchVerifier as RefVerifier
from mirbft_tpu.testengine import CryptoConfig as RefCryptoConfig
from mirbft_tpu.testengine import DeviceHashPlane as RefDeviceHashPlane
from mirbft_tpu.testengine import Spec as RefSpec
from mirbft_tpu_torch import metrics, parallel, tracing
from mirbft_tpu_torch.ops import ed25519
from mirbft_tpu_torch.ops.ed25519 import Ed25519BatchVerifier, keypair_from_seed, verify_one
from mirbft_tpu_torch.ops.sha256 import digests_from_words, pad_message
from mirbft_tpu_torch.testengine import CryptoConfig, DeviceHashPlane, Spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # Each CPU shard runs the twins' many small ops (verify_torch: 1-2 s a
    # call); under several test workers the default intra-op pools
    # oversubscribe the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_port_observability():
    # tests/conftest.py resets the JAX package's registry only.
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    return ref.make_mesh(8)


def _pack(messages, max_blocks=2):
    blocks = np.zeros((len(messages), max_blocks, 16), dtype=np.uint32)
    n_blocks = np.zeros(len(messages), dtype=np.uint32)
    for i, message in enumerate(messages):
        padded = pad_message(message)
        blocks[i, : padded.shape[0]] = padded
        n_blocks[i] = padded.shape[0]
    return blocks, n_blocks


def _words(tensor):
    return tensor.numpy().view(np.uint32)


def _seeded_messages(seed, count, longest=100):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 256, size=int(rng.integers(0, longest)), dtype=np.uint8).tobytes()
        for _ in range(count)
    ]


def test_make_mesh_cpu_shards_and_cuda_needs_cards(monkeypatch):
    mesh = parallel.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.device_type == "cpu"
    assert mesh.axis_names == (parallel.BATCH_AXIS,) == ("batch",)
    assert parallel.make_mesh(device="cpu").size == 1
    # A CPU mesh never stands in for a missing card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="requested 1 devices, only 0 available"):
        parallel.make_mesh(1)
    with pytest.raises(ValueError):
        parallel.make_mesh()
    with pytest.raises(ValueError):
        parallel.make_mesh(0, device="cpu")


def test_sharded_sha256_matches_hashlib(mesh, ref_mesh):
    messages = [b"m%d" % i for i in range(32)] + _seeded_messages(0, 32)
    blocks, n_blocks = _pack(messages, max_blocks=4)
    words = _words(parallel.sharded_sha256(mesh)(blocks, n_blocks))
    assert digests_from_words(words) == [hashlib.sha256(m).digest() for m in messages]
    assert np.array_equal(words, np.asarray(ref.sharded_sha256(ref_mesh)(blocks, n_blocks)))


def test_distributed_verify_step_psum(mesh, ref_mesh):
    messages = [b"v%d" % i for i in range(16)]
    blocks, n_blocks = _pack(messages)
    words = _words(parallel.sharded_sha256(mesh)(blocks, n_blocks))
    verify = parallel.distributed_verify_step(mesh)
    ref_verify = ref.distributed_verify_step(ref_mesh)

    digests, mismatches = verify(blocks, n_blocks, words)
    assert int(mismatches) == 0 == int(ref_verify(blocks, n_blocks, words)[1])
    assert mismatches.dim() == 0 and np.array_equal(_words(digests), words)

    rng = np.random.default_rng(1)
    for rows in ([3, 11], [0, 5, 7, 15], list(range(16))):
        corrupted = words.copy()
        corrupted[rows, rng.integers(0, 8, size=len(rows))] ^= np.uint32(1 << 31)
        ref_digests, ref_count = ref_verify(blocks, n_blocks, corrupted)
        digests, mismatches = verify(blocks, n_blocks, corrupted)
        assert int(mismatches) == int(ref_count) == len(rows)
        assert np.array_equal(_words(digests), np.asarray(ref_digests))


def test_all_reduce_gives_every_device_the_global_count(mesh):
    counts = [torch.tensor(i, dtype=torch.int32) for i in range(8)]
    totals = parallel.all_reduce_counts(mesh, counts)
    assert len(totals) == 8 and all(int(t) == 28 for t in totals)
    # Each device's total is its own tensor, not a shard's count.
    assert all(t is not c for t in totals for c in counts)


def test_graft_entry_dryrun():
    import __graft_entry__ as graft

    from mirbft_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert tuple(out.shape) == (256, 8)
    ref_fn, ref_args = graft.entry()
    assert np.array_equal(_words(out), np.asarray(ref_fn(*ref_args)))
    counters = graft_entry.dryrun_multichip(8, device="cpu")
    assert counters["mesh_verify_dispatches"] > 0 and counters["mesh_hash_dispatches"] > 0


def _signed(count, corrupt_rows, seed_base=9):
    pubs, msgs, sigs = [], [], []
    for i in range(count):
        pub, sign = keypair_from_seed((i + seed_base).to_bytes(4, "big") * 8)
        m = b"par-%d" % i
        sig = sign(m)
        if i in corrupt_rows:
            sig = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
        pubs.append(pub)
        msgs.append(m)
        sigs.append(sig)
    return pubs, msgs, sigs


def test_sharded_ed25519_verify_byzantine_psum(mesh, ref_mesh):
    """Per-shard verdicts match the reference's, padding rows (real=False)
    fail but are not counted, and the all-reduced invalid count is global."""
    pubs, msgs, sigs = _signed(6, corrupt_rows=(2, 5))  # rows 6..7 are padding
    packed = Ed25519BatchVerifier(min_device_batch=1, device="cpu").pack_inputs(
        pubs, msgs, sigs, batch=8
    )
    ref_packed = RefVerifier(min_device_batch=1).pack_inputs(pubs, msgs, sigs, batch=8)
    for a, b in zip(packed, ref_packed):
        assert np.array_equal(a, b)
    real = np.arange(8) < len(sigs)
    ok, invalid = parallel.sharded_ed25519_verify(mesh)(*packed, real)
    ref_ok, ref_invalid = ref.sharded_ed25519_verify(ref_mesh)(*ref_packed, real)
    expected = np.array([verify_one(p, m, s) for p, m, s in zip(pubs, msgs, sigs)])
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert (ok.numpy()[: len(sigs)] == expected).all()
    assert not ok.numpy()[len(sigs):].any()
    assert int(invalid) == int(ref_invalid) == int((~expected).sum()) == 2


def test_mxu_multiply_on_a_cpu_mesh():
    """kernel="mxu" (the nibble-matmul field multiply) runs its twin on a
    CPU mesh, equal to the JAX package's mxu mesh verify; a CUDA mesh takes
    it too (its shards launch the mxu kernel: tests/test_torch_cuda.py), and
    an unknown kernel raises."""
    mesh, ref_mesh2 = parallel.make_mesh(2, device="cpu"), ref.make_mesh(2)
    pubs, msgs, sigs = _signed(3, corrupt_rows=(1,))
    packed = Ed25519BatchVerifier(min_device_batch=1, device="cpu").pack_inputs(
        pubs, msgs, sigs, batch=4
    )
    real = np.arange(4) < 3
    launches = (ed25519.ed25519_verify_kernel.launches, ed25519.ed25519_verify_mxu_kernel.launches)
    ok, invalid = parallel.sharded_ed25519_verify(mesh, kernel="mxu")(*packed, real)
    # CPU shards run the twin (verify_torch with _mul_mxu): no launch counted.
    assert launches == (ed25519.ed25519_verify_kernel.launches,
                        ed25519.ed25519_verify_mxu_kernel.launches)
    ref_ok, ref_invalid = ref.sharded_ed25519_verify(ref_mesh2, kernel="mxu")(*packed, real)
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert ok.numpy().tolist() == [True, False, True, False]
    assert int(invalid) == int(ref_invalid) == 1
    with pytest.raises(ValueError):
        parallel.sharded_ed25519_verify(mesh, kernel="tpu")
    cuda_mesh = parallel.Mesh([torch.device("cuda", 0)])
    assert callable(parallel.sharded_ed25519_verify(cuda_mesh, kernel="mxu"))
    with pytest.raises(ValueError):
        parallel.sharded_ed25519_verify(cuda_mesh, kernel="tpu")


def test_batch_that_does_not_divide_over_the_mesh_raises(mesh, ref_mesh):
    blocks, n_blocks = _pack([b"x%d" % i for i in range(12)])
    with pytest.raises(ValueError, match="does not divide"):
        parallel.sharded_sha256(mesh)(blocks, n_blocks)
    with pytest.raises(ValueError, match="does not divide"):
        parallel.distributed_verify_step(mesh)(blocks, n_blocks, np.zeros((12, 8), np.uint32))
    with pytest.raises(ValueError):
        np.asarray(ref.sharded_sha256(ref_mesh)(blocks, n_blocks))


def test_verifier_pads_to_a_mesh_of_six():
    """A mesh of 6: 10 signatures pad to 16 rows, then to 18, a multiple of
    the mesh; verdicts and counters equal the JAX package's verifier on its
    own mesh of 6."""
    pubs, msgs, sigs = _signed(10, corrupt_rows=(4, 9), seed_base=40)
    verifier = Ed25519BatchVerifier(
        min_device_batch=1, device="cpu", mesh=parallel.make_mesh(6, device="cpu")
    )
    assert verifier.kernel == "vpu"  # "auto" binds at construction
    ref_verifier = RefVerifier(min_device_batch=1, mesh=ref.make_mesh(6))
    got = verifier.verify_batch(pubs, msgs, sigs)
    want = ref_verifier.verify_batch(pubs, msgs, sigs)
    assert got.tolist() == want.tolist() == [i not in (4, 9) for i in range(10)]
    snap, ref_snap = metrics.snapshot(), ref_metrics.snapshot()
    for key in ("mesh_verify_dispatches", "mesh_verified_signatures"):
        assert snap[key] == ref_snap[key]
    assert snap["mesh_verified_signatures"] == 10


def _consensus(spec, registry):
    registry.default_registry.reset()
    rec = spec.recorder().recording()
    steps = rec.drain_clients(timeout=30_000_000)
    state = [
        (n.state.checkpoint_seq_no, n.state.checkpoint_hash, dict(n.state.committed_reqs))
        for n in rec.nodes
    ]
    return steps, state, registry.snapshot()


def test_auth_plane_drives_mesh_in_consensus_run():
    """Engine traffic through the mesh: a 16-node signed consensus run whose
    auth-plane verify waves execute on the 8-shard mesh (batch sharded,
    byzantine count all-reduced).  The run is step- and state-identical to
    the port's one-device run and to the JAX package's mesh run, the
    byzantine signer stays rejected, and the mesh counters prove the waves
    transited the mesh."""
    shape = dict(node_count=16, client_count=4, reqs_per_client=10, batch_size=5,
                 signed_requests=True,
                 tweak_recorder=lambda r: setattr(r.client_configs[2], "corrupt", True))
    plane = dict(device=True, auth_wave=64, auth_floor=8)

    steps_one, state_one, snap_one = _consensus(
        Spec(**shape, crypto=CryptoConfig(**plane, mesh_devices=0, torch_device="cpu")), metrics)
    steps_mesh, state_mesh, snap_mesh = _consensus(
        Spec(**shape, crypto=CryptoConfig(**plane, mesh_devices=8, torch_device="cpu")), metrics)
    steps_ref, state_ref, snap_ref = _consensus(
        RefSpec(**shape, crypto=RefCryptoConfig(**plane, mesh_devices=8)), ref_metrics)
    assert steps_mesh == steps_one == steps_ref
    assert state_mesh == state_one == state_ref, "mesh verdicts diverged"
    assert snap_one.get("mesh_verify_dispatches", 0) == 0
    assert snap_mesh.get("mesh_verify_dispatches", 0) > 0, "no verify wave transited the mesh"
    for key in ("mesh_verify_dispatches", "mesh_verified_signatures"):
        assert snap_mesh[key] == snap_ref[key]
    for _, _, committed in state_mesh:
        assert committed.get(2, 0) == 0  # byzantine signer never commits


def test_hash_plane_drives_mesh():
    """DeviceHashPlane with mesh_devices routes its hash waves through the
    batch-sharded mesh: digests identical to hashlib, to the one-device
    plane and to the JAX package's mesh plane, with the same mesh
    counters."""
    batches = [(b"mesh-req-%d" % i, b"y" * (i % 40)) for i in range(48)]
    expected = []
    for parts in batches:
        h = hashlib.sha256()
        for p in parts:
            h.update(p)
        expected.append(h.digest())

    single = DeviceHashPlane(device=True, wave_size=16, device_floor=1, torch_device="cpu")
    assert single.hash_batches(batches) == expected
    assert metrics.snapshot().get("mesh_hash_dispatches", 0) == 0

    metrics.default_registry.reset()
    plane = DeviceHashPlane(device=True, wave_size=16, device_floor=1, mesh_devices=8,
                            torch_device="cpu")
    assert plane.hash_batches(batches) == expected
    ref_plane = RefDeviceHashPlane(device=True, wave_size=16, device_floor=1, mesh_devices=8)
    assert ref_plane.hash_batches(batches) == expected
    snap, ref_snap = metrics.snapshot(), ref_metrics.snapshot()
    assert snap.get("mesh_hash_dispatches", 0) >= 1, "no hash wave transited the mesh"
    assert snap.get("mesh_hashed_messages", 0) >= len(batches)
    for key in ("mesh_hash_dispatches", "mesh_hashed_messages"):
        assert snap[key] == ref_snap[key]


def test_signed_recording_crosses_the_mesh_on_both_planes():
    """The dry run's consensus shape: a 4-node signed Recording whose hash
    waves (hash_floor 1) and verify waves both cross an 8-shard mesh, held
    to the JAX package's mesh Recording."""
    shape = dict(node_count=4, client_count=2, reqs_per_client=5, batch_size=2,
                 signed_requests=True,
                 tweak_recorder=lambda r: setattr(r.client_configs[1], "corrupt", True))
    plane = dict(device=True, hash_wave=4, hash_floor=1, auth_wave=8, auth_floor=2,
                 mesh_devices=8)
    steps, state, snap = _consensus(
        Spec(**shape, crypto=CryptoConfig(**plane, torch_device="cpu")), metrics)
    ref_steps, ref_state, ref_snap = _consensus(
        RefSpec(**shape, crypto=RefCryptoConfig(**plane)), ref_metrics)
    assert (steps, state) == (ref_steps, ref_state)
    for key in ("mesh_hash_dispatches", "mesh_hashed_messages", "mesh_verify_dispatches",
                "mesh_verified_signatures"):
        assert snap.get(key, 0) == ref_snap.get(key, 0) > 0, key


# ---------------------------------------------------------------------------
# csrc/mesh.cu compiled for the host.
# ---------------------------------------------------------------------------

HOST_WRAPPER = r"""
#define __host__
#define __device__
#include "{source}"

extern "C" void host_count(int mode, const void* words, const void* expected, void* ok,
                           const void* valid, const void* real, long long rows,
                           void* count, void* acc) {{
  const mesh::Args a{{mode, (const uint32_t*)words, (const uint32_t*)expected, (uint8_t*)ok,
                     (const uint8_t*)valid, (const uint8_t*)real, rows, (uint32_t*)count,
                     (unsigned long long*)acc}};
  mesh::count_host(a);
}}

extern "C" long long host_grid(long long rows) {{ return mesh::grid_of(rows); }}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """``csrc/mesh.cu`` built for the host: outside its kernel and launcher
    it is plain C++, and ``count_host`` runs the launch's grid thread by
    thread, each thread's grid-stride rows, then the warps' and blocks'
    sums in the card's order."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler is not None, "a C++ compiler is needed (the port's _native build uses it)"
    folder = tmp_path_factory.mktemp("mesh_host")
    source = folder / "host_mesh.cpp"
    source.write_text(HOST_WRAPPER.format(
        source=os.path.join(ROOT, "mirbft_tpu_torch", "csrc", "mesh.cu")))
    library = folder / "host_mesh.so"
    subprocess.run(
        [compiler, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(library), str(source)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(library))
    lib.host_grid.restype = ctypes.c_longlong
    return lib


def _host_count(lib, mode, arrays, rows):
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data) if a is not None else None  # noqa: E731
    count = np.full(1, 0xDEADBEEF, dtype=np.uint32)  # the launch stores it, unzeroed
    acc = np.zeros(1, dtype=np.uint64)  # the stream's accumulator, zero between launches
    if mode == "digests":
        words, expected = arrays
        args = (ptr(words), ptr(expected), None, None, None)
    else:
        ok, valid, real = arrays
        args = (None, None, ptr(ok), ptr(valid), ptr(real))
    lib.host_count(ctypes.c_int(0 if mode == "digests" else 1), *args,
                   ctypes.c_longlong(rows), ptr(count), ptr(acc))
    assert int(acc[0]) == 0  # the last block leaves it zero for the next launch
    return int(count[0])


# Row counts: one, under a warp, past a warp, past a block, and past the
# kernel's largest grid (132 x 4 blocks of 256 threads), so some threads
# take two rows of the grid-stride loop.
COUNT_ROWS = (0, 1, 7, 33, 257, 4097, 135_200)


@pytest.mark.parametrize("rows", COUNT_ROWS)
@pytest.mark.parametrize("mask", ["all", "none", "random"])
def test_count_kernel_compiled_for_the_host_follows_the_plain_version(host_build, rows, mask):
    rng = np.random.default_rng(rows * 3 + len(mask))
    # Digests: the rows picked by the mask differ in one random word.
    words = rng.integers(0, 1 << 32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)
    expected = words.copy()
    pick = {"all": np.ones(rows, bool), "none": np.zeros(rows, bool),
            "random": rng.random(rows) < 0.3}[mask]
    cols = rng.integers(0, 8, size=rows)
    expected[pick, cols[pick]] ^= rng.integers(1, 1 << 32, size=int(pick.sum()),
                                               dtype=np.uint64).astype(np.uint32)
    want = parallel.shard_count_torch(
        "digests", torch.from_numpy(words.view(np.int32)), torch.from_numpy(expected.view(np.int32)))
    assert _host_count(host_build, "digests", (words, expected), rows) == int(want) == int(pick.sum())

    # Verdicts: real rows by the mask, ok and valid random.
    ok = rng.random(rows) < 0.6
    valid = rng.random(rows) < 0.8
    real = pick.copy()
    ok_host = ok.astype(np.uint8)
    got = _host_count(host_build, "verdicts",
                      (ok_host, valid.astype(np.uint8), real.astype(np.uint8)), rows)
    ok_torch = torch.from_numpy(ok.copy())
    want = parallel.shard_count_torch("verdicts", ok_torch, torch.from_numpy(valid),
                                      torch.from_numpy(real))
    assert got == int(want) == int((real & ~(ok & valid)).sum())
    assert np.array_equal(ok_host.astype(bool), ok_torch.numpy())
    assert np.array_equal(ok_torch.numpy(), ok & valid)


def test_count_grid_is_capped_and_strides(host_build):
    assert host_build.host_grid(0) == 1 and host_build.host_grid(1) == 1
    assert host_build.host_grid(256) == 1 and host_build.host_grid(257) == 2
    assert host_build.host_grid(10 ** 7) == 132 * 4


def test_count_wrapper_checks_its_inputs():
    words = torch.zeros((4, 8), dtype=torch.int32)
    flags = torch.zeros(4, dtype=torch.bool)
    assert int(parallel.shard_count("digests", words, words.clone())) == 0
    with pytest.raises(ValueError):
        parallel.shard_count("popcount", words, words)
    with pytest.raises(ValueError):
        parallel.shard_count("digests", words, words[:3])
    with pytest.raises(TypeError):
        parallel.shard_count("digests", words, words.to(torch.int64))
    with pytest.raises(ValueError):
        parallel.shard_count("verdicts", flags, flags)
    with pytest.raises(TypeError):
        parallel.shard_count("verdicts", flags, flags, flags.to(torch.uint8))
    before = parallel.shard_count.launches
    assert int(parallel.shard_count("verdicts", flags.clone(), flags, ~flags)) == 4
    assert parallel.shard_count.launches == before  # CPU tensors take the plain version
