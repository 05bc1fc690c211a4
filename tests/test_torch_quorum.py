"""The port's quorum plane (``mirbft_tpu_torch/ops/quorum.py``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_quorum_plane.py``: the same numpy-seeded wave streams go
through the JAX program ``device_accumulate`` and the port's
``device_accumulate`` (its plain PyTorch version on CPU tensors), with a
resumed second stream, the popcount and crossing-band checks and the packer's
rejections.  Five edge inputs (a slot past W, slot -1, source 300, source
-1, one (slot, digest) twice in a wave) hold the port to the JAX program,
which clamps reads, drops out-of-range writes and counts duplicates twice,
where the numpy ``host_accumulate`` raises or counts once.  The CUDA source
``csrc/quorum.cu`` is also compiled for the host with the C++ compiler (its
three phases are plain C++, run over a wave's touches in turn where the card
puts a barrier) and held to the same results, with the digest gate included.
Everything is integer: every comparison is exact.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import as_tensors, gated_stream
from mirbft_tpu.ops import quorum as ref
from mirbft_tpu_torch.ops import quorum as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # The twins run many small ops; under several test workers, each with a
    # pool of intra-op threads, the pools oversubscribe the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_stream(rng, n_waves, n_nodes, w, d, k):
    waves = []
    for _ in range(n_waves):
        source = int(rng.integers(0, n_nodes))
        rows = set()
        for _ in range(int(rng.integers(1, k + 1))):
            rows.add((int(rng.integers(0, w)), int(rng.integers(0, d))))
        waves.append((source, sorted(rows)))
    return waves


def _jax(masks, counts, sources, touches, valid):
    return tuple(
        np.asarray(a)
        for a in ref.device_accumulate(masks, counts, sources, touches, valid)
    )


def _port(masks, counts, sources, touches, valid):
    tm, tc = port.quorum_state_to_torch(masks, counts, "cpu")
    out = port.device_accumulate(tm, tc, sources, touches, valid)
    m, c, p, n = (t.numpy() for t in out)
    return m.view(np.uint32), c, p, n


def _assert_same(got, want):
    for name, g, w in zip(("masks", "counts", "posts", "newbits"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_matches_jax_program_and_host_reference(seed):
    rng = np.random.default_rng(seed)
    w, d, k = 32, 3, 16
    n_nodes = 256 if seed == 2 else 64  # cover the multi-word range
    waves = random_stream(rng, n_waves=40, n_nodes=n_nodes, w=w, d=d, k=k)
    sources, touches, valid = port.pack_wave_stream(waves, k)
    masks0 = np.zeros((w, d, port.MASK_WORDS), dtype=np.uint32)
    counts0 = np.zeros((w, d), dtype=np.int32)

    got = _port(masks0, counts0, sources, touches, valid)
    _assert_same(got, _jax(masks0, counts0, sources, touches, valid))
    hm, hc, hp, hn = port.host_accumulate(masks0, counts0, sources, touches, valid)
    np.testing.assert_array_equal(got[0], hm)
    np.testing.assert_array_equal(got[1], hc)
    np.testing.assert_array_equal(got[2] * valid, hp * valid)
    np.testing.assert_array_equal(got[3], hn)

    # Resumed stream (second launch continues from the carried state).
    waves2 = random_stream(rng, n_waves=10, n_nodes=n_nodes, w=w, d=d, k=k)
    s2, t2, v2 = port.pack_wave_stream(waves2, k)
    _assert_same(_port(got[0], got[1], s2, t2, v2), _jax(got[0], got[1], s2, t2, v2))


def test_counts_match_mask_popcounts_and_crossings():
    rng = np.random.default_rng(7)
    w, d, k = 16, 2, 8
    waves = random_stream(rng, n_waves=200, n_nodes=64, w=w, d=d, k=k)
    sources, touches, valid = port.pack_wave_stream(waves, k)
    masks = np.zeros((w, d, port.MASK_WORDS), dtype=np.uint32)
    counts = np.zeros((w, d), dtype=np.int32)
    masks, counts, posts, _ = _port(masks, counts, sources, touches, valid)
    pop = np.zeros_like(counts)
    for word in range(port.MASK_WORDS):
        pop += np.vectorize(lambda x: bin(int(x)).count("1"))(
            masks[:, :, word]
        ).astype(np.int32)
    np.testing.assert_array_equal(pop, counts)

    wq, sq = 22, 43
    band = port.crossings(posts, wq, sq)
    np.testing.assert_array_equal(band, np.isin(posts, (wq - 1, wq, sq - 1, sq)))
    np.testing.assert_array_equal(band, ref.crossings(posts, wq, sq))


def test_pack_rejects_duplicates_and_overflow():
    with pytest.raises(ValueError):
        port.pack_wave_stream([(0, [(1, 0), (1, 0)])], k=4)
    with pytest.raises(ValueError):
        port.pack_wave_stream([(0, [(i, 0) for i in range(5)])], k=4)


# Edge inputs at W = 4, D = 2, K = 4.  Each stream starts from state a first
# wave (source 33, slots (0, 0), (3, 1), (1, 1)) leaves, so clamped reads
# see set bits; the second wave holds the edge.
EDGE_W, EDGE_D, EDGE_K = 4, 2, 4
EDGES = {
    "slot_W": (5, [(EDGE_W, 1), (2, 0)]),
    "slot_minus_1": (5, [(-1, 1), (2, 0)]),
    "source_300": (300, [(0, 0), (1, 1)]),
    "source_minus_1": (-1, [(0, 0), (3, 1)]),
    "duplicate_touch": (7, [(1, 1), (1, 1), (2, 0)]),
}


def _edge_stream(name):
    source, rows = EDGES[name]
    sources = np.array([33, source], dtype=np.int32)
    touches = np.zeros((2, EDGE_K, 2), dtype=np.int32)
    valid = np.zeros((2, EDGE_K), dtype=bool)
    for j, row in enumerate([(0, 0), (3, 1), (1, 1)]):
        touches[0, j], valid[0, j] = row, True
    for j, row in enumerate(rows):
        touches[1, j], valid[1, j] = row, True
    masks = np.zeros((EDGE_W, EDGE_D, port.MASK_WORDS), dtype=np.uint32)
    counts = np.zeros((EDGE_W, EDGE_D), dtype=np.int32)
    return masks, counts, sources, touches, valid


@pytest.mark.parametrize("name", list(EDGES))
def test_edge_inputs_follow_the_jax_program(name):
    stream = _edge_stream(name)
    want = _jax(*stream)
    got = _port(*stream)
    _assert_same(got, want)
    masks, counts, posts, newbits = got
    if name == "slot_W":
        # The read clamps to row W - 1: its count is the post; nothing moves.
        assert newbits[1, 0] and posts[1, 0] == counts[EDGE_W - 1, 1] == 1
    elif name == "source_300":
        # Word 9 reads word 7 and writes nowhere; the count still grows.
        assert newbits[1, 0] and counts[0, 0] == 2
        assert (masks[0, 0] == [0, 2, 0, 0, 0, 0, 0, 0]).all()
    elif name == "source_minus_1":
        assert masks[0, 0, 7] == 1 << 31
    elif name == "duplicate_touch":
        # Both touches read the old word: both new, the count grows by two.
        assert newbits[1, :2].all() and (posts[1, :2] == 3).all()
    if name in ("slot_W", "source_300"):
        with pytest.raises(IndexError):
            port.host_accumulate(*stream)
    elif name == "duplicate_touch":
        assert port.host_accumulate(*stream)[1][1, 1] == 2


# ---------------------------------------------------------------------------
# csrc/quorum.cu built for the host.
# ---------------------------------------------------------------------------

CARD_CAPACITY = 4096  # quorum::kCapacity: touches a chunk holds on the card
CARD_DIRECT_ROWS = 1 << 14  # quorum::kDirectRows: W x D rows found through the direct map

HOST_WRAPPER = """
#define __host__
#define __device__
#include "{source}"
extern "C" void host_accumulate(
    void* masks, void* counts, long long W, long long D, const void* sources,
    const void* touches, const void* valid, long long N, long long K,
    const void* prev_words, long long P, const void* digests, long long B,
    const void* digest_rows, const void* claimed, const void* row_groups,
    const void* touch_groups, void* posts, void* newbits, long long capacity,
    long long direct_rows) {{
  const quorum::Stream s{{
      (uint32_t*)masks, (int32_t*)counts, W, D, (const int32_t*)sources,
      (const int32_t*)touches, (const uint8_t*)valid, N, K,
      (const uint32_t*)prev_words, P, (const uint32_t*)digests, B,
      (const int32_t*)digest_rows, (const uint32_t*)claimed,
      (const int32_t*)row_groups, (const int32_t*)touch_groups,
      (int32_t*)posts, (uint8_t*)newbits}};
  quorum::accumulate_host(s, capacity, direct_rows);
}}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """``csrc/quorum.cu`` built for the host: outside its kernel and
    launcher it is plain C++, and ``accumulate_host`` runs the kernel's
    stages (the table, its chunks and the global branch for waves wider
    than the table), each over every index in turn, at the capacity and
    with the direct map's row limit it is given (0: the hash table)."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler is not None, "a C++ compiler is needed (the port's _native build uses it)"
    folder = tmp_path_factory.mktemp("quorum_host")
    source = folder / "host_quorum.cpp"
    source.write_text(HOST_WRAPPER.format(
        source=os.path.join(ROOT, "mirbft_tpu_torch", "csrc", "quorum.cu")))
    library = folder / "host_quorum.so"
    subprocess.run(
        [compiler, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(library), str(source)],
        check=True, capture_output=True, timeout=120,
    )
    return ctypes.CDLL(str(library))


def _host(lib, masks, counts, sources, touches, valid, gate=None, capacity=CARD_CAPACITY,
          direct_rows=CARD_DIRECT_ROWS):
    n, k = valid.shape
    if gate is None:
        gate = (np.zeros((0, 8), np.uint32), np.zeros((0, 8), np.uint32),
                np.full((n, k), -1, np.int32), np.zeros((n, k, 8), np.uint32),
                np.zeros(0, np.int32), np.zeros((n, k), np.int32))
    masks = np.array(masks, dtype=np.uint32)
    counts = np.array(counts, dtype=np.int32)
    posts = np.full((n, k), -7, dtype=np.int32)
    newbits = np.full((n, k), 7, dtype=np.uint8)
    arrays = [np.ascontiguousarray(a) for a in (sources, touches, valid.astype(np.uint8), *gate)]
    prev, digests = arrays[3], arrays[4]
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    lib.host_accumulate(
        ptr(masks), ptr(counts), ctypes.c_longlong(masks.shape[0]),
        ctypes.c_longlong(masks.shape[1]), ptr(arrays[0]), ptr(arrays[1]), ptr(arrays[2]),
        ctypes.c_longlong(n), ctypes.c_longlong(k), ptr(prev), ctypes.c_longlong(prev.shape[0]),
        ptr(digests), ctypes.c_longlong(digests.shape[0]),
        *(ptr(a) for a in arrays[5:]), ptr(posts), ptr(newbits), ctypes.c_longlong(capacity),
        ctypes.c_longlong(direct_rows),
    )
    return masks, counts, posts, newbits.astype(bool)


@pytest.mark.parametrize("case", ["seed0", "seed2", *EDGES])
def test_kernel_source_compiled_for_the_host_follows_the_jax_program(case, host_build):
    if case.startswith("seed"):
        rng = np.random.default_rng(int(case[4:]))
        waves = random_stream(rng, n_waves=40, n_nodes=256, w=32, d=3, k=16)
        sources, touches, valid = port.pack_wave_stream(waves, 16)
        stream = (np.zeros((32, 3, 8), np.uint32), np.zeros((32, 3), np.int32),
                  sources, touches, valid)
    else:
        stream = _edge_stream(case)
    _assert_same(_host(host_build, *stream), _jax(*stream))


def _gate_inputs(seed, n=16, k=40, w=8, d=2, p=5, b=12):
    """A gated stream from the smoke's generator, as (stream, gate) host
    arrays and their CPU tensors."""
    arrays = gated_stream(np.random.default_rng(seed), w, d, n, k, p, b)
    return (arrays[:5], arrays[5:]), as_tensors(arrays, "cpu")


def test_gate_and_scan_compiled_for_the_host_equal_the_plain_version(host_build):
    (stream, gate), tensors = _gate_inputs(3)
    want = port.quorum_accumulate_torch(*tensors[:5], tuple(tensors[5:]))
    got = _host(host_build, *stream, gate=gate)
    assert 0 < int(want[3].sum()) < want[3].numel()
    _assert_same(got, (want[0].numpy().view(np.uint32), *(t.numpy() for t in want[1:])))
    # The wrapper updates the state in place and returns the same posts.
    masks, counts = tensors[0].clone(), tensors[1].clone()
    posts, newbits = port.quorum_accumulate(masks, counts, *tensors[2:5], tuple(tensors[5:]))
    for a, b in zip((masks, counts, posts, newbits), want):
        assert torch.equal(a, b)
    assert port.quorum_accumulate.launches == 0  # CPU tensors launch nothing


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, tensors = _gate_inputs(4, n=2, k=4)
    with pytest.raises(TypeError):
        port.quorum_accumulate(tensors[0].to(torch.int64), *tensors[1:5], tuple(tensors[5:]))
    with pytest.raises(ValueError):
        port.quorum_accumulate(*tensors[:3], tensors[3][:, :2].contiguous(), tensors[4],
                               tuple(tensors[5:]))
    with pytest.raises(ValueError):
        bad = list(tensors[5:])
        bad[4] = bad[4][:-1].contiguous()  # row_groups shorter than P + B
        port.quorum_accumulate(*tensors[:5], tuple(bad))


# ---------------------------------------------------------------------------
# The staged kernel at a small table: chunks, the global branch, shared rows.
# ---------------------------------------------------------------------------

SMALL_CAPACITY = 16  # touches a chunk holds in these cases


def _plan(lib, w, d, n, k, capacity):
    """The host build's plan of a launch: (chunk_waves, chunks); chunk_waves
    0 is the global branch."""
    out = (ctypes.c_longlong * 8)()
    lib.mirbft_quorum_plan(*(ctypes.c_longlong(v) for v in (w, d, n, k, capacity)), out)
    return out[1], out[2]


def _waves_stream(w, d, k, waves):
    """Hand-written waves [(source, [(slot, digest), ...])], duplicates and
    out-of-range indices allowed, packed to K touches from zero state."""
    n = len(waves)
    sources = np.array([src for src, _ in waves], dtype=np.int32)
    touches = np.zeros((n, k, 2), dtype=np.int32)
    valid = np.zeros((n, k), dtype=bool)
    for i, (_, rows) in enumerate(waves):
        for j, row in enumerate(rows):
            touches[i, j], valid[i, j] = row, True
    return (np.zeros((w, d, 8), np.uint32), np.zeros((w, d), np.int32),
            sources, touches, valid)


def _small_table_case(case):
    """(stream, capacity, expected (chunk_waves, chunks) or None)."""
    rng = np.random.default_rng(11)
    if case == "overflow_chunks":
        # ~96 distinct rows over 40 waves of 4: ten chunks of four waves.
        waves = random_stream(rng, n_waves=40, n_nodes=256, w=32, d=3, k=4)
        stream = (np.zeros((32, 3, 8), np.uint32), np.zeros((32, 3), np.int32),
                  *port.pack_wave_stream(waves, 4))
        return stream, SMALL_CAPACITY, (4, 10)
    if case == "one_wave_chunks":
        waves = random_stream(rng, n_waves=30, n_nodes=64, w=8, d=2, k=6)
        stream = (np.zeros((8, 2, 8), np.uint32), np.zeros((8, 2), np.int32),
                  *port.pack_wave_stream(waves, 6))
        return stream, 6, (1, 30)
    if case == "block_waves":
        # 32 < K: a block a wave, three phases and shared atomics.
        waves = random_stream(rng, n_waves=12, n_nodes=256, w=32, d=3, k=40)
        stream = (np.zeros((32, 3, 8), np.uint32), np.zeros((32, 3), np.int32),
                  *port.pack_wave_stream(waves, 40))
        return stream, 128, (3, 4)
    if case == "wide_wave_global":
        waves = random_stream(rng, n_waves=12, n_nodes=256, w=16, d=2, k=24)
        stream = (np.zeros((16, 2, 8), np.uint32), np.zeros((16, 2), np.int32),
                  *port.pack_wave_stream(waves, 24))
        return stream, SMALL_CAPACITY, (0, 0)
    if case.startswith("clamped_shares_row"):
        # Slot W and W + 1 read row W - 1 (slot -1 writes it) and write
        # nothing, in the wave of an in-range write to it and in later ones.
        w, d = 4, 2
        stream = _waves_stream(w, d, 4, [
            (33, [(w, 1), (3, 1), (0, 0)]),
            (5, [(3, 1), (w + 1, 1), (-1, 1), (w, 1)]),
            (33, [(w, 1), (3, 1)]),
            (70, [(w + 3, -1), (-1, 1)]),
            (5, [(w, 1)]),
        ])
        capacity = 4 if case.endswith("one_wave_chunks") else SMALL_CAPACITY
        return stream, capacity, (1, 5) if capacity == 4 else (4, 2)
    if case == "probe_wraps":
        # Three rows hash to the table's last slot (the kernel's hash:
        # key x 2654435761 mod 2^32, top 5 bits of 32 slots), so their
        # probes wrap to slots 0 and 1, which other rows want too.
        w, d = 64, 4
        slot = [((key * 2654435761) % 2**32) >> 27 for key in range(w * d)]
        last = [key for key in range(w * d) if slot[key] == 31][:3]
        first = [key for key in range(w * d) if slot[key] in (0, 1)][:4]
        rows = [divmod(key, d) for key in last + first]
        stream = _waves_stream(w, d, 16, [(3, rows), (4, rows[::-1]), (3, rows[2:])])
        return stream, SMALL_CAPACITY, (1, 3)
    if case == "quiet_chunks":
        # Chunks where no touch may write (invalid, gated shut, or out of
        # range for writing) between chunks that write: the first chunk's
        # newbits still come from its gates and bits.
        w, d = 4, 2
        stream = _waves_stream(w, d, 4, [
            (33, [(w, 1), (w + 2, 0)]),
            (2, [(0, 0), (3, 1)]),
            (33, [(3, 1), (1, 0)]),
            (2, [(w, 1)]),
        ])
        stream[4][1] = False  # wave 1 invalid: chunk 0 (waves 0-1) cannot write
        return stream, 8, (2, 2)
    if case == "duplicates":
        stream = _waves_stream(4, 2, 4, [
            (7, [(1, 1), (1, 1), (2, 0), (1, 1)]),
            (7, [(1, 1), (2, 0), (2, 0)]),
            (8, [(2, 0), (2, 0), (-3, 0), (1, -1)]),
        ])
        return stream, SMALL_CAPACITY, (3, 1)
    if case == "sources_past_256":
        # Word 9 and -9 read words 7 and 0 and write no mask; counts grow.
        stream = _waves_stream(4, 2, 4, [
            (40, [(0, 0), (1, 1)]),
            (300, [(0, 0), (1, 1), (3, 0)]),
            (300, [(0, 0)]),
            (-260, [(1, 1), (0, 0)]),
            (-1, [(0, 0)]),
            (511, [(0, 0), (1, 1)]),
        ])
        return stream, 8, (2, 3)
    raise KeyError(case)


SMALL_TABLE_CASES = ["overflow_chunks", "one_wave_chunks", "block_waves", "wide_wave_global",
                     "clamped_shares_row", "clamped_shares_row_one_wave_chunks",
                     "probe_wraps", "quiet_chunks", "duplicates", "sources_past_256"]


@pytest.mark.parametrize("case", SMALL_TABLE_CASES)
def test_staged_kernel_at_a_small_table_follows_the_jax_program(case, host_build):
    stream, capacity, plan = _small_table_case(case)
    masks, counts, _, touches, valid = stream
    assert _plan(host_build, *masks.shape[:2], *valid.shape, capacity) == plan
    want = _jax(*stream)
    for direct_rows in (CARD_DIRECT_ROWS, 0):  # the direct map, then the hash table
        _assert_same(_host(host_build, *stream, capacity=capacity, direct_rows=direct_rows), want)
    _assert_same(_port(*stream), want)
    got_masks, got_counts, posts, newbits = want
    if case == "sources_past_256":
        # Only source 40 (word 1) and -1 (word 7) set bits; counts grew by
        # every new touch: 300 twice (word 7 still clear), -260 and -1 at
        # (0, 0), but not 511, whose bit 31 of word 7 -1 had set.
        assert got_counts[0, 0] == 5 and got_counts[1, 1] == 4
        assert newbits[2, 0] and not newbits[5, 0] and newbits[5, 1]
        assert (got_masks[0, 0] == [0, 1 << 8, 0, 0, 0, 0, 0, 1 << 31]).all()
    elif case == "duplicates":
        assert newbits[0, :2].all() and newbits[0, 3] and posts[0, 0] == 3
    elif case.startswith("clamped_shares_row"):
        # Row (3, 1)'s count is the clamped touches' post in every wave.
        assert (posts[valid & (touches[..., 0] >= 4)] > 0).all()


@pytest.mark.parametrize("capacity,k", [(1, 8), (8, 8), (40, 8), (200, 8), (80, 40)],
                         ids=["1", "8", "40", "200", "k40-80"])
def test_staged_kernel_chunks_a_gated_stream_like_the_plain_version(capacity, k, host_build):
    """A gated stream (claims that match and do not, group tags with -1,
    indices and sources out of range) at table capacities that run it in
    one chunk a wave, several or one, or (K > capacity) on the global
    branch, with a warp a wave (K = 8) or a block (K = 40), held to the
    plain version and to the JAX program fed the JAX gate."""
    import jax.numpy as jnp

    n = 24
    (stream, gate), tensors = _gate_inputs(5, n=n, k=k, w=6, d=2, p=5, b=12)
    chunk_waves, _ = _plan(host_build, 6, 2, n, k, capacity)
    assert chunk_waves == (0 if capacity < k else min(n, capacity // k))
    want = port.quorum_accumulate_torch(*tensors[:5], tuple(tensors[5:]))
    want = (want[0].numpy().view(np.uint32), *(t.numpy() for t in want[1:]))
    assert 0 < int(want[3].sum()) < want[3].size
    assert (gate[4] == -1).any() and (gate[5] == -1).any()
    for direct_rows in (CARD_DIRECT_ROWS, 0):  # the direct map, then the hash table
        _assert_same(_host(host_build, *stream, gate=gate, capacity=capacity,
                           direct_rows=direct_rows), want)
    # The JAX program's gate (``_fused_body``'s) on the same tables.
    prev, digests, rows, claimed, row_groups, groups = (jnp.asarray(a) for a in gate)
    combined = jnp.concatenate([prev, digests], axis=0)
    picked = jnp.clip(rows, 0, combined.shape[0] - 1)
    eq = jnp.all(combined[picked] == claimed, axis=-1)
    gated = np.asarray(jnp.asarray(stream[4]) & ((rows < 0) | (eq & (row_groups[picked] == groups))))
    _assert_same(_jax(*stream[:4], gated), want)
