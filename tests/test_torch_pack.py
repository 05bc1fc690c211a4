"""The port's staged SHA-256 waves (``mirbft_tpu_torch/ops/pack.py``) against
the JAX package's host packer, on the CPU.

A staged wave (raw bytes, offsets and lengths in one pooled buffer) packed
by the pack kernel's plain PyTorch version must give, word for word, what
the JAX package's ``pack_messages`` gives for the same messages, layout and
buckets: both layouts, the padding boundaries, empty messages, bucket
overrides, ``batch_multiple`` and hypothesis-drawn ragged waves.
``csrc/pack.cu`` is also compiled for the host with the C++ compiler, where
``pack_host`` runs the kernel's grid CTA by CTA through the same index
math.  Then the staging pool: a lease is refilled only once its wave's
event is done, and a wave that outgrows its buffer moves to a larger one.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mirbft_tpu.ops import sha256 as ref
from mirbft_tpu_torch.ops import pack
from mirbft_tpu_torch.ops.pack import StagingPool, pack_wave, pack_wave_torch, stage_messages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# SHA-256 padding boundaries (55/56 and 119/120 straddle a block's last 8
# bytes), empty and one-byte messages, and the fused bench's 640 bytes.
BOUNDARY = (0, 1, 55, 56, 63, 64, 119, 120, 640)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # Under several test workers torch's intra-op pools oversubscribe the
    # cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _messages(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]


def _staged_words(messages, layout, **kw):
    """The plain version over a staged wave: (blocks, n_blocks) as uint32."""
    wave = stage_messages(messages, layout=layout, pool=StagingPool(pinned=False), **kw)
    t = wave.views(wave.copy_in(torch.device("cpu")))
    blocks, n_blocks = pack_wave(t["raw"], t["offsets"], t["lengths"], wave.batch,
                                 wave.bucket, layout)
    assert tuple(blocks.shape) == wave.blocks_shape
    return wave, blocks.numpy().view(np.uint32), n_blocks.numpy().view(np.uint32)


def _assert_equal_to_reference(messages, layout, **kw):
    _, blocks, n_blocks = _staged_words(messages, layout, **kw)
    want = ref.pack_messages(messages, layout=layout, **kw)
    assert blocks.shape == want.blocks.shape and n_blocks.shape == want.n_blocks.shape
    assert blocks.tobytes() == want.blocks.tobytes()
    assert n_blocks.tobytes() == want.n_blocks.tobytes()


# Ragged lengths of 1,025 rows: two lanes tiles, sixteen row groups of the
# kernel's grid in the batch layout.
TWO_TILES = tuple(int(n) for n in np.random.default_rng(7).integers(0, 200, size=1025))

CASES = {
    "boundaries": (BOUNDARY, {}),
    "empty_messages": ((0, 0, 0), {}),
    "one_message": ((640,), {}),
    "block_bucket": ((5, 70, 200), {"block_bucket": 16}),
    "batch_bucket": ((5, 70, 200), {"batch_bucket": 64}),
    "both_buckets": (BOUNDARY, {"block_bucket": 32, "batch_bucket": 32}),
    "batch_multiple": ((3, 90, 17, 64, 0), {"batch_multiple": 3}),
    "two_tiles": (TWO_TILES, {}),
    "long_message": ((5000, 3), {}),
    # One row alone at each padding boundary: a one-row wave's buckets.
    **{f"single_{n}": ((n,), {}) for n in BOUNDARY},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layout", ["batch", "lanes"])
def test_staged_wave_packs_as_the_reference_packer(layout, case):
    lengths, kw = CASES[case]
    if layout == "lanes" and "batch_multiple" in kw:
        kw = {}  # a lanes wave is whole tiles; only the mesh sets a multiple
    _assert_equal_to_reference(_messages(lengths, seed=len(lengths)), layout, **kw)


@pytest.mark.parametrize("layout", ["batch", "lanes"])
@settings(max_examples=20, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(lengths=st.lists(st.integers(0, 300), min_size=0, max_size=64),
       seed=st.integers(0, 2**16))
def test_ragged_waves_pack_as_the_reference_packer(layout, lengths, seed):
    _assert_equal_to_reference(_messages(lengths, seed), layout)


def test_plain_version_pads_each_row():
    """Row by row against the per-message padding of the JAX package."""
    messages = _messages(BOUNDARY, seed=5)
    _, blocks, n_blocks = _staged_words(messages, "batch")
    for i, m in enumerate(messages):
        padded = ref.pad_message(m)
        assert n_blocks[i] == padded.shape[0]
        assert (blocks[i, : padded.shape[0]] == padded).all()
        assert not blocks[i, padded.shape[0]:].any()
    assert not blocks[len(messages):].any() and not n_blocks[len(messages):].any()


def test_staged_sections_hold_the_raw_wave():
    """The staged buffer holds the messages back to back, each row's first
    byte and its length: nothing padded or packed on the host."""
    messages = _messages(BOUNDARY, seed=9)
    wave, _, _ = _staged_words(messages, "lanes")
    assert list(wave.sections) == ["raw", "offsets", "lengths"]
    assert wave.section("raw").tobytes() == b"".join(messages)
    lengths = [len(m) for m in messages]
    assert wave.section("lengths").tolist() == lengths
    assert wave.section("offsets").tolist() == [sum(lengths[:i]) for i in range(len(lengths))]
    assert all(offset % 16 == 0 for offset, _, _ in wave.sections.values())


@pytest.mark.parametrize("layout", ["batch", "lanes"])
def test_staged_wave_packs_from_its_copied_buffer(layout):
    """``StagedWave.pack`` over ``copy_in``'s buffer (on the CPU the buffer
    itself, the plain version over its sections) gives the words of
    ``pack_wave`` over the sections' views."""
    messages = _messages(BOUNDARY + (300, 5), seed=13)
    wave = stage_messages(messages, layout=layout, pool=StagingPool(pinned=False))
    flat = wave.copy_in(torch.device("cpu"))
    assert flat.data_ptr() == wave.lease.flat.data_ptr() and flat.numel() % 16 == 0
    assert flat.numel() >= wave.nbytes
    t = wave.views(flat, ("raw", "offsets", "lengths"))
    assert list(t) == ["raw", "offsets", "lengths"]
    want = pack_wave(t["raw"], t["offsets"], t["lengths"], wave.batch, wave.bucket, layout)
    got = wave.pack(flat)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_views_give_each_section_its_dtype_and_shape():
    wave = stage_messages(_messages((7, 70), seed=2), pool=StagingPool(pinned=False))
    wave.add("pairs", np.arange(6, dtype=np.int32).reshape(3, 2))
    wave.add("flags", np.array([True, False, True]))
    t = wave.views(wave.copy_in(torch.device("cpu")), ("pairs", "flags", "lengths"))
    assert list(t) == ["pairs", "flags", "lengths"]
    assert t["pairs"].dtype == torch.int32 and t["pairs"].tolist() == [[0, 1], [2, 3], [4, 5]]
    assert t["flags"].dtype == torch.bool and t["flags"].tolist() == [True, False, True]
    assert t["lengths"].tolist() == [7, 70]


def test_wrapper_checks_its_inputs():
    raw = torch.zeros(16, dtype=torch.uint8)
    offsets = torch.zeros(2, dtype=torch.int64)
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    before = pack_wave.launches
    blocks, n_blocks = pack_wave(raw, offsets, lengths, 2, 1, "batch")
    assert tuple(blocks.shape) == (2, 1, 16) and n_blocks.tolist() == [1, 1]
    assert pack_wave.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError):
        pack_wave(raw, offsets, lengths, 2, 1, "diagonal")
    with pytest.raises(TypeError):
        pack_wave(raw, offsets, lengths.to(torch.int64), 2, 1, "batch")
    with pytest.raises(ValueError):
        pack_wave(raw, offsets[:1], lengths, 2, 1, "batch")
    with pytest.raises(ValueError):
        pack_wave(raw, offsets, lengths, 1, 1, "batch")  # more rows than the wave
    with pytest.raises(ValueError):
        pack_wave(raw, offsets, lengths, 2, 1, "lanes")  # no whole tile


def test_pool_refills_a_lease_only_once_its_wave_is_done():
    class Event:
        done = False

        def query(self):
            return self.done

    pool = StagingPool(pinned=False)
    first = stage_messages([b"abc"] * 4, pool=pool)
    busy = Event()
    first.lease.event = busy
    pool.release(first.lease)
    second = stage_messages([b"abc"] * 4, pool=pool)
    assert second.lease is not first.lease  # in flight: never refilled
    pool.release(second.lease)
    third = stage_messages([b"abc"] * 4, pool=pool)
    assert third.lease is second.lease  # idle: reused
    busy.done = True
    fourth = stage_messages([b"abc"] * 4, pool=pool)
    assert fourth.lease is first.lease  # done now: reused
    assert pool._free[("staged", pack._MIN_CAPACITY)] == []


def test_a_wave_that_outgrows_its_buffer_moves_to_a_larger_one():
    pool = StagingPool(pinned=False)
    messages = _messages((100, 7, 640), seed=3)
    wave = stage_messages(messages, pool=pool)
    small = wave.lease
    extra = np.arange(pack._MIN_CAPACITY, dtype=np.int32)
    wave.add("extra", extra)
    assert wave.lease is not small and wave.lease.flat.numel() == 8 * pack._MIN_CAPACITY
    assert not pool._free.get(small.key)  # one lease a wave: the small one is dropped
    assert wave.section("raw").tobytes() == b"".join(messages)
    t = wave.views(wave.copy_in(torch.device("cpu")))
    assert np.array_equal(t["extra"].numpy(), extra)
    assert t["offsets"].dtype == torch.int64 and t["lengths"].dtype == torch.int32


# ---------------------------------------------------------------------------
# csrc/pack.cu compiled for the host.
# ---------------------------------------------------------------------------

HOST_WRAPPER = r"""
#define __host__
#define __device__
#include "{source}"

extern "C" void host_pack(const void* raw, long long raw_bytes, const void* offsets,
                          const void* lengths, long long n, long long batch, long long bucket,
                          int layout, void* blocks, void* n_blocks) {{
  const pack::Args a{{(const uint8_t*)raw, raw_bytes, 1, (const long long*)offsets,
                     (const int32_t*)lengths, n, batch, bucket, layout,
                     (uint32_t*)blocks, (uint32_t*)n_blocks}};
  pack::pack_host(a);
}}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """``csrc/pack.cu`` built for the host: outside its kernel and launcher
    it is plain C++, and ``pack_host`` runs the launch's grid CTA by CTA,
    each of the kernel's passes over its threads in turn."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler is not None, "a C++ compiler is needed (the port's _native build uses it)"
    folder = tmp_path_factory.mktemp("pack_host")
    source = folder / "host_pack.cpp"
    source.write_text(HOST_WRAPPER.format(
        source=os.path.join(ROOT, "mirbft_tpu_torch", "csrc", "pack.cu")))
    library = folder / "host_pack.so"
    subprocess.run(
        [compiler, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(library), str(source)],
        check=True, capture_output=True, timeout=120,
    )
    return ctypes.CDLL(str(library))


# The kernel's grid at the shapes that stress its index math: one partial
# row group, several groups, two lanes tiles, blocks past every row's last
# (a block bucket override), a batch that is no multiple of the 128-row
# group (a batch bucket override), a 128-block bucket, and no rows at all.
HOST_CASES = {
    "boundary": (BOUNDARY, {}),
    "130x640": ((640,) * 130, {}),
    "empty": ((), {}),
    "two_tiles": (TWO_TILES, {}),
    "block_bucket": ((5, 70, 200), {"block_bucket": 16}),
    "batch_bucket_300": ((5, 70, 200), {"batch_bucket": 300}),
    "long_message": ((5000, 3), {}),
    # One row alone at each padding boundary: its bytes end the buffer,
    # so its last granule is cut short.
    **{f"single_{n}": ((n,), {}) for n in BOUNDARY},
}


@pytest.mark.parametrize("layout", ["batch", "lanes"])
@pytest.mark.parametrize("case", list(HOST_CASES))
def test_pack_kernel_compiled_for_the_host_packs_as_the_reference(host_build, layout, case):
    lengths, kw = HOST_CASES[case]
    messages = _messages(lengths, seed=len(lengths))
    wave = stage_messages(messages, layout=layout, pool=StagingPool(pinned=False), **kw)
    want = ref.pack_messages(messages, layout=layout, **kw)
    blocks = np.full(want.blocks.shape, 0xDEADBEEF, dtype=np.uint32)  # every word written
    n_blocks = np.full(wave.batch, 0xDEADBEEF, dtype=np.uint32)
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    raw, offsets, lengths_ = (np.ascontiguousarray(wave.section(k))
                              for k in ("raw", "offsets", "lengths"))
    host_build.host_pack(ptr(raw), ctypes.c_longlong(raw.size), ptr(offsets), ptr(lengths_),
                         ctypes.c_longlong(len(messages)),
                         ctypes.c_longlong(wave.batch), ctypes.c_longlong(wave.bucket),
                         ctypes.c_int(pack.LAYOUTS[layout]), ptr(blocks), ptr(n_blocks))
    assert blocks.tobytes() == want.blocks.tobytes()
    assert n_blocks.tobytes() == want.n_blocks.reshape(-1).tobytes()


@pytest.mark.parametrize("layout", ["batch", "lanes"])
def test_pack_kernel_compiled_for_the_host_reads_rows_at_their_own_offsets(host_build, layout):
    """Rows out of order, 3 bytes apart, each at an offset off the 16-byte
    grid, in a buffer whose length is no multiple of 16: each quarter is
    cut from its granules at the row's own offset, and the last granule is
    read only as far as the buffer goes."""
    messages = _messages(BOUNDARY, seed=5)
    chunks, offsets, at = [], [0] * len(messages), 0
    for i in reversed(range(len(messages))):
        offsets[i] = at
        chunks.append(messages[i] + b"\0\0\0")
        at += len(messages[i]) + 3
    raw = np.frombuffer(b"".join(chunks)[:-2], dtype=np.uint8).copy()
    assert raw.size % 16
    offsets = np.array(offsets, dtype=np.int64)
    lengths = np.array([len(m) for m in messages], dtype=np.int32)
    want = ref.pack_messages(messages, layout=layout)
    batch = want.n_blocks.size
    blocks = np.full(want.blocks.shape, 0xDEADBEEF, dtype=np.uint32)
    n_blocks = np.full(batch, 0xDEADBEEF, dtype=np.uint32)
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    host_build.host_pack(ptr(raw), ctypes.c_longlong(raw.size), ptr(offsets), ptr(lengths),
                         ctypes.c_longlong(len(messages)), ctypes.c_longlong(batch),
                         ctypes.c_longlong(want.blocks.shape[1]),
                         ctypes.c_int(pack.LAYOUTS[layout]), ptr(blocks), ptr(n_blocks))
    assert blocks.tobytes() == want.blocks.tobytes()
    assert n_blocks.tobytes() == want.n_blocks.reshape(-1).tobytes()


def test_plain_version_on_arbitrary_offsets():
    """Rows need not be contiguous in ``raw``: each row is read at its own
    offset (the kernel's contract)."""
    raw = torch.arange(256, dtype=torch.int64).to(torch.uint8)
    offsets = torch.tensor([200, 3, 3], dtype=torch.int64)
    lengths = torch.tensor([50, 0, 60], dtype=torch.int32)
    blocks, n_blocks = pack_wave_torch(raw, offsets, lengths, 4, 2, "batch")
    messages = [bytes(range(200, 250)), b"", bytes(range(3, 63))]
    want = ref.pack_messages(messages, block_bucket=2, batch_bucket=4)
    assert blocks.numpy().view(np.uint32).tobytes() == want.blocks.tobytes()
    assert n_blocks.numpy().view(np.uint32).tobytes() == want.n_blocks.tobytes()
