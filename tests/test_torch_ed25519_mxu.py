"""The "mxu" Ed25519 backend of the port against the JAX package, on the CPU.

``csrc/ed25519_mxu.cu`` (the verify kernel whose field multiplies contract
their nibble products on the tensor cores) is plain C++ outside
``__CUDACC__``: built for the host with the C++ compiler, every register is
its 32 lanes' values, and its multiply runs the kernel's own staging, K
tiles, fragments, combine, lane shuffles and carries, with each
``mma.sync`` formed from the 32 lanes' fragments by the PTX ISA's m16n8k32
layouts.  Here that multiply is held to the JAX package's ``_mul_mxu`` limb
for limb (numpy-seeded loose limbs |l| <= 511 and the three extreme
patterns of ``tests/test_ed25519_tpu.py``'s exactness regression), its
inversion to the port's ``_inv(mul=_mul_mxu)``, which
``tests/test_torch_ed25519.py`` ties to the JAX package, and one ladder
step (the kernel's table set-up, ``pt_double``, the select and ``pt_add``)
to the port's ``_pt_double``, ``_pt_select`` and ``_pt_add`` with
``_mul_mxu``.  The wrapper's CPU
path (the twin) runs in ``tests/test_torch_parallel.py``'s mxu mesh test;
here its input checks.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Limbs and verdicts are integers: every comparison is exact.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from mirbft_tpu.ops import ed25519 as ref
from mirbft_tpu_torch.ops import ed25519 as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "mirbft_tpu_torch", "csrc", "ed25519_mxu.cu")

HOST_WRAPPER = """
#define __host__
#define __device__
#define __forceinline__ inline
#include "{source}"
extern "C" void host_mul(const int32_t* a, const int32_t* b, int32_t* out, long long rows) {{
  mxu::mul_host(a, b, out, rows);
}}
extern "C" void host_inv(const int32_t* z, int32_t* out, long long rows) {{
  mxu::inv_host(z, out, rows);
}}
extern "C" void host_ladder_step(const int32_t* qx, const int32_t* qy, const int32_t* qz,
                                 const int32_t* qt, const int32_t* ax, const int32_t* ay,
                                 const int32_t* s_bits, const int32_t* h_bits, int bit,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int32_t* ot,
                                 long long rows) {{
  const int32_t* q[4] = {{qx, qy, qz, qt}};
  int32_t* out[4] = {{ox, oy, oz, ot}};
  mxu::ladder_step_host(q, ax, ay, s_bits, h_bits, bit, out, rows);
}}
"""

# tests/test_ed25519_tpu.py::test_mxu_multiply_exact_at_loose_limb_bound.
EXTREMES = {
    "all_511": np.full(32, 511, dtype=np.int32),
    "all_minus_511": np.full(32, -511, dtype=np.int32),
    "alternating": np.array([511, -511] * 16, dtype=np.int32),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # The twins run many small ops: under several test workers, torch's
    # intra-op pools oversubscribe the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """``csrc/ed25519_mxu.cu`` built for the host with the C++ compiler,
    once a worker; the compiles of several workers take turns on a lock."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler is not None, "a C++ compiler is needed (the port's _native build uses it)"
    folder = tmp_path_factory.mktemp("mxu_host")
    source = folder / "host_mxu.cpp"
    source.write_text(HOST_WRAPPER.format(source=SOURCE))
    library = folder / "host_mxu.so"
    with open(SOURCE) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(
            [compiler, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(library), str(source)],
            check=True, capture_output=True, timeout=120,
        )
    return ctypes.CDLL(str(library))


def _host(fn, *arrays):
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    rows = arrays[0].shape[0]
    out = np.full((rows, 32), 7, dtype=np.int32)
    fn(*(ctypes.c_void_p(a.ctypes.data) for a in arrays), ctypes.c_void_p(out.ctypes.data),
       ctypes.c_longlong(rows))
    return out


def _operands():
    """name -> (a, b): 64 seeded rows of loose limbs, and each extreme
    pattern against all three."""
    rng = np.random.default_rng(20261018)
    cases = {"seeded": tuple(rng.integers(-511, 512, size=(2, 64, 32)).astype(np.int32))}
    others = np.stack(list(EXTREMES.values()))
    for name, pattern in EXTREMES.items():
        cases[name] = (np.tile(pattern, (3, 1)), others)
    return cases


CASES = _operands()


@pytest.fixture(scope="module")
def jax_products():
    """The JAX package's ``_mul_mxu`` of every case, computed once: one
    jitted call over all the cases' rows, as the JAX program jits it."""
    rows = np.cumsum([0] + [len(a) for a, _ in CASES.values()])
    a, b = (np.concatenate([case[k] for case in CASES.values()]) for k in (0, 1))
    out = np.asarray(jax.jit(ref._mul_mxu)(a, b))
    return {name: out[start:end] for name, start, end in zip(CASES, rows[:-1], rows[1:])}


@pytest.mark.parametrize("case", list(CASES))
def test_host_multiply_equals_jax_mul_mxu(host_build, jax_products, case):
    a, b = CASES[case]
    got = _host(host_build.host_mul, a, b)
    assert got.dtype == np.int32 and got.shape == a.shape
    assert (got == jax_products[case]).all()
    assert np.abs(got).max() <= 511  # the loose-limb invariant holds
    for x, y, z in zip(a, b, got):
        assert (port.limbs_to_int(z) - port.limbs_to_int(x) * port.limbs_to_int(y)) % port.P == 0


def test_host_inverse_equals_the_twin(host_build):
    """Two rows through the kernel's inversion (254 squarings and 252
    multiplies, all by the host-built multiply) against ``_inv`` with the
    twin's ``_mul_mxu``, limb for limb."""
    z = CASES["seeded"][0][:2]
    got = _host(host_build.host_inv, z)
    want = port._inv(torch.from_numpy(z.astype(np.int64)), mul=port._mul_mxu).numpy()
    assert (got == want).all()
    for row, inv in zip(z, got):
        value = port.limbs_to_int(row) % port.P
        assert port.limbs_to_int(inv) * value % port.P == 1


def test_host_ladder_step_equals_the_twin(host_build):
    """16 rows (two groups of 8) through the kernel's set-up of the table
    {B, -A, B - A} (10 multiplies) and one ladder step, ``pt_double`` then
    ``pt_add`` of the entry s + 2h picks (17 multiplies), against the
    twin's ``_pt_double``, ``_pt_select`` and ``_pt_add`` with ``_mul_mxu``,
    limb for limb.  Q is loose limbs; the picks cover 0-3, and two values
    outside them (7, and -1 from h = -1), which select the identity."""
    rng = np.random.default_rng(20261019)
    rows, bit = 16, 77
    q = rng.integers(-511, 512, size=(4, rows, 32)).astype(np.int32)
    ax, ay = rng.integers(0, 256, size=(2, rows, 32)).astype(np.int32)
    s_bits, h_bits = rng.integers(0, 2, size=(2, rows, 256)).astype(np.int32)
    s_bits[:6, bit] = [0, 1, 0, 1, 7, 1]
    h_bits[:6, bit] = [0, 0, 1, 1, 0, -1]
    out = np.full((4, rows, 32), 7, dtype=np.int32)
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    host_build.host_ladder_step(*(ptr(x) for x in q), ptr(ax), ptr(ay), ptr(s_bits),
                                ptr(h_bits), ctypes.c_int(bit), *(ptr(o) for o in out),
                                ctypes.c_longlong(rows))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))

    mul = port._mul_mxu
    one, zero = t(np.tile(port._ONE, (rows, 1))), t(np.zeros((rows, 32)))
    base = (t(np.tile(port._BX, (rows, 1))), t(np.tile(port._BY, (rows, 1))), one,
            t(np.tile(port._BT, (rows, 1))))
    neg_ax = port._sub(torch.zeros_like(t(ax)), t(ax))
    m_a = (neg_ax, t(ay), one, mul(neg_ax, t(ay)))
    b_m_a = port._pt_add(base, m_a, mul)
    acc = port._pt_double(tuple(t(x) for x in q), mul)
    addend = port._pt_select(t(s_bits[:, bit]) + 2 * t(h_bits[:, bit]), (zero, one, one, zero),
                             base, m_a, b_m_a)
    want = port._pt_add(acc, addend, mul)
    for got, expected in zip(out, want):
        assert (got == expected.numpy()).all()


def test_split_tool_finds_its_anchors():
    """``mxu_split.py`` stamps a copy of the kernel at exact lines of its
    source: every anchor is found once in the current source, and the
    stamps land in the batched multiply, the adds and subs and the ladder."""
    import sys

    sys.path.insert(0, ROOT)
    try:
        import mxu_split
    finally:
        sys.path.remove(ROOT)
    with open(SOURCE) as fh:
        stamped = mxu_split.instrument(fh.read())
    for stamp in ("MXU_T(0);", "MXU_T(3);", "MXU_T(5);", "MXU_T(7);", "MXU_STEP_END();",
                  "mirbft_mxu_profile"):
        assert stamp in stamped, stamp
    with pytest.raises(ValueError):
        mxu_split.instrument(stamped.replace("  DevCtx ctx;\n", ""))


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda t: [t[0].to(torch.int64)] + t[1:], TypeError),
        (lambda t: t[:4] + [t[4][:, :64].contiguous()], ValueError),
        (lambda t: t[:1] + [t[1][:3]] + t[2:], ValueError),
    ],
    ids=["dtype", "bits-width", "rows"],
)
def test_mxu_wrapper_rejects_bad_inputs(change, error):
    tensors = [torch.zeros((4, 32), dtype=torch.int32) for _ in range(3)]
    tensors += [torch.zeros((4, 256), dtype=torch.int32) for _ in range(2)]
    # One wrapper for both backends: "mxu" refuses what "vpu" refuses.
    with pytest.raises(error):
        port.ed25519_verify_kernel(*change(tensors), backend="mxu")
    with pytest.raises(error):
        port.ed25519_verify_kernel(*change(tensors))
