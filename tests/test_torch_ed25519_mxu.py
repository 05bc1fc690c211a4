"""The "mxu" Ed25519 backend of the port against the JAX package, on the CPU.

``csrc/ed25519_mxu.cu`` (the verify kernel whose field multiplies contract
their nibble products on the tensor cores) is plain C++ outside
``__CUDACC__``: built for the host with the C++ compiler, its multiply runs
the kernel's own staging, K tiles, fragment builders, combine and carry,
with each ``mma.sync`` formed from the 32 lanes' fragments by the PTX ISA's
m16n8k32 layouts.  Here that multiply is held to the JAX package's
``_mul_mxu`` limb for limb (numpy-seeded loose limbs |l| <= 511 and the
three extreme patterns of ``tests/test_ed25519_tpu.py``'s exactness
regression), and its inversion to the port's ``_inv(mul=_mul_mxu)``, which
``tests/test_torch_ed25519.py`` ties to the JAX package.  The wrapper's CPU
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
