"""Ed25519 verification in the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX reference and the port: the
twin's field and point helpers against the JAX helpers limb for limb (loose
limbs |l| <= 511, the extremes included), ``verify_torch`` against the JAX
program ``ed25519_verify_kernel(backend="vpu")`` on one packed wave of RFC
8032 vectors, tampered rows and padding rows, the port's ``pack_inputs``
against the reference's array for array, and ``Ed25519BatchVerifier`` on
the CPU against ``verify_one``.  The CUDA kernel's source is also compiled
for the host with the C++ compiler (its per-lane code is plain C++, run on
each signature's four lanes in turn) and held to the same verdicts, also on
rows where Z = 0 is reached and at row counts that fill part of a warp; its
field operations are held to Python integers.  Verdicts and limbs are
integers: every comparison is exact.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirbft_tpu.ops import ed25519 as ref
from mirbft_tpu_torch import metrics, tracing
from mirbft_tpu_torch.ops import ed25519 as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# RFC 8032 section 7.1 TEST 1-3 (public key, message, signature).
RFC_VECTORS = [
    (
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


def _rfc(i):
    pub, msg, sig = RFC_VECTORS[i]
    return bytes.fromhex(pub), bytes.fromhex(msg), bytes.fromhex(sig)


def _flip(data: bytes, index: int, bit: int = 1) -> bytes:
    return data[:index] + bytes([data[index] ^ bit]) + data[index + 1 :]


# A wave of 6 real rows, packed to 8: the three RFC vectors and one tampered
# R, S and message (rows 6 and 7 are padding).
def _wave_rows():
    rows = [_rfc(i) for i in range(3)]
    pub, msg, sig = _rfc(0)
    rows.append((pub, msg, _flip(sig, 5)))  # R
    rows.append((pub, msg, _flip(sig, 40)))  # S (still below L)
    pub, msg, sig = _rfc(1)
    rows.append((pub, msg + b"!", sig))  # message
    return rows


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # The twins run many small ops; under several test workers, each with a
    # pool of intra-op threads, the pools oversubscribe the cores and the
    # ops slow down tenfold or more.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_port_observability():
    metrics.default_registry.reset()
    tracing.default_tracer.clear()
    tracing.default_tracer.enabled = False
    yield


@pytest.fixture(scope="module")
def wave():
    """The packed wave, the JAX program's verdicts and ``verify_torch``'s,
    each computed once for the module."""
    pubs, msgs, sigs = map(list, zip(*_wave_rows()))
    arrays = ref.Ed25519BatchVerifier(min_device_batch=1).pack_inputs(
        pubs, msgs, sigs, batch=8
    )
    jax_ok = np.asarray(ref.ed25519_verify_kernel(*arrays[:5], backend="vpu"))
    # Through the wrapper, which takes verify_torch for CPU tensors.
    before = port.ed25519_verify_kernel.launches
    twin = port.ed25519_verify_kernel(*(torch.from_numpy(a) for a in arrays[:5]))
    launched = port.ed25519_verify_kernel.launches - before
    expected = [ref.verify_one(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    return arrays, jax_ok, twin, expected, launched


def _loose(seed, rows=16):
    """Loose limbs in [-511, 511], with the bound's extremes in rows 0-2."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(-511, 512, size=(rows, 32)).astype(np.int32)
    limbs[0] = 511
    limbs[1] = -511
    limbs[2] = np.array([511, -511] * 16, dtype=np.int32)
    return limbs


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("name", ["_mul_vpu", "_mul_mxu", "_add", "_sub"])
def test_field_op_equals_jax_limb_for_limb(name):
    a, b = _loose(1), _loose(2)[::-1].copy()
    want = np.asarray(getattr(ref, name)(a, b))
    got = getattr(port, name)(_t(a), _t(b)).numpy()
    assert (got == want).all()
    assert np.abs(got).max() <= 511  # the loose-limb invariant holds
    # A constant operand broadcasts, as _pt_add's 2d factor does.
    assert (getattr(port, name)(_t(a), _t(b[3])).numpy()
            == np.asarray(getattr(ref, name)(a, b[3]))).all()


def test_freeze_equals_jax_and_is_canonical():
    a = _loose(3)
    got = port._freeze(_t(a)).numpy()
    assert (got == np.asarray(ref._freeze(jnp.asarray(a)))).all()
    for row, limbs in zip(a, got):
        assert port.limbs_to_int(limbs) == port.limbs_to_int(row) % port.P


def test_inv_equals_jax():
    a = _loose(4, rows=3)
    got = port._inv(_t(a)).numpy()
    assert (got == np.asarray(ref._inv(jnp.asarray(a)))).all()
    for row, inv in zip(a, got):
        value = port.limbs_to_int(row) % port.P
        assert port.limbs_to_int(inv) % port.P == pow(value, port.P - 2, port.P)


@pytest.mark.parametrize("op", ["_pt_add", "_pt_double"])
def test_point_op_equals_jax(op):
    p1 = [_loose(10 + i, rows=4) for i in range(4)]
    p2 = [_loose(20 + i, rows=4) for i in range(4)]
    args_ref = [tuple(jnp.asarray(c) for c in p1)]
    args_port = [tuple(_t(c) for c in p1)]
    if op == "_pt_add":
        args_ref.append(tuple(jnp.asarray(c) for c in p2))
        args_port.append(tuple(_t(c) for c in p2))
    want = getattr(ref, op)(*args_ref)
    got = getattr(port, op)(*args_port)
    for w, g in zip(want, got):
        assert (g.numpy() == np.asarray(w)).all()


def test_verify_torch_equals_jax_program(wave):
    arrays, jax_ok, twin, expected, _ = wave
    twin_ok = twin.numpy()
    assert (twin_ok == jax_ok).all()
    valid = arrays[5]
    assert (twin_ok & valid)[:6].tolist() == expected
    assert expected == [True, True, True, False, False, False]
    assert not valid[6:].any() and not twin_ok[6:].any()  # padding rows


def test_wrapper_takes_the_twin_on_cpu_tensors(wave):
    _, _, twin, _, launched = wave
    assert twin.dtype == torch.bool and twin.shape == (8,)
    assert launched == 0  # no kernel launched, none counted


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda t: [t[0].to(torch.int64)] + t[1:], TypeError),
        (lambda t: t[:3] + [t[3][:, :128].contiguous()] + t[4:], ValueError),
        (lambda t: [t[0][:4]] + t[1:], ValueError),
        (lambda t: t[:2] + [t[2].t().contiguous().t()] + t[3:], ValueError),
    ],
    ids=["dtype", "bits-width", "rows", "contiguity"],
)
def test_wrapper_rejects_bad_inputs(change, error):
    tensors = [torch.zeros((8, 32), dtype=torch.int32) for _ in range(3)]
    tensors += [torch.zeros((8, 256), dtype=torch.int32) for _ in range(2)]
    with pytest.raises(error):
        port.ed25519_verify_kernel(*change(tensors))
    with pytest.raises(ValueError, match="backend"):
        port.ed25519_verify_kernel(*tensors, backend="gpu")


def _pack_cases():
    pub0, msg0, sig0 = _rfc(0)
    pub1, msg1, sig1 = _rfc(1)
    s = int.from_bytes(sig0[32:], "little")
    return [
        (pub0, msg0, sig0),
        (pub0, b"other", sig0),  # repeated signer: one key-table slot
        (pub1, msg1, sig1[:63]),  # wrong-length signature
        ((2**255 - 10).to_bytes(32, "little"), msg0, sig0),  # undecompressable
        (pub0, msg0, sig0[:32] + (s + port.L).to_bytes(32, "little")),  # S >= L
        (pub1, msg1, sig1),
        (pub0, msg0, sig0[:32] + port.L.to_bytes(32, "little")),  # S == L
    ]


@pytest.mark.parametrize("batch", [None, 16])
def test_pack_inputs_equals_reference(batch):
    pubs, msgs, sigs = map(list, zip(*_pack_cases()))
    want = ref.Ed25519BatchVerifier().pack_inputs(pubs, msgs, sigs, batch=batch)
    got = port.Ed25519BatchVerifier(device="cpu").pack_inputs(pubs, msgs, sigs, batch=batch)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all()
    assert got[5].tolist()[:7] == [True, True, False, False, False, True, False]


def _host_cases():
    """(name, pub, msg, sig) rows for the verifier, with the curve's
    strictness cases."""
    pub, msg, sig = _rfc(0)
    s = int.from_bytes(sig[32:], "little")
    # The identity as public key (small order): R = [r]B with S = r verifies
    # for any message under the cofactorless equation.  With S = 0, Q is the
    # identity, whose canonical encoding is y = 1; y = p + 1 encodes the same
    # point non-canonically and must fail.
    identity = (1).to_bytes(32, "little")
    r = 12345
    r_point = port._compress_py(port._pt_mul_py(r, port._BASE_PT))
    return [
        ("rfc1", *_rfc(0)),
        ("rfc2", *_rfc(1)),
        ("rfc3", *_rfc(2)),
        ("malleable_s", pub, msg, sig[:32] + (s + port.L).to_bytes(32, "little")),
        ("invalid_pubkey", (2**255 - 10).to_bytes(32, "little"), b"m", bytes(64)),
        ("tampered_key", _flip(pub, 0, 2), msg, sig),
        ("small_order_key", identity, b"any", r_point + r.to_bytes(32, "little")),
        ("canonical_r", identity, b"any", identity + bytes(32)),
        ("non_canonical_r", identity, b"any", (port.P + 1).to_bytes(32, "little") + bytes(32)),
    ]


HOST_CASES = _host_cases()


@pytest.fixture(scope="module")
def verified():
    _, pubs, msgs, sigs = map(list, zip(*HOST_CASES))
    verifier = port.Ed25519BatchVerifier(min_device_batch=1, device="cpu")
    return verifier.verify_batch(pubs, msgs, sigs)


@pytest.mark.parametrize("row", range(len(HOST_CASES)), ids=[c[0] for c in HOST_CASES])
def test_verifier_on_cpu_equals_verify_one(verified, row):
    _, pub, msg, sig = HOST_CASES[row]
    assert bool(verified[row]) == port.verify_one(pub, msg, sig) == ref.verify_one(pub, msg, sig)
    expected = {"rfc1", "rfc2", "rfc3", "small_order_key", "canonical_r"}
    assert bool(verified[row]) == (HOST_CASES[row][0] in expected)


def test_key_cache_reuse():
    # The key caches are process-wide (pure functions of the key bytes), so
    # measure the delta this verifier's packing contributes.
    verifier = port.Ed25519BatchVerifier(min_device_batch=1, device="cpu")
    pub, msg, sig = _rfc(2)
    verifier._key_cache.pop(pub, None)
    verifier._limb_cache.pop(pub, None)
    before = len(verifier._key_cache)
    valid = verifier.pack_inputs([pub] * 3, [msg] * 3, [sig] * 3)[5]
    assert valid[:3].all()
    assert len(verifier._key_cache) == before + 1
    assert pub in verifier._key_cache and pub in verifier._limb_cache
    # The caches are shared with every other verifier of the process.
    assert port.Ed25519BatchVerifier(device="cpu")._limb_cache is verifier._limb_cache


def test_verifier_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Ed25519BatchVerifier()
    # A mesh of the verifier's kind shards its waves; a CUDA mesh needs
    # cards, and a CPU mesh does not serve a CUDA verifier.
    from mirbft_tpu_torch.parallel import make_mesh

    assert port.Ed25519BatchVerifier(device="cpu", mesh=make_mesh(2, device="cpu"))._mesh_size == 2
    with pytest.raises(ValueError, match="only 0 available"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Ed25519BatchVerifier(mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError):
        port.Ed25519BatchVerifier(device="cpu", kernel="tpu")


def test_dispatch_and_collect_on_cpu():
    pubs, msgs, sigs = map(list, zip(*[_rfc(i) for i in range(3)]))
    msgs[2] = msgs[2] + b"?"
    verifier = port.Ed25519BatchVerifier(min_device_batch=1, device="cpu")
    handle = verifier.dispatch(pubs, msgs, sigs)
    assert handle.event is None and handle.ok.shape == (4,)
    assert verifier.collect(handle).tolist() == [True, True, False]
    snap = metrics.snapshot()
    assert snap["verify_pack_seconds_count"] == 1
    assert snap["verify_device_dispatch_seconds_count"] == 1


HOST_WRAPPER = """
#define __host__
#define __device__
#define __forceinline__ inline
#include "{source}"
extern "C" void host_verify(const int32_t* ax, const int32_t* ay, const int32_t* r,
                            const int32_t* s, const int32_t* h, long long rows, uint8_t* out) {{
  ed25519::verify_host(ax, ay, r, s, h, rows, out);
}}
extern "C" void host_field(int op, const uint32_t* a, const uint32_t* b, uint32_t* out) {{
  ed25519::Fe x, y, r;
  for (int k = 0; k < 8; ++k) {{ x.v[k] = a[k]; y.v[k] = b[k]; }}
  switch (op) {{
    case 0: r = ed25519::fe_mul(x, y); break;
    case 1: r = ed25519::fe_sqr(x); break;
    case 2: r = ed25519::fe_add(x, y); break;
    case 3: r = ed25519::fe_sub(x, y); break;
    default: r = ed25519::fe_addsub(x, y, op == 5);
  }}
  for (int k = 0; k < 8; ++k) out[k] = r.v[k];
}}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """``csrc/ed25519.cu`` built for the host with the C++ compiler: outside
    its kernel and launcher it is plain C++, and ``verify_host`` runs the
    kernel's per-lane code on each group's four lanes in turn, with the
    launch's row mapping (whole warps of eight groups)."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler is not None, "a C++ compiler is needed (the port's _native build uses it)"
    folder = tmp_path_factory.mktemp("host_build")
    source = folder / "host_verify.cpp"
    source.write_text(HOST_WRAPPER.format(
        source=os.path.join(ROOT, "mirbft_tpu_torch", "csrc", "ed25519.cu")))
    library = folder / "host_verify.so"
    subprocess.run(
        [compiler, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(library), str(source)],
        check=True, capture_output=True, timeout=120,
    )
    return ctypes.CDLL(str(library))


def _host_verify(lib, inputs, rows):
    inputs = [np.ascontiguousarray(a[:rows], dtype=np.int32) for a in inputs]
    out = np.full(rows, 7, dtype=np.uint8)
    lib.host_verify(
        *(ctypes.c_void_p(a.ctypes.data) for a in inputs),
        ctypes.c_longlong(rows),
        ctypes.c_void_p(out.ctypes.data),
    )
    return out


def test_kernel_source_compiled_for_the_host_gives_the_same_verdicts(wave, host_build):
    """The host build's verdict is the JAX program's on every row, padding
    rows included."""
    arrays, jax_ok, _, _, _ = wave
    inputs = [np.array(a, dtype=np.int32) for a in arrays[:5]]
    out = _host_verify(host_build, inputs, len(jax_ok))
    assert (out.astype(bool) == jax_ok).all() and set(out.tolist()) <= {0, 1}
    # An R byte outside [0, 255] fails its row, as the int32 compare does.
    inputs[2][0, 31] += 256
    assert _host_verify(host_build, inputs, 1)[0] == 0


P = port.P


def _ladder_z(ax, ay, s_bits, h_bits):
    """Z mod p of the kernel's ladder on one packed row, in Python integers:
    the reference's formulas (dbl-2008-hwcd, add-2008-hwcd-3) on the table
    identity, B, -A, B - A, picked by s + 2h in wrapping int32."""
    x = int.from_bytes(bytes(int(v) & 0xFF for v in ax), "little")
    y = int.from_bytes(bytes(int(v) & 0xFF for v in ay), "little")

    def cached(pt):
        px, py, pz, pt_ = pt
        return ((py - px) % P, (py + px) % P, 2 * port.D * pt_ % P, 2 * pz % P)

    def add(q, c):
        qx, qy, qz, qt = q
        ymx, ypx, t2d, z2 = c
        a, b = (qy - qx) * ymx % P, (qy + qx) * ypx % P
        cc, d = qt * t2d % P, qz * z2 % P
        e, f, g, h = b - a, d - cc, d + cc, b + a
        return (e * f % P, g * h % P, f * g % P, e * h % P)

    def double(q):
        qx, qy, qz, _ = q
        a, b, c = qx * qx % P, qy * qy % P, 2 * qz * qz % P
        h = a + b
        e, g = h - (qx + qy) ** 2, a - b
        f = c + g
        return (e * f % P, g * h % P, f * g % P, e * h % P)

    base = (port._BASE_X, port._BASE_Y, 1, port._BASE_X * port._BASE_Y % P)
    m_a = (-x % P, y, 1, -x * y % P)
    table = [(1, 1, 0, 2), cached(base), cached(m_a), cached(add(base, cached(m_a)))]
    q = (0, 1, 1, 0)
    for i in reversed(range(256)):
        pick = (int(s_bits[i]) + 2 * int(h_bits[i])) & 0xFFFFFFFF
        q = add(double(q), table[pick if pick < 4 else 0])
    return q[2]


@pytest.fixture(scope="module")
def edge_wave():
    """Eight off-curve rows packed by hand, with the JAX program's verdicts:
    Z = 0 reached by the all-zero key (its doubles vanish) and by a key with
    x = y (the last doubling of -A has X^2 = Y^2) with R = 0, which then
    verifies, and with R != 0; random bytes with random bits; bit values
    outside {0, 1}, including sums that wrap int32; and a padding row."""
    rng = np.random.default_rng(20261017)
    ax = rng.integers(0, 256, size=(8, 32)).astype(np.int32)
    ay = rng.integers(0, 256, size=(8, 32)).astype(np.int32)
    r = rng.integers(0, 256, size=(8, 32)).astype(np.int32)
    s = rng.integers(0, 2, size=(8, 256)).astype(np.int32)
    h = rng.integers(0, 2, size=(8, 256)).astype(np.int32)
    ax[0:2] = ay[0:2] = r[0] = 0  # the all-zero key
    h[0:2, 255] = 1
    r[1, 0] = 1
    ay[2:4] = ax[2:4]  # x = y: Q = mu (-A) before the last doubling
    s[2:4] = h[2:4] = 0
    h[2:4, 1] = 1
    r[2] = 0
    r[3] = 1
    s[5, ::3], h[5, ::5] = 5, -1
    s[6, :128], h[6, :128] = 2**31 - 1, 2**30  # s + 2h wraps to -1
    s[6, 128:], h[6, 128:] = 1, -(2**31)  # 2h wraps to 0
    ax[7] = ay[7] = r[7] = s[7] = h[7] = 0
    arrays = (ax, ay, r, s, h)
    jax_ok = np.asarray(ref.ed25519_verify_kernel(*arrays, backend="vpu"))
    return arrays, jax_ok


def test_host_build_on_rows_where_z_is_zero(edge_wave, host_build):
    arrays, jax_ok = edge_wave
    zero_z = [i for i in range(8) if _ladder_z(*(a[i] for a in (arrays[0], arrays[1], arrays[3],
                                                                arrays[4]))) == 0]
    assert zero_z == [0, 1, 2, 3]
    # z^(p - 2) = 0: x = y = 0, which R = 0 encodes.
    assert jax_ok[:4].tolist() == [True, False, True, False]
    out = _host_verify(host_build, arrays, 8)
    assert (out.astype(bool) == jax_ok).all() and set(out.tolist()) <= {0, 1}


@pytest.mark.parametrize("rows", [7, 9])
def test_host_build_fills_part_of_a_warp(wave, edge_wave, host_build, rows):
    """Row counts that leave a warp's last groups without a row of their own
    (the launch gives them the last row and stores nothing from them)."""
    arrays = [np.concatenate([np.array(w, dtype=np.int32), e])
              for w, e in zip(wave[0][:5], edge_wave[0])]
    expected = np.concatenate([wave[1], edge_wave[1]])[:rows]
    out = _host_verify(host_build, arrays, rows)
    assert out.shape == (rows,) and (out.astype(bool) == expected).all()


FIELD_EDGES = [0, 1, 2, 37, 38, P - 1, P, P + 1, 2 * P + 37, 2**255, 2**256 - 39,
               2**256 - 38, 2**256 - 2, 2**256 - 1, 2**32 - 1, 2**224 * (2**32 - 1)]


def _field_values():
    rng = np.random.default_rng(4)
    return FIELD_EDGES + [int.from_bytes(rng.bytes(32), "little") for _ in range(24)]


@pytest.mark.parametrize("op", ["fe_mul", "fe_sqr", "fe_add", "fe_sub", "fe_addsub"])
def test_host_field_op_equals_python_integers(host_build, op):
    """The field operations of csrc/ed25519_field.cuh (their C++ forms, which
    the host build runs) against Python integers mod p on edge values (0, 1,
    p - 1, p, 2p + 37, 2^256 - 1 = all limbs 0xffffffff, ...) and random ones:
    below 2^256 and congruent to the exact result."""
    values = _field_values()
    out = (ctypes.c_uint32 * 8)()
    cases = {"fe_mul": [(0, lambda a, b: a * b)], "fe_sqr": [(1, lambda a, b: a * a)],
             "fe_add": [(2, lambda a, b: a + b)], "fe_sub": [(3, lambda a, b: a - b)],
             "fe_addsub": [(4, lambda a, b: a + b), (5, lambda a, b: a - b)]}[op]
    for code, exact in cases:
        for a in values:
            for b in values:
                la = (ctypes.c_uint32 * 8)(*((a >> (32 * k)) & 0xFFFFFFFF for k in range(8)))
                lb = (ctypes.c_uint32 * 8)(*((b >> (32 * k)) & 0xFFFFFFFF for k in range(8)))
                host_build.host_field(code, la, lb, out)
                got = sum(int(w) << (32 * k) for k, w in enumerate(out))
                assert got < 2**256 and (got - exact(a, b)) % P == 0, (op, code, a, b)
