"""Batched Ed25519 verification on the card: host packing, the plain PyTorch
twin, and the ``Ed25519BatchVerifier`` that drives the CUDA kernel.

The signed-request path: client requests are Ed25519-signed and replicas
verify them in waves before a proposal may be persisted and acknowledged.
The host side (curve constants, limb helpers, the pure-Python RFC 8032 code,
the process-wide key caches, the S < L screen and the vectorized wave
packer ``pack_inputs``) is the JAX package's numpy code, copied unchanged so
both packages pack bit-identical waves.  The device side is one
hand-written CUDA kernel (``csrc/ed25519.cu``, ``ed25519_verify_kernel``:
what bounds it and what its design does about that are noted there), which
computes ``compress([S]B + [h](-A)) == R`` for every row of a wave.

``verify_torch`` is the plain PyTorch version of that contract, written in
the JAX program's own terms: GF(2^255 - 19) elements as 32 signed 8-bit
limbs with the loose-limb invariant |l| <= 511, the limb product as one
contraction with ``_MUL_MATRIX`` followed by four carry rounds, the same
point formulas, the 256-step ladder, inversion by the bits of p - 2 and the
sequential freeze.  The twin widens limbs to int64, where ``>>`` is the
same floor shift that ``_carry`` relies on for borrows, and runs the
contraction as a float64 matmul: every partial sum is an integer below
2^28.3 < 2^53, so it is exact on both devices (CUDA PyTorch has no integer
matmul).  It matches the JAX helpers limb for limb, not only mod p.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Curve constants (host Python ints).
# ---------------------------------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

_BASE_Y = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> Optional[int]:
    """RFC 8032 point decompression (host side, Python ints)."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BASE_X = _recover_x(_BASE_Y, 0)
assert _BASE_X is not None

NUM_LIMBS = 32
_LIMB_BITS = 8
_LIMB_MASK = (1 << _LIMB_BITS) - 1


def int_to_limbs(value: int) -> np.ndarray:
    """Python int (mod p, < 2^256) -> little-endian 32x8-bit int32 limbs.
    Per-value reference; the batch path uses ``limbs_from_le_bytes``."""
    value %= 2**256
    return np.array(
        [(value >> (_LIMB_BITS * i)) & _LIMB_MASK for i in range(NUM_LIMBS)],
        dtype=np.int32,
    )


def limbs_from_le_bytes(raw: np.ndarray) -> np.ndarray:
    """[..., 32] uint8 little-endian byte rows -> [..., 32] int32 limbs.

    Vectorized twin of ``int_to_limbs`` for whole waves: one uint64 view
    plus shift/mask over all rows at once — at radix 2^8 the limb
    decomposition of a 256-bit little-endian value is exactly its byte
    decomposition, so no per-value Python bigint loop is needed."""
    raw = np.ascontiguousarray(raw)
    if raw.dtype != np.uint8 or raw.shape[-1] != NUM_LIMBS:
        raise ValueError("expected uint8 rows of 32 bytes")
    words = raw.view("<u8").reshape(*raw.shape[:-1], NUM_LIMBS // 8)
    shifts = np.arange(8, dtype=np.uint64) * np.uint64(_LIMB_BITS)
    limbs = (words[..., :, None] >> shifts) & np.uint64(_LIMB_MASK)
    return limbs.reshape(*raw.shape[:-1], NUM_LIMBS).astype(np.int32)


def limbs_to_int(limbs: np.ndarray) -> int:
    """Little-endian limb array (any magnitudes) -> Python int."""
    return sum(int(l) << (_LIMB_BITS * i) for i, l in enumerate(np.asarray(limbs)))


# Bilinear limb-product matrix: polynomial multiply fused with the mod-p fold
# (coefficient k+32 folds onto k with weight 2^256 mod p = 38).
def _build_mul_matrix() -> np.ndarray:
    m = np.zeros((NUM_LIMBS, NUM_LIMBS, NUM_LIMBS), dtype=np.int32)
    for i in range(NUM_LIMBS):
        for j in range(NUM_LIMBS):
            k = i + j
            if k < NUM_LIMBS:
                m[i, j, k] += 1
            else:
                m[i, j, k - NUM_LIMBS] += 38
    return m.reshape(NUM_LIMBS * NUM_LIMBS, NUM_LIMBS)


_MUL_MATRIX = _build_mul_matrix()
_P_LIMBS = int_to_limbs(P)

# p - 2 bits, most significant first, for the inversion exponentiation.
_INV_EXP_BITS = np.array(
    [(P - 2) >> i & 1 for i in reversed(range(255))], dtype=np.int32
)


def _build_nibble_mats():
    me = np.zeros((64, 64, NUM_LIMBS), dtype=np.float32)
    mo = np.zeros((64, 64, NUM_LIMBS), dtype=np.float32)
    for i in range(64):
        for j in range(64):
            k = i + j
            w = 1
            if k >= 64:
                k -= 64
                w = 38
            (me if k % 2 == 0 else mo)[i, j, k // 2] += w
    return (
        me.reshape(64 * 64, NUM_LIMBS),
        mo.reshape(64 * 64, NUM_LIMBS),
    )


_NIB_ME, _NIB_MO = _build_nibble_mats()
# Stacked [t_lo | t_hi] operand: c = u @ [Me; 16Me] + 16 * (u @ [Mo; 16Mo]).
_NIB_ME_STACK = np.concatenate([_NIB_ME, 16 * _NIB_ME], axis=0)
_NIB_MO_STACK = np.concatenate([_NIB_MO, 16 * _NIB_MO], axis=0)

_K2D = int_to_limbs(2 * D % P)  # 2d constant for the unified addition
_BX = int_to_limbs(_BASE_X)
_BY = int_to_limbs(_BASE_Y)
_BT = int_to_limbs(_BASE_X * _BASE_Y % P)
_ONE = int_to_limbs(1)
_ZERO = int_to_limbs(0)


# ---------------------------------------------------------------------------
# Plain PyTorch twin: field ops on (..., 32) int64 limb tensors, loose
# invariant |limb| <= 511, exactly as the JAX program computes them.
# ---------------------------------------------------------------------------

_DEVICE_CONSTANTS: Dict[tuple, object] = {}


def _on(name: str, array: np.ndarray, like):
    """A constant as a tensor on ``like``'s device (cached per device)."""
    import torch

    key = (name, str(like.device))
    tensor = _DEVICE_CONSTANTS.get(key)
    if tensor is None:
        dtype = torch.float64 if array.dtype.kind == "f" else torch.int64
        tensor = torch.as_tensor(array, dtype=dtype, device=like.device)
        _DEVICE_CONSTANTS[key] = tensor
    return tensor


# Carry weights: the carry out of limb 31 folds onto limb 0 as x 38.
_FOLD = np.array([38] + [1] * (NUM_LIMBS - 1), dtype=np.int64)


def _carry(x, rounds: int):
    """Carry propagation with top-limb fold (x 38), the JAX ``_carry``: the
    floor shift makes negative limbs borrow, and x - (c << 8) is x & 255."""
    import torch

    fold = _on("fold", _FOLD, x)
    for _ in range(rounds):
        c = x >> _LIMB_BITS
        x = (x & _LIMB_MASK) + torch.roll(c, 1, dims=-1) * fold
    return x


# The contraction matrices as float64, for ``_contract``.
_F64 = {
    "mul": _MUL_MATRIX.astype(np.float64),
    "nib_me": _NIB_ME_STACK.astype(np.float64),
    "nib_mo": _NIB_MO_STACK.astype(np.float64),
}


def _contract(flat, name: str):
    """Exact integer contraction ``flat @ matrix`` as a float64 matmul (the
    callers' sums stay below 2^53)."""
    import torch

    return (flat.to(torch.float64) @ _on(name, _F64[name], flat)).to(torch.int64)


def _mul_vpu(a, b):
    """Field multiply, the JAX int32 formulation: one bilinear contraction
    with ``_MUL_MATRIX`` (|c| <= ~2^28.3) + carry normalization."""
    outer = a[..., :, None] * b[..., None, :]  # (..., 32, 32)
    flat = outer.reshape(*outer.shape[:-2], NUM_LIMBS * NUM_LIMBS)
    return _carry(_contract(flat, "mul"), 4)


def _mul_mxu(a, b):
    """Field multiply, the JAX matrix-unit formulation: 4-bit nibbles, the
    nibble products split again into 4-bit halves, two contractions with
    the nibble fold matrices, each cast to an integer before the scaled add."""
    import torch

    an = torch.stack([a & 15, a >> 4], dim=-1).reshape(*a.shape[:-1], 64)
    bn = torch.stack([b & 15, b >> 4], dim=-1).reshape(*b.shape[:-1], 64)
    t = an[..., :, None] * bn[..., None, :]  # (..., 64, 64)
    t_lo = (t & 15).reshape(*t.shape[:-2], 64 * 64)
    t_hi = (t >> 4).reshape(*t.shape[:-2], 64 * 64)
    u = torch.cat([t_lo, t_hi], dim=-1)  # (..., 8192)
    c = _contract(u, "nib_me") + 16 * _contract(u, "nib_mo")
    return _carry(c, 4)


def _add(a, b):
    return _carry(a + b, 1)


def _sub(a, b):
    return _carry(a - b, 1)


def _inv(z, mul=None):
    """z^(p-2) over the fixed exponent bits (MSB first), as the JAX scan."""
    if mul is None:
        mul = _mul_vpu
    acc = z  # the leading 1-bit
    for bit in _INV_EXP_BITS[1:]:
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, z)
    return acc


def _seq_carry(x):
    """Exact sequential carry: every limb into [0, 255]; returns (limbs,
    carry out of the top limb)."""
    import torch

    carry = torch.zeros_like(x[..., 0])
    limbs = []
    for i in range(NUM_LIMBS):
        v = x[..., i] + carry
        limbs.append(v & _LIMB_MASK)
        carry = v >> _LIMB_BITS
    return torch.stack(limbs, dim=-1), carry


def _freeze(x):
    """Fully canonical representative in [0, p): limbs in [0, 255]."""
    import torch

    x, top = _seq_carry(_carry(x, 6))
    x[..., 0] += 38 * top  # fold any final top carry
    x, _ = _seq_carry(x)  # the top carry is 0 by construction now
    # Conditionally subtract p twice (value may be up to 2p + 37).
    for _ in range(2):
        borrow = torch.zeros_like(x[..., 0])
        diffs = []
        for i in range(NUM_LIMBS):
            d = x[..., i] - int(_P_LIMBS[i]) - borrow
            borrow = (d < 0).to(x.dtype)
            diffs.append(d + (borrow << _LIMB_BITS))
        x = torch.where((borrow == 0)[..., None], torch.stack(diffs, dim=-1), x)
    return x


def _pt_add(p1, p2, mul=None):
    """Strongly unified addition (add-2008-hwcd-3, a = -1)."""
    if mul is None:
        mul = _mul_vpu
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = mul(_sub(y1, x1), _sub(y2, x2))
    b = mul(_add(y1, x1), _add(y2, x2))
    c = mul(mul(t1, t2), _on("k2d", _K2D, x1))
    zz = mul(z1, z2)
    d = _add(zz, zz)
    e = _sub(b, a)
    f = _sub(d, c)
    g = _add(d, c)
    h = _add(b, a)
    return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def _pt_double(p1, mul=None):
    """Dedicated doubling (dbl-2008-hwcd, a = -1)."""
    if mul is None:
        mul = _mul_vpu
    x1, y1, z1, _ = p1
    a = mul(x1, x1)
    b = mul(y1, y1)
    zz = mul(z1, z1)
    c = _add(zz, zz)
    h = _add(a, b)
    xy = _add(x1, y1)
    e = _sub(h, mul(xy, xy))
    g = _sub(a, b)
    f = _add(c, g)
    return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))


def _pt_select(case, p0, p1, p2, p3):
    """4-way point select by per-row case index (any other value -> p0)."""
    import torch

    out = []
    sel = case[..., None]
    for c0, c1, c2, c3 in zip(p0, p1, p2, p3):
        v = torch.where(sel == 1, c1, c0)
        v = torch.where(sel == 2, c2, v)
        v = torch.where(sel == 3, c3, v)
        out.append(v)
    return tuple(out)


def verify_torch(ax, ay, r_bytes, s_bits, h_bits, mul=None):
    """The plain PyTorch verification: ax, ay, r_bytes [B, 32] and s_bits,
    h_bits [B, 256] integer tensors (the ``pack_inputs`` contract) ->
    [B] bool, ``compress([S]B + [h](-A)) == R``."""
    import torch

    if mul is None:
        mul = _mul_vpu
    ax, ay, r_bytes, s_bits, h_bits = (
        t.to(torch.int64) for t in (ax, ay, r_bytes, s_bits, h_bits)
    )
    batch = ax.shape[0]

    def bc(name, limbs):
        return _on(name, limbs, ax).expand(batch, NUM_LIMBS)

    one = bc("one", _ONE)
    identity = (bc("zero", _ZERO), one, one, bc("zero", _ZERO))
    base = (bc("bx", _BX), bc("by", _BY), one, bc("bt", _BT))

    # -A = (-x, y); T = -x * y.
    neg_ax = _sub(torch.zeros_like(ax), ax)
    m_a = (neg_ax, ay, one, mul(neg_ax, ay))
    b_m_a = _pt_add(base, m_a, mul)

    # Interleaved double-scalar multiplication, MSB first.
    acc = identity
    for i in reversed(range(256)):
        acc = _pt_double(acc, mul)
        addend = _pt_select(s_bits[:, i] + 2 * h_bits[:, i], identity, base, m_a, b_m_a)
        acc = _pt_add(acc, addend, mul)

    # Compress Q: y/Z with the sign bit of x/Z folded into the top bit.
    qx, qy, qz, _ = acc
    z_inv = _inv(qz, mul)
    x_aff = _freeze(mul(qx, z_inv))
    y_aff = _freeze(mul(qy, z_inv))
    y_aff[:, NUM_LIMBS - 1] += (x_aff[:, 0] & 1) << 7
    return (y_aff == r_bytes).all(dim=-1)


# ---------------------------------------------------------------------------
# The kernel's wrapper.
# ---------------------------------------------------------------------------

MXU_NOT_PORTED = (
    "the tensor-core ('mxu') field multiply has no CUDA kernel yet: "
    "ROADMAP.md, 'Next, in order' item 7"
)


def _check(ax, ay, r_bytes, s_bits, h_bits):
    import torch

    batch = ax.shape[0] if ax.dim() == 2 else -1
    for name, t, width in (
        ("ax", ax, NUM_LIMBS),
        ("ay", ay, NUM_LIMBS),
        ("r_bytes", r_bytes, NUM_LIMBS),
        ("s_bits", s_bits, 256),
        ("h_bits", h_bits, 256),
    ):
        if tuple(t.shape) != (batch, width):
            raise ValueError(f"{name} must be [B, {width}], got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != ax.device:
            raise ValueError("the five inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ed25519_verify_kernel(ax, ay, r_bytes, s_bits, h_bits, backend: str = "vpu"):
    """Verify a packed wave: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``backend`` picks the twin's field multiply,
    "vpu" or "mxu"; the card has the "vpu" kernel only).  Returns [B] bool
    and counts kernel launches in ``ed25519_verify_kernel.launches``."""
    import torch

    if backend not in ("vpu", "mxu"):
        raise ValueError(f"unknown ed25519 kernel backend {backend!r}")
    _check(ax, ay, r_bytes, s_bits, h_bits)
    if ax.device.type == "cpu":
        return verify_torch(
            ax, ay, r_bytes, s_bits, h_bits,
            mul=_mul_mxu if backend == "mxu" else _mul_vpu,
        )
    if ax.device.type != "cuda":
        raise ValueError(f"unsupported device {ax.device}")
    if backend == "mxu":
        raise NotImplementedError(MXU_NOT_PORTED)
    from . import _build

    rows = ax.shape[0]
    out = torch.empty(rows, dtype=torch.uint8, device=ax.device)
    if rows == 0:
        return out.view(torch.bool)  # nothing to launch
    lib = _build.library("ed25519")
    code = lib.mirbft_ed25519_verify(
        ax.data_ptr(),
        ay.data_ptr(),
        r_bytes.data_ptr(),
        s_bits.data_ptr(),
        h_bits.data_ptr(),
        rows,
        out.data_ptr(),
        torch.cuda.current_stream(ax.device).cuda_stream,
    )
    _build.check(lib, code, "ed25519_verify")
    ed25519_verify_kernel.launches += 1
    return out.view(torch.bool)


ed25519_verify_kernel.launches = 0


# ---------------------------------------------------------------------------
# Host side: parsing, hashing, caching, batching; pure-Python reference.
# ---------------------------------------------------------------------------


def _sc_from_bytes_le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _challenge(r_bytes: bytes, pub: bytes, msg: bytes) -> int:
    return _sc_from_bytes_le(hashlib.sha512(r_bytes + pub + msg).digest()) % L


def _pt_add_py(p1, p2):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * t2 * 2 * D % P
    d = z1 * z2 * 2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _pt_mul_py(scalar: int, point):
    acc = (0, 1, 1, 0)
    while scalar:
        if scalar & 1:
            acc = _pt_add_py(acc, point)
        point = _pt_add_py(point, point)
        scalar >>= 1
    return acc


def _compress_py(p) -> bytes:
    x, y, z, _ = p
    z_inv = pow(z, P - 2, P)
    x, y = x * z_inv % P, y * z_inv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def verify_one(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Pure-Python RFC 8032 verification (strict: canonical R, S < L).
    Reference implementation for tests and the small-batch CPU path."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    y = _sc_from_bytes_le(pub) & ((1 << 255) - 1)
    sign = pub[31] >> 7
    ax = _recover_x(y, sign)
    if ax is None:
        return False
    s = _sc_from_bytes_le(sig[32:])
    if s >= L:
        return False
    h = _challenge(sig[:32], pub, msg)
    m_a = (P - ax, y, 1, (P - ax) * y % P)
    q = _pt_add_py(
        _pt_mul_py(s, (_BASE_X, _BASE_Y, 1, _BASE_X * _BASE_Y % P)),
        _pt_mul_py(h, m_a),
    )
    return _compress_py(q) == sig[:32]


_BASE_PT = (_BASE_X, _BASE_Y, 1, _BASE_X * _BASE_Y % P)


def _clamp_scalar(h32: bytes) -> int:
    a = _sc_from_bytes_le(h32)
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def public_from_seed(seed: bytes) -> bytes:
    """RFC 8032 public-key derivation from a 32-byte seed (pure Python)."""
    h = hashlib.sha512(seed).digest()
    return _compress_py(_pt_mul_py(_clamp_scalar(h[:32]), _BASE_PT))


def sign_one(seed: bytes, msg: bytes) -> bytes:
    """Pure-Python RFC 8032 signing — the twin of ``verify_one``.  Slow
    (two scalar mults in host ints) but dependency-free; signatures are
    deterministic and byte-identical to the ``cryptography`` package's."""
    h = hashlib.sha512(seed).digest()
    a = _clamp_scalar(h[:32])
    pub = _compress_py(_pt_mul_py(a, _BASE_PT))
    r = _sc_from_bytes_le(hashlib.sha512(h[32:] + msg).digest()) % L
    r_bytes = _compress_py(_pt_mul_py(r, _BASE_PT))
    s = (r + _challenge(r_bytes, pub, msg) * a) % L
    return r_bytes + s.to_bytes(32, "little")


def keypair_from_seed(seed: bytes):
    """``(public_key_bytes, sign_callable)`` for a 32-byte seed.

    Uses the ``cryptography`` package when installed (C-speed signing);
    otherwise falls back to the pure-Python RFC 8032 path above.  Both
    produce identical deterministic signatures, so sim runs and recorded
    logs are byte-identical across environments.
    """
    try:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey,
        )
    except ImportError:
        return public_from_seed(seed), lambda msg: sign_one(seed, msg)
    key = Ed25519PrivateKey.from_private_bytes(seed)
    pub = key.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )
    return pub, key.sign


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# Process-wide key caches (see Ed25519BatchVerifier.__init__).  The
# eviction cap is module-level: the caches are shared, so a single verifier
# constructed with a small per-instance size must not wipe them for
# everyone.  The limb cache holds ready-to-gather (2, 32) int32 rows
# ([ax; ay]) so a wave of repeated signers costs one table gather.
_SHARED_KEY_CACHE: Dict[bytes, Optional[Tuple[int, int]]] = {}
_SHARED_LIMB_CACHE: Dict[bytes, np.ndarray] = {}
_SHARED_KEY_CACHE_CAP = 65536

# L big-endian bytes for the vectorized S < L screen.
_L_BE = np.frombuffer(L.to_bytes(32, "big"), dtype=np.uint8)


def _s_below_l(s_le: np.ndarray) -> np.ndarray:
    """[k, 32] little-endian S bytes -> [k] bool S < L, via a vectorized
    lexicographic compare: flip to big-endian, find the first byte that
    differs from L's, compare there (equal rows are NOT below L)."""
    s_be = s_le[:, ::-1]
    diff = s_be != _L_BE[None, :]
    first = diff.argmax(axis=1)
    rows = np.arange(s_be.shape[0])
    return diff.any(axis=1) & (s_be[rows, first] < _L_BE[first])


class Ed25519BatchVerifier:
    """Batched Ed25519 verification backed by the CUDA kernel.

    The surface of the JAX package's verifier: ``verify_batch`` pads the
    batch to a power-of-two bucket and issues one kernel launch; results
    come back in input order.  Public-key decompression is cached
    process-wide (clients reuse keys across requests), so the steady-state
    host work per signature is one SHA-512 and bit-packing.
    ``pack_inputs`` / ``dispatch`` / ``collect`` split one wave into host
    packing, an asynchronous launch, and the one host sync.

    ``min_device_batch``: below this the pure-Python path is used — launch
    overhead dominates tiny batches.

    ``kernel``: "auto" (``crossover.resolve_verify_backend``: "vpu"), "vpu"
    or "mxu" (the field-multiply formulation; "mxu" runs on CPU tensors
    only, through the twin).

    ``device``: "cuda" (the default) or "cpu".  On the CPU every wave runs
    the plain PyTorch twin; asking for "cuda" without a card raises.

    ``mesh``: an optional ``parallel.Mesh`` of ``device``'s kind; launches
    then run the batch-sharded verify (``parallel.sharded_ed25519_verify``),
    verdicts produced across the mesh and the byzantine count all-reduced
    over it.  Verdicts are bit-identical to one device's.
    """

    def __init__(
        self,
        min_device_batch: int = 16,
        key_cache_size: int = 65536,
        kernel: str = "auto",
        mesh=None,
        device="cuda",
    ):
        import torch

        if kernel not in ("auto", "vpu", "mxu"):
            raise ValueError(f"unknown ed25519 kernel backend {kernel!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Ed25519BatchVerifier(device='cuda') needs a CUDA device; "
                "pass device='cpu' for the plain PyTorch twin"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        if kernel == "auto" and mesh is not None:
            # The mesh kernel binds its backend at construction.
            from .crossover import resolve_verify_backend

            kernel = resolve_verify_backend(kernel, backend=self.device.type)
        self.mesh = mesh
        self._mesh_fn = None
        self._mesh_size = 1
        if mesh is not None:
            from ..parallel.mesh import sharded_ed25519_verify

            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"a {mesh.device_type} mesh for a {self.device.type} verifier"
                )
            self._mesh_fn = sharded_ed25519_verify(mesh, kernel=kernel)
            self._mesh_size = mesh.size
        self.min_device_batch = min_device_batch
        # The key caches are process-wide, so the eviction cap is too: a
        # small per-instance size must not shrink them for everyone, and a
        # larger request raises the shared cap for everyone.
        global _SHARED_KEY_CACHE_CAP
        _SHARED_KEY_CACHE_CAP = max(key_cache_size, _SHARED_KEY_CACHE_CAP)
        self.kernel = kernel
        # Decompression and limb conversion are pure functions of the key
        # bytes, so the caches are process-wide: clients reuse keys across
        # requests AND across verifier instances.
        self._key_cache = _SHARED_KEY_CACHE
        self._limb_cache = _SHARED_LIMB_CACHE

    def resolved_kernel(self) -> str:
        """The field-multiply backend dispatches actually run: explicit
        settings pass through, "auto" applies ``crossover``'s resolution."""
        from .crossover import resolve_verify_backend

        return resolve_verify_backend(self.kernel, backend=self.device.type)

    def _decompress_pub(self, pub: bytes) -> Optional[Tuple[int, int]]:
        cached = self._key_cache.get(pub)
        if cached is not None or pub in self._key_cache:
            return cached
        result: Optional[Tuple[int, int]] = None
        if len(pub) == 32:
            y = _sc_from_bytes_le(pub) & ((1 << 255) - 1)
            x = _recover_x(y, pub[31] >> 7)
            if x is not None:
                result = (x, y)
        if len(self._key_cache) >= _SHARED_KEY_CACHE_CAP:
            self._key_cache.clear()
            self._limb_cache.clear()
        self._key_cache[pub] = result
        return result

    def _pub_limbs(self, pub: bytes) -> Optional[np.ndarray]:
        """(2, 32) int32 [ax; ay] limb rows for a compressed key; cached
        process-wide so repeated signers cost one dict hit + table gather."""
        limbs = self._limb_cache.get(pub)
        if limbs is not None:
            return limbs
        point = self._decompress_pub(pub)
        if point is None:
            return None
        limbs = np.stack([int_to_limbs(point[0]), int_to_limbs(point[1])])
        self._limb_cache[pub] = limbs
        return limbs

    def verify_batch(
        self,
        pubs: Sequence[bytes],
        msgs: Sequence[bytes],
        sigs: Sequence[bytes],
    ) -> np.ndarray:
        n = len(pubs)
        if not (n == len(msgs) == len(sigs)):
            raise ValueError("pubs, msgs, sigs must have equal lengths")
        if n == 0:
            return np.zeros(0, dtype=bool)
        if n < self.min_device_batch:
            return np.array(
                [verify_one(p, m, s) for p, m, s in zip(pubs, msgs, sigs)],
                dtype=bool,
            )
        return self.collect(self.dispatch(pubs, msgs, sigs))

    def pack_inputs(
        self,
        pubs: Sequence[bytes],
        msgs: Sequence[bytes],
        sigs: Sequence[bytes],
        batch: Optional[int] = None,
    ):
        """Host-side packing: decompress keys (cached), hash challenges,
        convert to the kernel's limb/bit arrays.  Returns
        (ax, ay, r_bytes, s_bits, h_bits, valid) padded to ``batch`` rows
        (default: next power of two).

        Vectorized over the wave: signature bytes are stacked with one
        ``np.frombuffer`` over the joined rows, the S < L screen is one
        lexicographic compare, and per-signer limbs come from the shared
        cache via a single table gather (``limbs_from_le_bytes`` is the
        bulk fallback shape).  The remaining per-row Python work is the
        SHA-512 challenge, which is a C hashlib call per signature."""
        import time as _time

        from .. import metrics

        start = _time.perf_counter()
        n = len(pubs)
        if batch is None:
            batch = _next_pow2(n)
        elif batch < n:
            raise ValueError(f"batch {batch} smaller than input length {n}")
        ax = np.zeros((batch, NUM_LIMBS), dtype=np.int32)
        ay = np.zeros((batch, NUM_LIMBS), dtype=np.int32)
        r_bytes = np.zeros((batch, NUM_LIMBS), dtype=np.int32)
        valid = np.zeros(batch, dtype=bool)

        # Scalar byte buffers filled by bulk assignment, bit-unpacked in one
        # vectorized pass at the end.
        s_raw = np.zeros((batch, 32), dtype=np.uint8)
        h_raw = np.zeros((batch, 32), dtype=np.uint8)

        # Structural screen + per-signer dedup: rows with a 64-byte
        # signature and a decompressible key survive; each distinct key is
        # decompressed (or cache-hit) once and referenced by table index.
        rows: List[int] = []
        key_idx: List[int] = []
        key_table: List[np.ndarray] = []
        key_slot: Dict[bytes, int] = {}
        sig_rows: List[bytes] = []
        for i, (pub, sig) in enumerate(zip(pubs, sigs)):
            if len(sig) != 64:
                continue
            pub_b = bytes(pub)
            slot = key_slot.get(pub_b)
            if slot is None:
                limbs = self._pub_limbs(pub_b)
                slot = -1 if limbs is None else len(key_table)
                if slot >= 0:
                    key_table.append(limbs)
                key_slot[pub_b] = slot
            if slot < 0:
                continue
            rows.append(i)
            key_idx.append(slot)
            sig_rows.append(bytes(sig))

        if rows:
            sig_mat = np.frombuffer(b"".join(sig_rows), dtype=np.uint8)
            sig_mat = sig_mat.reshape(len(rows), 64)
            keep = _s_below_l(sig_mat[:, 32:])
            idx = np.asarray(rows, dtype=np.int64)[keep]
            picked = np.stack(key_table)[np.asarray(key_idx)[keep]]
            valid[idx] = True
            ax[idx] = picked[:, 0]
            ay[idx] = picked[:, 1]
            r_bytes[idx] = sig_mat[keep, :32].astype(np.int32)
            s_raw[idx] = sig_mat[keep, 32:]
            for j in np.nonzero(keep)[0]:
                i = rows[j]
                h = _challenge(sig_rows[j][:32], bytes(pubs[i]), bytes(msgs[i]))
                h_raw[i] = np.frombuffer(
                    h.to_bytes(32, "little"), dtype=np.uint8
                )
        s_bits = np.unpackbits(s_raw, axis=1, bitorder="little").astype(np.int32)
        h_bits = np.unpackbits(h_raw, axis=1, bitorder="little").astype(np.int32)
        metrics.histogram("verify_pack_seconds").observe(
            _time.perf_counter() - start
        )
        return ax, ay, r_bytes, s_bits, h_bits, valid

    def dispatch(
        self,
        pubs: Sequence[bytes],
        msgs: Sequence[bytes],
        sigs: Sequence[bytes],
        n_real: Optional[int] = None,
    ) -> "VerifyDispatch":
        """Asynchronously verify a batch: packs the inputs, copies the five
        arrays to the device, launches ONE kernel on the current stream and
        records an event; returns without waiting for the kernel.  Use
        ``collect`` to materialize the verdicts.

        ``n_real``: rows that carry actual signatures when the CALLER
        already padded the batch (wave-shape padding); the mesh path's
        byzantine count and the verified-signature counters cover only
        those rows."""
        import torch

        from .. import metrics

        n = len(pubs)
        if n_real is None:
            n_real = n
        batch = None
        if self._mesh_fn is not None:
            # The batch dimension shards over the mesh: round up to a
            # multiple of the mesh size (a power-of-two batch already is
            # one for power-of-two meshes, but not e.g. for 6 devices).
            batch = _next_pow2(n)
            if batch % self._mesh_size:
                batch = (
                    (batch + self._mesh_size - 1)
                    // self._mesh_size
                    * self._mesh_size
                )
        ax, ay, r_bytes, s_bits, h_bits, valid = self.pack_inputs(
            pubs, msgs, sigs, batch=batch
        )
        start = time.perf_counter()
        if self._mesh_fn is not None:
            real = np.zeros(len(valid), dtype=bool)
            real[:n_real] = True
            ok, _invalid = self._mesh_fn(
                ax, ay, r_bytes, s_bits, h_bits,
                np.asarray(valid, dtype=bool), real,
            )
            metrics.counter("mesh_verify_dispatches").inc()
            metrics.counter("mesh_verified_signatures").inc(n_real)
        else:
            ok = ed25519_verify_kernel(
                *(torch.from_numpy(a).to(self.device)
                  for a in (ax, ay, r_bytes, s_bits, h_bits)),
                backend=self.resolved_kernel(),
            )
        event = None
        if ok.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(ok.device))
        metrics.histogram("verify_device_dispatch_seconds").observe(
            time.perf_counter() - start
        )
        return VerifyDispatch(ok, valid, n, event)

    def collect(self, handle: "VerifyDispatch") -> np.ndarray:
        """Block until a dispatch's verdicts are host-resident."""
        ok = handle.ok.cpu().numpy()
        return ok[: handle.count] & handle.valid[: handle.count]


class VerifyDispatch:
    """An in-flight verification launch: the device-resident verdicts, the
    host-side structural-validity mask, and the event recorded after the
    launch on the card (None on the CPU)."""

    __slots__ = ("ok", "valid", "count", "event")

    def __init__(self, ok, valid: np.ndarray, count: int, event=None):
        self.ok = ok
        self.valid = valid
        self.count = count
        self.event = event
