"""Build and bind the port's CUDA kernels: ``nvcc`` into a plain-C shared
library, loaded with ``ctypes``.

Each source under ``csrc/`` compiles for ``sm_90a`` into
``_build/lib<name>-<key>.so``, where ``key`` hashes the source text, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused.  Builds
happen at first use (``library``) or all at once (``build_all``, one
``nvcc`` per source, started together), never at import: the CPU tests import
every module on a machine with no CUDA toolkit.  ``ptxas -v`` output (each
kernel's registers, shared memory and spills) is kept beside the library as
``lib<name>-<key>.ptxas.txt``.  ``other_library`` builds another revision of
a source the same way, so that the A/B scripts (``ab_sha256.py``,
``ab_ed25519.py``, ``ab_quorum.py``) can time two revisions in one process.
The two Ed25519 verify kernels are two libraries: ``ed25519`` (the "vpu"
backend, ``csrc/ed25519.cu``) and ``ed25519_mxu`` (the tensor-core "mxu"
backend, ``csrc/ed25519_mxu.cu``).

Several processes may reach first use at once (the cohost deployment starts
one per host): every build holds an ``fcntl`` lock on ``_build/.lock``, and
a process that waited on it finds the library built and reuses it, so each
source is compiled once.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong

# Exported launchers of each source: (argtypes, restype).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "sha256": {
        "mirbft_sha256_lanes": ((_P, _P, _P, _I64, _I64, _P), ctypes.c_int),
        "mirbft_sha256_batch": ((_P, _P, _P, _I64, _I64, _P), ctypes.c_int),
        "mirbft_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    },
    "ed25519": {
        "mirbft_ed25519_verify": ((_P, _P, _P, _P, _P, _I64, _P, _P), ctypes.c_int),
        "mirbft_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    },
    "ed25519_mxu": {
        "mirbft_ed25519_verify_mxu": ((_P, _P, _P, _P, _P, _I64, _P, _P), ctypes.c_int),
        "mirbft_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    },
    "quorum": {
        "mirbft_quorum_accumulate": (
            (_P, _P, _I64, _I64, _P, _P, _P, _I64, _I64, _P, _I64, _P, _I64,
             _P, _P, _P, _P, _P, _P, _P),
            ctypes.c_int,
        ),
        "mirbft_quorum_plan": ((_I64, _I64, _I64, _I64, _I64, _P), ctypes.c_int),
        "mirbft_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    },
    "pack": {
        "mirbft_pack_wave": (
            (_P, _I64, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P, _P, _P), ctypes.c_int,
        ),
        "mirbft_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    },
    "mesh": {
        "mirbft_mesh_count": (
            (ctypes.c_int, _P, _P, _P, _P, _P, _I64, _P, _P, _P), ctypes.c_int,
        ),
        "mirbft_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    },
    "latency_probe": {
        "mirbft_chain_latency": ((_P, _I64, _I64, _P), ctypes.c_int),
        "mirbft_chain_links_per_trip": ((), _I64),
        "mirbft_issue_probe": ((_P, _I64, _I64, _I64, _P), ctypes.c_int),
        "mirbft_issue_per_trip": ((), _I64),
        "mirbft_rounds_probe": ((_P, _I64, _I64, _I64, _P), ctypes.c_int),
        "mirbft_field_probe": ((_P, _I64, _I64, _I64, _P), ctypes.c_int),
        "mirbft_mma_probe": ((_P, _I64, _I64, _I64, _P), ctypes.c_int),
        "mirbft_mma_per_trip": ((), _I64),
        "mirbft_tile_probe": ((_P, _I64, _I64, _I64, _P), ctypes.c_int),
        "mirbft_tile_per_trip": ((), _I64),
        "mirbft_empty_launch": ((_P,), ctypes.c_int),
        "mirbft_cuda_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    },
}

# The loaded libraries, filled under ``_lock`` (``library`` reads the dict
# once without it: a library, once stored, is never replaced).
MIRLINT_SHARED_STATE = {"_libs": "_lock"}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build on the "
            "machine with the card"
        )
    return found


def _key(source: str) -> str:
    """Hash of ``source``'s text, the headers beside it (``*.cuh``) and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    folder = os.path.dirname(source)
    headers = sorted(f for f in os.listdir(folder) if f.endswith(".cuh"))
    for path in [source, *(os.path.join(folder, h) for h in headers)]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return digest.hexdigest()[:16]


def _source(name: str, source: Optional[str]) -> str:
    return os.path.join(CSRC, f"{name}.cu") if source is None else os.path.abspath(source)


def so_path(name: str, source: Optional[str] = None) -> str:
    """The library of ``csrc/<name>.cu`` (or of ``source``, another revision
    of it), keyed on its text, every header beside it and the flags."""
    return os.path.join(BUILD_DIR, f"lib{name}-{_key(_source(name, source))}.so")


@contextlib.contextmanager
def _dir_lock():
    """Hold the build directory's lock: one build at a time, across
    processes and threads."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _start(name: str, source: Optional[str] = None) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library is already built
    (the caller holds ``_dir_lock``)."""
    target = so_path(name, source)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name, source)]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, proc: subprocess.Popen, source: Optional[str] = None) -> None:
    out, _ = proc.communicate(timeout=600)
    target = so_path(name, source)
    tmp = f"{target}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {_source(name, source)}:\n{out}")
    with open(target[: -len(".so")] + ".ptxas.txt", "w") as fh:
        fh.write(out)
    os.replace(tmp, target)  # atomic: a reader never sees a partial library


def build_all() -> Dict[str, float]:
    """Build every source in parallel; returns wall seconds per source
    (0.0 for a library that was already built)."""
    names = sorted(SIGNATURES)
    seconds = {}
    with _dir_lock():
        start = time.perf_counter()
        procs = {name: _start(name) for name in names}
        for name in names:
            if procs[name] is not None:
                _finish(name, procs[name])
            seconds[name] = (
                time.perf_counter() - start if procs[name] is not None else 0.0
            )
    return seconds


def ptxas_report(name: str, source: Optional[str] = None) -> str:
    path = so_path(name, source)[: -len(".so")] + ".ptxas.txt"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def ensure_built(name: str, source: Optional[str] = None) -> str:
    """The path of ``source``'s library (``csrc/<name>.cu`` by default),
    compiled first unless it exists; under the build directory's lock, so
    that processes which start together compile it once."""
    with _dir_lock():
        proc = _start(name, source)
        if proc is not None:
            _finish(name, proc, source)
    return so_path(name, source)


def _build_and_load(name: str, source: Optional[str]) -> ctypes.CDLL:
    lib = ctypes.CDLL(ensure_built(name, source))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        if source is not None and not hasattr(lib, fn):
            continue  # an older revision may lack a later helper
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` set for every launcher."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _build_and_load(name, None)
            _libs[name] = lib
    return lib


def other_library(name: str, source: str) -> ctypes.CDLL:
    """``source``, another revision of ``csrc/<name>.cu`` that exports the
    same launchers (for timing the two in turns), built with the same flags
    beside the port's libraries and loaded with those launchers'
    signatures (those it exports: an older revision may lack a later
    helper, such as ``mirbft_quorum_plan``).  Headers it includes are
    taken from beside it."""
    return _build_and_load(name, source)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.mirbft_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code}: {msg}")
