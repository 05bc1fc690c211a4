"""Build and bind the port's CUDA kernels: ``nvcc`` into a plain-C shared
library, loaded with ``ctypes``.

Each source under ``csrc/`` compiles for ``sm_90a`` into
``_build/lib<name>-<key>.so``, where ``key`` hashes the source text and the
flags, so an edited source rebuilds and an unchanged one is reused.  Builds
happen at first use (``library``) or all at once (``build_all``, one
``nvcc`` per source, started together), never at import: the CPU tests import
every module on a machine with no CUDA toolkit.  ``ptxas -v`` output (each
kernel's registers, shared memory and spills) is kept beside the library as
``lib<name>-<key>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
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
}

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


def so_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        source = fh.read()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{key[:16]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library is already built."""
    target = so_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate(timeout=600)
    target = so_path(name)
    tmp = f"{target}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    with open(target[: -len(".so")] + ".ptxas.txt", "w") as fh:
        fh.write(out)
    os.replace(tmp, target)  # atomic: concurrent builders race benignly


def build_all() -> Dict[str, float]:
    """Build every source in parallel; returns wall seconds per source
    (0.0 for a library that was already built)."""
    names = sorted(SIGNATURES)
    start = time.perf_counter()
    procs = {name: _start(name) for name in names}
    seconds = {}
    for name in names:
        if procs[name] is not None:
            _finish(name, procs[name])
        seconds[name] = (
            time.perf_counter() - start if procs[name] is not None else 0.0
        )
    return seconds


def ptxas_report(name: str) -> str:
    path = so_path(name)[: -len(".so")] + ".ptxas.txt"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` set for every launcher."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc = _start(name)
            if proc is not None:
                _finish(name, proc)
            lib = ctypes.CDLL(so_path(name))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.mirbft_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code}: {msg}")
