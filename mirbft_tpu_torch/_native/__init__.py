"""Native (C++) hot-path planes, built on first import.

The consensus state machine stays in Python (branchy protocol logic — see
SURVEY.md §7), but the per-message vote-accumulation hot loops run O(N²)
times per request cluster-wide and dominate wall-clock at 64+ replicas, so
they are implemented natively.  Rules of engagement:

* Pure-Python equivalents remain in ``mirbft_tpu_torch/statemachine/`` and are the
  semantic reference; differential tests assert byte-identical behavior.
* The extension is optional: if no toolchain is available (or
  ``MIRBFT_TPU_NATIVE=0``), everything runs pure-Python.
* Built with a direct ``g++`` invocation (no setuptools machinery, no
  pybind11 — neither is guaranteed in the image); the .so is cached next to
  the source and rebuilt when the source is newer.

Sanitizer lane: with ``MIRBFT_TPU_SANITIZE=address[,undefined]`` set, both
extensions build with the requested ``-fsanitize=`` instrumentation into
``_native/sanitized/`` and load from there, so the whole native plane —
including the PDES differential tests — runs against instrumented code.
The hosting python is not ASan-built, so the caller must put the sanitizer
runtime first in the process (``LD_PRELOAD``); ``sanitizer_preload()``
below names the library, and ``tools/build_native.py --sanitize=...``
prints a ready-to-paste invocation (docs/STATIC_ANALYSIS.md).
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
from typing import Optional, Sequence, Tuple

available = False
core = None
fast_available = False
fast = None

_HERE = os.path.dirname(__file__)
_SAN_DIR = os.path.join(_HERE, "sanitized")
_SRC = os.path.join(_HERE, "ackplane.cpp")
_SO = os.path.join(_HERE, "_core.so")
_FAST_SRC = os.path.join(_HERE, "fastengine.cpp")
_FAST_SO = os.path.join(_HERE, "_fast.so")

SANITIZERS = ("address", "undefined")


def sanitizers_from_env() -> Tuple[str, ...]:
    """The ``MIRBFT_TPU_SANITIZE`` selection, validated."""
    raw = os.environ.get("MIRBFT_TPU_SANITIZE", "")
    selected = tuple(s.strip() for s in raw.split(",") if s.strip())
    unknown = set(selected) - set(SANITIZERS)
    if unknown:
        raise ValueError(
            f"MIRBFT_TPU_SANITIZE names unknown sanitizers {sorted(unknown)}; "
            f"supported: {', '.join(SANITIZERS)}"
        )
    return selected


def _flags(sanitizers: Sequence[str] = ()) -> list:
    flags = ["-std=c++17", "-shared", "-fPIC", "-pthread"]
    if sanitizers:
        # -O1 keeps stack traces honest; frame pointers make them cheap.
        flags += [
            "-O1",
            "-g",
            "-fno-omit-frame-pointer",
            f"-fsanitize={','.join(sanitizers)}",
        ]
    else:
        flags.append("-O2")
    return flags


def sanitizer_preload(sanitizers: Sequence[str]) -> Optional[str]:
    """The runtime library a non-instrumented python must LD_PRELOAD to
    host an instrumented extension (ASan insists on being loaded first;
    libubsan rides along as an ordinary dependency of the .so)."""
    if "address" not in sanitizers:
        return None
    try:
        out = subprocess.run(
            ["g++", "-print-file-name=libasan.so"],
            check=True,
            capture_output=True,
            text=True,
            timeout=30,
        ).stdout.strip()
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    return out if os.path.isabs(out) else None


def sanitized_so_path(so: str) -> str:
    return os.path.join(_SAN_DIR, os.path.basename(so))


def _build(src: str, so: str, sanitizers: Sequence[str] = ()) -> bool:
    include = sysconfig.get_paths()["include"]
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = so + ".tmp"
    cmd = ["g++", *_flags(sanitizers), "-I", include, src, "-o", tmp]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=600
        )
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False
    os.replace(tmp, so)  # atomic: concurrent builders race benignly
    return True


def _import_so(modname: str, so: str):
    """Import an extension module, from the package directory (normal
    import) or from an arbitrary path (sanitized artifacts — the PyInit
    symbol comes from the last dotted component, so the qualified name
    must keep the ``_core``/``_fast`` tail)."""
    import importlib
    import importlib.util

    qualname = f"{__name__}.{modname}"
    if os.path.dirname(so) == _HERE:
        return importlib.import_module(qualname)
    spec = importlib.util.spec_from_file_location(qualname, so)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {so}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules[qualname] = module
    return module


def _load_one(
    src: str, so: str, modname: str, sanitizers: Sequence[str] = ()
):
    """Build (if stale) and import one extension; returns the module or None."""
    try:
        needs_build = (not os.path.exists(so)) or (
            os.path.getmtime(src) > os.path.getmtime(so)
        )
    except OSError:
        needs_build = True
    if needs_build and not _build(src, so, sanitizers):
        return None
    try:
        return _import_so(modname, so)
    except ImportError:
        # A stale ABI-incompatible artifact: rebuild once.
        if not _build(src, so, sanitizers):
            return None
        try:
            return _import_so(modname, so)
        except ImportError:
            return None


def build_sanitized(
    sanitizers: Sequence[str], force: bool = False
) -> dict:
    """Build both extensions with instrumentation into
    ``_native/sanitized/``; returns {modname: so_path or None}."""
    out = {}
    for src, so, modname in (
        (_SRC, _SO, "_core"),
        (_FAST_SRC, _FAST_SO, "_fast"),
    ):
        target = sanitized_so_path(so)
        stale = force or (not os.path.exists(target)) or (
            os.path.getmtime(src) > os.path.getmtime(target)
        )
        if stale and not _build(src, target, sanitizers):
            out[modname] = None
        else:
            out[modname] = target
    return out


def _load() -> None:
    global available, core
    if os.environ.get("MIRBFT_TPU_NATIVE", "1") == "0":
        return
    sanitizers = sanitizers_from_env()
    so = sanitized_so_path(_SO) if sanitizers else _SO
    core = _load_one(_SRC, so, "_core", sanitizers)
    available = core is not None


_fast_attempted = False


def load_fast():
    """Build/load the fast-engine extension on first use (lazy: a cold
    compile of fastengine.cpp takes ~35 s, which plain package importers —
    tests of unrelated modules, the graft entry compile check — should not
    pay).  Returns the module or None."""
    global fast, fast_available, _fast_attempted
    if _fast_attempted:
        return fast
    _fast_attempted = True
    if os.environ.get("MIRBFT_TPU_NATIVE", "1") == "0":
        return None
    sanitizers = sanitizers_from_env()
    so = sanitized_so_path(_FAST_SO) if sanitizers else _FAST_SO
    fast = _load_one(_FAST_SRC, so, "_fast", sanitizers)
    fast_available = fast is not None
    return fast


_load()
