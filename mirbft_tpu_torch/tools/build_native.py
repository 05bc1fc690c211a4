"""Build the native engines explicitly, optionally instrumented.

The extensions normally build lazily on first import; this CLI exists for
CI lanes and for the sanitizer builds, which want the (slow) compile to
happen at a predictable time with a visible result.

Usage::

    python -m mirbft_tpu_torch.tools.build_native                # plain -O2 .so's
    python -m mirbft_tpu_torch.tools.build_native --sanitize=address,undefined

``--sanitize`` builds into ``mirbft_tpu_torch/_native/sanitized/`` and prints
the environment needed to run the test suite against the instrumented
artifacts (the hosting python is not ASan-built, so the ASan runtime must
be LD_PRELOADed, and leak detection is disabled because CPython itself
"leaks" interned objects at exit).  The sanitize pytest lane
(``pytest -m sanitize``) drives exactly that invocation as a subprocess —
see docs/STATIC_ANALYSIS.md.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .. import _native


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mirbft_tpu_torch.tools.build_native",
        description="build the native engines (optionally sanitized)",
    )
    parser.add_argument(
        "--sanitize",
        default="",
        metavar="{address,undefined}[,...]",
        help="comma-separated sanitizers; builds into _native/sanitized/",
    )
    parser.add_argument(
        "--force",
        action="store_true",
        help="rebuild even if the artifact is newer than the source",
    )
    args = parser.parse_args(argv)
    sanitizers = tuple(
        s.strip() for s in args.sanitize.split(",") if s.strip()
    )
    unknown = set(sanitizers) - set(_native.SANITIZERS)
    if unknown:
        parser.error(
            f"unknown sanitizers {sorted(unknown)}; "
            f"supported: {', '.join(_native.SANITIZERS)}"
        )

    if not sanitizers:
        ok = True
        for src, so, name in (
            (_native._SRC, _native._SO, "_core"),
            (_native._FAST_SRC, _native._FAST_SO, "_fast"),
        ):
            if _native._build(src, so):
                print(f"built {name}: {so}")
            else:
                print(f"FAILED to build {name} from {src}", file=sys.stderr)
                ok = False
        return 0 if ok else 1

    built = _native.build_sanitized(sanitizers, force=args.force)
    ok = True
    for name, so in sorted(built.items()):
        if so is None:
            print(f"FAILED to build sanitized {name}", file=sys.stderr)
            ok = False
        else:
            print(f"built {name} [{','.join(sanitizers)}]: {so}")
    if not ok:
        return 1
    env = [f"MIRBFT_TPU_SANITIZE={','.join(sanitizers)}"]
    preload = _native.sanitizer_preload(sanitizers)
    if preload:
        env.append(f"LD_PRELOAD={preload}")
    if "address" in sanitizers:
        env.append("ASAN_OPTIONS=detect_leaks=0")
    print("run the native-plane tests against the instrumented engines:")
    print(
        "  env "
        + " ".join(env)
        + " JAX_PLATFORMS=cpu python -m pytest tests/ -m sanitize -q"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
