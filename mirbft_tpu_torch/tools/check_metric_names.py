"""Metric/span name lint — thin shim over mirlint's ``metric-names`` rule.

The implementation moved into ``mirbft_tpu_torch.tools.mirlint`` (parity pass),
which also checks determinism, cross-engine constant parity, lock
discipline and wire-schema drift; run ``python -m mirbft_tpu_torch.tools.mirlint``
for the full plane.  This module keeps the historical entry points
(``check()``, ``REQUIRED_NAMES``, ``python -m
mirbft_tpu_torch.tools.check_metric_names``) so existing tier-1 tests and docs
references keep working.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

from .mirlint import (
    REQUIRED_METRIC_NAMES as REQUIRED_NAMES,
    check_metric_names,
    repo_root,
)

__all__ = ["REQUIRED_NAMES", "check", "main", "repo_root"]


def check(root: Optional[Path] = None) -> List[str]:
    """Return violation messages (empty list = clean)."""
    return [
        f"{finding.path}:{finding.line}: {finding.message}"
        for finding in check_metric_names(root or repo_root())
    ]


def main() -> int:
    violations = check()
    for violation in violations:
        print(violation, file=sys.stderr)
    if violations:
        return 1
    print("metric/span names OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
