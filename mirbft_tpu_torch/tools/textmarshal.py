"""Compact single-line text rendering of events/actions/messages.

Rebuild of reference ``cmd/mircat/textmarshal.go``: a dense, digest-
truncating representation for log scanning (full ``repr`` is available via
``--verbose-text``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

_MAX_BYTES_SHOWN = 4


def _render(value: Any) -> str:
    if isinstance(value, bytes):
        if not value:
            return '""'
        if len(value) <= _MAX_BYTES_SHOWN:
            return value.hex()
        return value[:_MAX_BYTES_SHOWN].hex() + "..."
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return compact_text(value)
    if isinstance(value, tuple):
        if len(value) > 3:
            rendered = ", ".join(_render(v) for v in value[:3])
            return f"[{rendered}, ... {len(value)} total]"
        return "[" + ", ".join(_render(v) for v in value) + "]"
    return str(value)


def compact_text(obj: Any) -> str:
    """One-line `Type(field=value ...)` rendering with truncated digests."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return _render(obj)
    parts = []
    for field in dataclasses.fields(obj):
        value = getattr(obj, field.name)
        if value is None or value == () or value == b"" and field.name != "digest":
            continue
        parts.append(f"{field.name}={_render(value)}")
    return f"{type(obj).__name__}({' '.join(parts)})"
