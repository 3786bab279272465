"""One-shot runtime degradation warnings (random weights, stand-ins)."""

from __future__ import annotations

import sys

_seen: set[str] = set()


def warn_once(key: str, message: str) -> None:
    """Print `message` to stderr the first time `key` is seen."""
    if key in _seen:
        return
    _seen.add(key)
    print(f"[labelany3d_tpu_torch] WARNING: {message}", file=sys.stderr)


def reset_warnings() -> None:
    """Forget every key seen, so each warning prints again (a test hook)."""
    _seen.clear()
