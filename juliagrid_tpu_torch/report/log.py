"""Info/warning messages (reference ``@info`` emissions).

Kept in one place so tests can suppress or capture them, mirroring the
reference's use of Julia logging (e.g. acPowerFlow.jl:1134, load.jl:335).
"""

from __future__ import annotations

import sys

_silenced = 0


class suppress:
    """Context manager analogous to Suppressor.@suppress in the tests."""

    def __enter__(self):
        global _silenced
        _silenced += 1
        return self

    def __exit__(self, *exc):
        global _silenced
        _silenced -= 1
        return False


def info(msg: str) -> None:
    if not _silenced:
        print(f"[info] {msg}", file=sys.stderr)


def warn(msg: str) -> None:
    if not _silenced:
        print(f"[warn] {msg}", file=sys.stderr)
