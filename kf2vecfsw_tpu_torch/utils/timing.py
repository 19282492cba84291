"""Elapsed-time helpers (reference: utils.py:320-328)."""

from __future__ import annotations


def hms(seconds: float) -> tuple[int, int, int]:
    h = seconds // 3600
    m = seconds % 3600 // 60
    s = seconds % 3600 % 60
    return int(h), int(m), int(s)
