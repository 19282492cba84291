"""Training-step helpers (the port's copy of what it needs from the JAX
package's ``train/step.py``; the optimizer and step plans arrive with the
training slice)."""

from __future__ import annotations


def bucket_items(n_items: int, floor: int = 8) -> int:
    """Pad the item dimension to a geometric bucket (ratio 1.25, multiples
    of 8), as the JAX package does, so padded shapes depend only on the
    bucket and not on the exact count."""
    b = floor
    while b < n_items:
        b = -(-int(b * 1.25) // 8) * 8
    return b
