"""Dataset helpers shared by the index builder."""
from __future__ import annotations


def next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()
