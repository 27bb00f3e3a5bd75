"""Static-shape arithmetic (counterpart of ``pypardis_tpu/utils/shaping.py``).

Every capacity is rounded to a tile multiple; the numbers must match the
JAX package exactly, because the tile grid fixes the Morton layout and
with it the cluster numbering.
"""

from __future__ import annotations


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= x."""
    return -(-x // multiple) * multiple


def clamp_block(block: int, n: int, floor: int = 128) -> int:
    """Shrink a tile block for small problems: no wider than the next
    power of two above ``n`` and no narrower than ``floor``."""
    return min(block, max(floor, 1 << (max(n, 1) - 1).bit_length()))


def row_chunks(n: int, k: int):
    """``(start, end)`` row ranges of about 128 KiB of float32 each: how a
    host copy of ``(n, k)`` rows into a transposed ``(k, n)`` layout is
    cut.  Done whole, every write misses the cache (about 6x slower at
    512 axes); the values are the same either way."""
    step = max(64, (1 << 17) // max(int(k), 1))
    return [(s, min(s + step, n)) for s in range(0, n, step)]
