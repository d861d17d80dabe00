"""Z-order (Morton) curve indexing.

The reference vendors libmorton (source/soillib/external/, 1322 LoC) —
unreferenced by current soillib code but part of its surface (SURVEY.md
§2.8). Provided here as branch-free jnp bit-interleaving; useful for
locality-preserving reorderings of sparse cell sets (e.g. particle
binning).
"""

from __future__ import annotations

import jax.numpy as jnp

def _part1by1(x):
    """Spread the low 16 bits of x into the even bit positions."""
    x = jnp.asarray(x, jnp.uint32) & jnp.uint32(0x0000FFFF)
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x


def _compact1by1(x):
    """Inverse of _part1by1: gather even bit positions into the low 16."""
    x = jnp.asarray(x, jnp.uint32) & jnp.uint32(0x55555555)
    x = (x | (x >> 1)) & jnp.uint32(0x33333333)
    x = (x | (x >> 2)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & jnp.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & jnp.uint32(0x0000FFFF)
    return x


def encode2(x, y):
    """(x, y) int arrays -> uint32 Morton codes (x in even bits)."""
    return _part1by1(x) | (_part1by1(y) << 1)


def decode2(code):
    """uint32 Morton codes -> (x, y) int32 arrays."""
    c = jnp.asarray(code, jnp.uint32)
    return (
        _compact1by1(c).astype(jnp.int32),
        _compact1by1(c >> 1).astype(jnp.int32),
    )
