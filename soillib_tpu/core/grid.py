"""Grid index-space conventions (replaces the reference's `silt::shape`).

The reference flattens x-major: flat = x * H + y (SURVEY.md §2.9; verified
against example/dem_condition.py:57 and silt view gathers). We therefore store
2-D fields as row-major (W, H) arrays with axis 0 = x, so that
``arr.reshape(-1)[flatten(x, y)] == arr[x, y]`` — golden tests against the
reference's flat tensors line up with no permutation.

Neighbor stencils mirror graph.hpp:21-46: D4 = 4 cardinal shifts, D8 adds the
4 diagonals *after* the cardinals (the slot order matters: accumulate_decay
assigns decay^1.414 to slots >= 4, graph.cu:401-413).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

# Edge-connectivity enumerators (graph.hpp:11-14).
D4 = 0
D8 = 1

# Neighbor shift tables, (K, 2) int32, order matches graph.hpp:21-46.
D4_SHIFTS = np.array(
    [[-1, 0], [0, -1], [0, 1], [1, 0]], dtype=np.int32
)
D8_SHIFTS = np.array(
    [[-1, 0], [0, -1], [0, 1], [1, 0], [-1, -1], [-1, 1], [1, -1], [1, 1]],
    dtype=np.int32,
)


def shifts_for(edge: int) -> np.ndarray:
    """Shift table for an edge enumerator (D4 or D8)."""
    if edge == D4:
        return D4_SHIFTS
    if edge == D8:
        return D8_SHIFTS
    raise ValueError(f"invalid edge enumerator: {edge!r}")


def shift_lengths(edge: int) -> np.ndarray:
    """Euclidean length of each neighbor shift, (K,) float32."""
    sh = shifts_for(edge).astype(np.float32)
    return np.sqrt((sh ** 2).sum(axis=-1))


def check_channel_last(name: str, arr, channels=(2,)):
    """Validate that `arr` is a channel-LAST (W, H, C) field.

    The ops layer (gradient / solve_uniform flow fields) is channel-last
    for grad.cu view parity, while models/parallel state is channel-FIRST
    (C, W, H) so the contiguous dimension is spatial. This seam is easy to trip — a
    mis-laid-out array silently reads garbage W/H — so every channel-last
    entry point validates here and names the expected layout.
    """
    shape = tuple(arr.shape)
    if len(shape) != 3 or shape[-1] not in tuple(channels):
        want = "|".join(str(c) for c in channels)
        raise ValueError(
            f"{name} must be channel-LAST (W, H, {want}); got shape {shape}. "
            f"Note: soil.gradient already returns (W, H, 2) — do not moveaxis "
            f"it. Models/parallel state is channel-FIRST (C, W, H); ops-layer "
            f"flow/gradient fields are channel-LAST."
        )


def check_channel_first(name: str, arr, channels):
    """Validate that `arr` is a channel-FIRST (C, W, H) field (the
    models/parallel convention; see check_channel_last)."""
    shape = tuple(arr.shape)
    if len(shape) != 3 or shape[0] not in tuple(channels):
        want = "|".join(str(c) for c in channels)
        raise ValueError(
            f"{name} must be channel-FIRST ({want}, W, H); got shape {shape}. "
            f"Models/parallel state is channel-FIRST; only ops-layer "
            f"flow/gradient fields are channel-LAST (W, H, C)."
        )


@dataclasses.dataclass(frozen=True)
class Shape:
    """Static 2-D (optionally channelled) index space, like `silt::shape`.

    Only the first two dims participate in flatten/unflatten/oob, matching
    the reference (silt shape is <=3-D with dims 0,1 spatial).
    """

    dims: tuple

    def __init__(self, *dims):
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = tuple(dims[0])
        object.__setattr__(self, "dims", tuple(int(d) for d in dims))

    def __getitem__(self, i: int) -> int:
        return self.dims[i]

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)

    def dim(self) -> int:
        return len(self.dims)

    def elem(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def W(self) -> int:
        return self.dims[0]

    @property
    def H(self) -> int:
        return self.dims[1]

    def flatten(self, pos):
        return flatten(pos, self.dims)

    def unflatten(self, n):
        return unflatten(n, self.dims)

    def oob(self, pos):
        return oob(pos, self.dims)


def flatten(pos, dims):
    """x-major flat index: flat = x * H + y. Works on arrays (..., 2)."""
    H = dims[1]
    pos = jnp.asarray(pos)
    x = pos[..., 0].astype(jnp.int32)
    y = pos[..., 1].astype(jnp.int32)
    return x * H + y


def unflatten(n, dims):
    """Inverse of `flatten`: (..., ) -> (..., 2)."""
    H = dims[1]
    n = jnp.asarray(n)
    return jnp.stack([n // H, n % H], axis=-1).astype(jnp.int32)


def oob(pos, dims):
    """Out-of-bounds test over the first two dims; pos is (..., 2)."""
    pos = jnp.asarray(pos)
    x = pos[..., 0]
    y = pos[..., 1]
    return (x < 0) | (y < 0) | (x >= dims[0]) | (y >= dims[1])


def spatial_shape(arr) -> tuple:
    """(W, H) of a (W, H) or (W, H, C) field."""
    return (arr.shape[0], arr.shape[1])
