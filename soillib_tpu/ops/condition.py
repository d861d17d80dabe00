"""Hydrological DEM conditioning (reference workload: dem_condition.py).

The reference conditions DEMs with the external `pysheds` package
(fill_pits / fill_depressions / resolve_flats, dem_condition.py:32-41)
before running its own flow ops. Here conditioning is native: the
Planchon–Darboux "flooding" algorithm expressed as an
iterated D4/D8 min-stencil —

    W0 = +inf everywhere except boundary cells (= h there)
    W  <- max(h, min_k(W_k + eps_k))     until fixed point

which fills every closed depression to its spill level (+ a tiny epsilon
gradient so flow directions resolve across the filled flats, the role of
pysheds' resolve_flats). Each sweep is one fused stencil pass; the
iteration count is bounded by the longest drainage path, checked with a
convergence test inside `lax.while_loop`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from soillib_tpu.core.grid import D8, shifts_for, shift_lengths
from soillib_tpu.ops.stencil import _shift


def fill_depressions(height, edge: int = D8, eps: float = 1e-4,
                     max_iters: int = None):
    """Fill closed depressions to their spill level (Planchon–Darboux).

    Args:
      height: (W, H) DEM; NaN cells are treated as data holes that drain
        freely (they act as boundaries, like pysheds' nodata).
      edge: D4 or D8 connectivity.
      eps: per-unit-distance epsilon gradient imposed on filled flats so
        `steepest`/`direction` resolve across them (resolve_flats analog).
      max_iters: optional hard bound on sweeps (default W*H, the true
        worst case; the convergence test exits far earlier in practice).

    Returns:
      (W, H) conditioned DEM, >= height everywhere, equal outside
      depressions.
    """
    # dtype-preserving: pass float64 input (with jax_enable_x64) to match
    # the reference's note that float64 is required to reproduce external
    # flow-direction state exactly (dem_condition.py:45-49).
    h = jnp.asarray(height)
    if not jnp.issubdtype(h.dtype, jnp.floating):
        h = h.astype(jnp.float32)
    W, H = h.shape
    shifts = shifts_for(edge)
    lens = shift_lengths(edge)
    if max_iters is None:
        max_iters = W * H

    hole = jnp.isnan(h)
    hs = jnp.where(hole, -jnp.inf, h)

    x = jnp.arange(W)[:, None]
    y = jnp.arange(H)[None, :]
    boundary = (x == 0) | (x == W - 1) | (y == 0) | (y == H - 1)
    # Cells next to a hole spill into it like a boundary.
    near_hole = jnp.zeros_like(hole)
    for dx, dy in shifts:
        near_hole = near_hole | _shift(hole, int(dx), int(dy), False)
    seed = boundary | near_hole | hole

    w0 = jnp.where(seed, hs, jnp.inf)

    def lower(w):
        best = jnp.full_like(w, jnp.inf)
        for (dx, dy), L in zip(shifts, lens):
            wn = _shift(w, int(dx), int(dy), jnp.inf)
            best = jnp.minimum(best, wn + eps * float(L))
        return jnp.maximum(hs, jnp.minimum(w, best))

    def cond(carry):
        w, prev_changed, it = carry
        return prev_changed & (it < max_iters)

    def body(carry):
        w, _, it = carry
        w2 = lower(w)
        return w2, jnp.any(w2 != w), it + 1

    w, _, _ = jax.lax.while_loop(cond, body, (w0, jnp.bool_(True), 0))
    return jnp.where(hole, jnp.nan, w)


def condition(height, edge: int = D8, eps: float = 1e-4):
    """Full conditioning pipeline: depression filling + flat resolution
    (both handled by the epsilon-graded Planchon–Darboux fill). Mirrors
    the pysheds sequence the reference uses (dem_condition.py:32-41)."""
    return fill_depressions(height, edge, eps)
