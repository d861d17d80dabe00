"""Two-level (tiled) flow accumulation — Barnes-style local/global split.

The plain stencil fixed point (ops/graph_sweep.py) needs L rounds, L =
longest drainage path — O(W+H) or worse for big rivers. Following the
tile-based decomposition of Barnes' trillion-cell flow accumulation
(PAPERS.md, arxiv 1608.04431) and SURVEY.md §7's "block-local contraction
+ boundary-graph combine":

  1. LOCAL:  cut every cross-tile edge and run the masked one-hot stencil
     fixed point — all tiles in parallel, rounds bounded by the longest
     IN-TILE path (typically a few·TILE instead of L; worst case TILE²
     for a serpentine path, which the convergence check handles exactly).
  2. TRACE:  per cell, pull-propagate (also a one-hot stencil, gather-free:
     the receiver is one of 8 neighbors) the in-tile chain's EXIT — the
     entry cell it delivers to in the neighboring tile (X), and the path-
     weight product (D).
  3. COARSE: cross-tile fluxes close over BOUNDARY cells only (an entry
     cell's chain exits at another boundary cell), a ~4N/TILE-node linear
     system solved by pointer-doubling on compact arrays.
  4. INJECT: place the converged entry fluxes back on the grid and run the
     masked stencil once more to distribute them downstream in-tile.

Exact for any per-donor edge weights (accumulate_decay's my_decay
semantics included). All four phases are data-parallel; phases 1/2/4 are
dense stencils, phase 3 is O(#boundary · tiles-crossed) scalar work.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from soillib_tpu.core.grid import D8, shifts_for
from soillib_tpu.ops.graph_sweep import _push_once, fixed_point, roll2

TILE = 128


def _local_slot(W, H, slot, edge):
    """Fold the tile decomposition into the slot graph: cross-tile edges
    become -1 (roots of the LOCAL forest), so the local phases run the
    plain one-hot push with no extra mask reads per round. Also returns
    the cross-edge mask."""
    shifts = shifts_for(edge)
    x = jnp.arange(W)[:, None]
    y = jnp.arange(H)[None, :]
    tx, ty = x // TILE, y // TILE
    cross = jnp.zeros((W, H), bool)
    for d, (dx, dy) in enumerate(shifts):
        same = (((x + int(dx)) // TILE) == tx) & (((y + int(dy)) // TILE) == ty)
        cross = cross | ((slot == d) & ~same)
    return jnp.where(cross, -1, slot), cross


def _pull(value, slot, edge, fill):
    """value[receiver(i)] per cell — gather-free (receiver is a neighbor):
    select the d-rolled copy by the cell's own slot; `fill` at roots."""
    shifts = shifts_for(edge)
    out = jnp.full_like(value, fill)
    for d, (dx, dy) in enumerate(shifts):
        rolled = roll2(value, -int(dx), -int(dy))
        out = jnp.where(slot == d, rolled, out)
    return out


def _boundary_indices(W, H):
    """Static flat indices of all tile-boundary cells (x-major order)."""
    x = np.arange(W)[:, None]
    y = np.arange(H)[None, :]
    bx = (x % TILE == 0) | (x % TILE == TILE - 1) | (x == W - 1)
    by = (y % TILE == 0) | (y % TILE == TILE - 1) | (y == H - 1)
    mask = np.broadcast_to(bx | by, (W, H))
    return np.flatnonzero(mask.reshape(-1)).astype(np.int32)


def _boundary_rank(W, H, flat, fallback):
    """Compact position of global flat index `flat` within
    `_boundary_indices(W, H)` — closed form (the boundary pattern is
    periodic), replacing an argsort + searchsorted over the boundary
    set (`graph.compact_index`). `flat` < 0 (or not a
    boundary cell's index — never queried) maps to `fallback`."""
    T = TILE
    f = jnp.maximum(flat, 0)
    x = f // H
    y = f - x * H

    def nb(z):  # boundary positions strictly before z along one axis
        return (z + T - 1) // T + z // T

    # cols per partial row over the full [0, H) range, incl. the H-1 edge
    # column when it is not already on the periodic pattern
    col_total = (H + T - 1) // T + H // T \
        + (0 if (H - 1) % T in (0, T - 1) else 1)
    # the H-1 edge column sits before y only when y == H-1... never for a
    # queried cell's own column range (c == H-1 < y is impossible), so
    # nb(y) needs no edge term; same for nb(x) and the W-1 row.
    full_rows = nb(x)
    full = (x % T == 0) | (x % T == T - 1) | (x == W - 1)
    rank = full_rows * H + (x - full_rows) * col_total \
        + jnp.where(full, y, nb(y))
    return jnp.where(flat >= 0, rank, fallback)


def accumulate_tiled(direction_slots, value, weight=None, edge: int = D8,
                     max_iters: int = None):
    """Exact upstream accumulation via the two-level scheme.

    Args match ops.graph_sweep.accumulate_stencil; result is identical to
    the single-level fixed point / pointer doubling.
    """
    slot = jnp.asarray(direction_slots)
    v = jnp.asarray(value, jnp.float32)
    W, H = v.shape
    if W <= TILE and H <= TILE:
        from soillib_tpu.ops.graph_sweep import accumulate_stencil

        return accumulate_stencil(slot, v, weight, edge, max_iters)
    if max_iters is None:
        # True worst case for an in-tile path (visits each tile cell once);
        # the convergence check exits at the actual longest path.
        max_iters = TILE * TILE
    w = jnp.ones_like(v) if weight is None else jnp.asarray(weight, jnp.float32)
    is_root = slot < 0
    lslot, cross = _local_slot(W, H, slot, edge)

    # Per cell: the receiver's global flat index (x-major; 0 at roots —
    # never read there). Needed by phases 2 and 3.
    n = jnp.arange(W * H, dtype=jnp.int32).reshape(W, H)
    recv = _pull(n, slot, edge, 0)

    # ---- Phase 1: local accumulation (cross-tile edges cut) --------------
    G_loc = fixed_point(
        lambda G: _push_once(w * (v + G), lslot, edge),
        jnp.zeros_like(v), max_iters,
    )

    # ---- Phase 2: chain exit pointer X and delivery coefficient D --------
    # Flux arriving at a cell is delivered to entry cell X (global flat
    # index in the NEIGHBOR tile) with weight D; roots deliver nowhere.
    X0 = jnp.where(cross, recv, -1)
    # D = w on every edge-bearing cell, 0 at roots (cross cells are
    # never roots, so no special case).
    D0 = jnp.where(is_root, 0.0, w)

    def trace(c):
        X, D = c
        Xr = _pull(X, slot, edge, -1)
        Dr = _pull(D, slot, edge, 0.0)
        in_tile = ~cross & ~is_root
        return (
            jnp.where(in_tile, Xr, X0),
            jnp.where(in_tile, w * Dr, D0),
        )

    X, D = fixed_point(trace, (X0, D0), max_iters)

    # ---- Phase 3: coarse boundary system (compact, pointer-doubled) ------
    from soillib_tpu.ops.graph import operator_doubling

    bidx = jnp.asarray(_boundary_indices(W, H))            # (K,) static
    K = bidx.shape[0]

    # Everything phase 3 needs lives on boundary cells: gather once at
    # bidx and assemble the entry fluxes with a K-sized compact scatter
    # (cross-edge receivers are boundary cells by construction) instead
    # of a grid-sized scatter-then-gather.
    cross_b = cross.reshape(-1)[bidx]
    recv_b = recv.reshape(-1)[bidx]
    flux_b = (w * (v + G_loc)).reshape(-1)[bidx]
    self_idx = jnp.arange(K, dtype=jnp.int32)
    recv_rank = _boundary_rank(W, H, jnp.where(cross_b, recv_b, -1), 0)
    I0 = jnp.zeros(K, jnp.float32).at[recv_rank].add(
        jnp.where(cross_b, flux_b, 0.0)
    )

    Xg = X.reshape(-1)[bidx]                               # exit target (global)
    Dc = D.reshape(-1)[bidx]
    P = _boundary_rank(W, H, Xg, self_idx)                 # closed-form rank
    Wc = jnp.where(Xg >= 0, Dc, 0.0)

    # F = total flux entering each boundary cell from other tiles:
    # F = I0 + C F with C[P[b], b] = Wc[b]; solved by operator doubling.
    F = operator_doubling(I0, P, Wc, int(np.ceil(np.log2(max(K, 2)))))

    # ---- Phase 4: inject entry fluxes and distribute in-tile -------------
    F_grid = jnp.zeros(W * H, jnp.float32).at[bidx].set(F).reshape(W, H)
    G_inj = fixed_point(
        lambda G: _push_once(w * (F_grid + G), lslot, edge),
        jnp.zeros_like(v), max_iters,
    )
    return v + G_loc + F_grid + G_inj
