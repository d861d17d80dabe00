"""Distributed flow accumulation: block-local contraction + global
boundary-graph combine over the device mesh.

The two-level scheme of ops/graph_tiled.py, lifted one level: each DEVICE
BLOCK plays the outer tile. Per block (inside shard_map):

  1. LOCAL   — cut cross-block edges, solve the block forest exactly with
               the single-device tiled accumulator (which nests its own
               128-tiling inside the block).
  2. TRACE   — pull-propagate each cell's block-exit destination (global
               cell id) and path-weight, gather-free.
  3. EXCHANGE+COARSE — cross-block out-fluxes hop to the neighbor blocks'
               edge rings via one halo exchange; the ring cells of all
               blocks form a small global linear system, all-gathered and
               solved replicated by pointer doubling (ring size is
               2(bw+bh) per block — KBs, not the grid).
  4. INJECT  — scatter the converged ring fluxes back and distribute
               in-block with one more local fixed point.

Exact for arbitrary per-donor weights; verified against the single-device
methods on the CPU mesh (tests/test_parallel.py). This is the
"block-local rake-compress + boundary-graph reduction" called for by
SURVEY.md §2.10/§7 — the one long-range-coupled op in the framework.

Known limits: the phase-2 trace is a single-level fixed point (rounds ~
longest in-block path; a two-level trace through the 128-tile boundary
graph is the planned refinement), and global flat cell ids are int32 —
grids beyond 2^31 cells (~46341²) need an int64 id path.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, shard_map

from soillib_tpu.core.grid import D8, shifts_for
from soillib_tpu.ops.graph import (
    _edge_weights,
    compact_index,
    graph_to_slots,
    operator_doubling,
)
from soillib_tpu.ops.graph_sweep import _push_once, fixed_point
from soillib_tpu.ops.graph_tiled import _pull, accumulate_tiled
from soillib_tpu.parallel.halo import ShardHalo
from soillib_tpu.parallel.mesh import check_divisible, grid_spec


def _ring_indices(bw, bh):
    """Static block-local flat indices of the block's edge ring."""
    x = np.arange(bw)[:, None]
    y = np.arange(bh)[None, :]
    mask = (x == 0) | (x == bw - 1) | (y == 0) | (y == bh - 1)
    return np.flatnonzero(mask.reshape(-1)).astype(np.int32)


def _block_cut(slot, bw, bh, edge):
    """Cut edges leaving the device block: slot -> -1 there; also return
    the cross-block mask."""
    shifts = shifts_for(edge)
    x = jnp.arange(bw)[:, None]
    y = jnp.arange(bh)[None, :]
    cross = jnp.zeros((bw, bh), bool)
    for d, (dx, dy) in enumerate(shifts):
        oob = ((x + int(dx)) < 0) | ((x + int(dx)) >= bw) | \
              ((y + int(dy)) < 0) | ((y + int(dy)) >= bh)
        cross = cross | ((slot == d) & oob)
    return jnp.where(cross, -1, slot), cross


def _local_kernel(halo, Wg, Hg, edge, max_iters, slot, v, w):
    bw, bh = v.shape
    shifts = shifts_for(edge)
    lslot, cross = _block_cut(slot, bw, bh, edge)
    is_root = slot < 0

    # Phase 1: exact block-local accumulation on the cut forest.
    G_loc = accumulate_tiled(lslot, v, w, edge, max_iters) - v

    # Phase 2: exit destination (GLOBAL cell id) + path weight, per cell.
    x0, y0, _, _ = halo.global_offsets((bw, bh))
    gx = x0 + jnp.arange(bw, dtype=jnp.int32)[:, None]
    gy = y0 + jnp.arange(bh, dtype=jnp.int32)[None, :]
    dest = jnp.full((bw, bh), -1, jnp.int32)
    for d, (dx, dy) in enumerate(shifts):
        gid = (gx + int(dx)) * Hg + (gy + int(dy))
        dest = jnp.where((slot == d) & cross, gid, dest)

    X0 = dest
    # D = w on every edge-bearing cell, 0 at roots (cross cells never roots).
    D0 = jnp.where(is_root, 0.0, w)

    def trace(c):
        X, D = c
        Xr = _pull(X, slot, edge, -1)
        Dr = _pull(D, slot, edge, 0.0)
        in_block = ~cross & ~is_root
        return (jnp.where(in_block, Xr, X0), jnp.where(in_block, w * Dr, D0))

    X, D = fixed_point(trace, (X0, D0), max_iters)

    # Phase 3a: ship cross-block out-fluxes to the neighbors' edge rings
    # (one 1-ring exchange; arrivals land where the edges point).
    I0 = jnp.zeros((bw, bh), jnp.float32)
    for d, (dx, dy) in enumerate(shifts):
        of = jnp.where((slot == d) & cross, w * (v + G_loc), 0.0)
        ofp = halo.pad(of, 0.0)
        I0 = I0 + halo.crop(
            jnp.roll(ofp, (int(dx), int(dy)), axis=(0, 1))
        )

    # Phase 3b: compact ring data, all-gather, solve replicated.
    ridx = jnp.asarray(_ring_indices(bw, bh))
    my_gid = (gx * Hg + gy).reshape(-1)[ridx]
    ring = (
        I0.reshape(-1)[ridx],
        X.reshape(-1)[ridx],
        D.reshape(-1)[ridx],
        my_gid,
    )
    # gather over Y then X -> leading dims (px, py); tiled=False keeps them.
    gY = [lax.all_gather(r, halo.ay_name) for r in ring]
    gXY = [lax.all_gather(r, halo.ax_name) for r in gY]
    I0c, Xc, Dc, Gc = [r.reshape(-1) for r in gXY]  # (px*py*Kb,)

    # Compact mapping via sort+searchsorted: the replicated working set
    # stays O(#ring cells), never O(grid) ("KBs, not the grid").
    K = I0c.shape[0]
    self_idx = jnp.arange(K, dtype=jnp.int32)
    Pp = compact_index(Gc, Xc, self_idx)
    Wc = jnp.where(Xc >= 0, Dc, 0.0)
    F = operator_doubling(I0c, Pp, Wc, int(np.ceil(np.log2(max(int(K), 2)))))

    # Phase 4: pick my ring's fluxes, inject, distribute in-block.
    my_lin = lax.axis_index(halo.ax_name) * halo.py + lax.axis_index(
        halo.ay_name
    )
    Kb = ridx.shape[0]
    F_mine = lax.dynamic_slice_in_dim(F, my_lin * Kb, Kb)
    F_grid = jnp.zeros(bw * bh, jnp.float32).at[ridx].set(F_mine).reshape(
        bw, bh
    )
    G_inj = fixed_point(
        lambda G: _push_once(w * (F_grid + G), lslot, edge),
        jnp.zeros_like(v), max_iters,
    )
    return v + G_loc + F_grid + G_inj


@functools.lru_cache(maxsize=64)
def _make_accumulate(mesh, edge, Wg, Hg, max_iters):
    halo = ShardHalo(mesh.devices.shape, mesh.axis_names)
    spec = grid_spec(mesh)
    kern = functools.partial(_local_kernel, halo, Wg, Hg, edge, max_iters)
    return jax.jit(
        shard_map(kern, mesh=mesh, in_specs=(spec, spec, spec),
                  out_specs=spec, check_vma=False)
    )


def accumulate(graph, value, edge: int = D8, *, mesh, decay=None,
               max_iters: int = None):
    """Distributed upstream accumulation (optionally decayed) over a 2-D
    device mesh. `graph` holds global flat receiver indices (the sharded
    `parallel.ops.steepest` output)."""
    g = jnp.asarray(graph)
    Wg, Hg = g.shape
    check_divisible((Wg, Hg), mesh)
    px, py = mesh.devices.shape
    bw, bh = Wg // px, Hg // py
    if max_iters is None:
        max_iters = bw * bh
    slots = graph_to_slots(g, edge)
    w = _edge_weights(g, decay, edge)
    fn = _make_accumulate(mesh, edge, Wg, Hg, int(max_iters))
    return fn(slots, jnp.asarray(value, jnp.float32), w)
