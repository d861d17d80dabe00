"""Stencil-form flow accumulation (gather-free).

The pointer-doubling contraction (ops/graph.py) resolves the receiver
forest in O(log N) rounds but each round is a random-access gather and
scatter. This module exploits the graph's structure instead: every edge
points to one
of the 8 NEIGHBORS, so one accumulation hop is a dense 8-direction
one-hot push

    A' = v + PUSH_w(A),   PUSH_w(A)[j] = sum_{d} w * A[j - shift_d]
                                          where slot[j - shift_d] == d,

a pure elementwise stencil (8 masked rolls). The fixed point — reached after
L rounds, L = longest drainage path — equals the exact upstream
accumulation; with per-donor decay weights it equals accumulate_decay
(my_decay semantics incl. diagonal decay^1.414, graph.cu:383-420).

Convergence is detected every BLOCK rounds (values stabilize exactly once
all paths have resolved, so the check is a bitwise compare), bounded by
`max_iters`. Rounds are cheap (one fused pass over 2 fields + masks);
which method wins on a device is measured, not assumed (ops/graph.py
`_auto_method`).

Ref: the workload this serves is graph.cu:527-593 (accumulate /
accumulate_decay, the rake-compress kernels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from soillib_tpu.core.grid import D8, shifts_for

BLOCK = 32  # rounds between convergence checks


def _bits(a):
    """Bit pattern of an array (NaN-safe equality: NaN != NaN would make a
    value-compare convergence check spin for max_iters)."""
    if jnp.issubdtype(a.dtype, jnp.floating):
        nbits = a.dtype.itemsize * 8
        return jax.lax.bitcast_convert_type(a, jnp.dtype(f"int{nbits}"))
    return a


def changed(a, b):
    """True if any element's BIT PATTERN differs — exact fixed-point test
    that also terminates when NaNs have stabilized."""
    return jnp.any(_bits(a) != _bits(b))


def fixed_point(step, init, max_iters):
    """Iterate `step` until bitwise convergence, checked every BLOCK
    rounds; `init` may be any pytree."""
    def block(c):
        return jax.lax.fori_loop(0, BLOCK, lambda _, x: step(x), c)

    def cond(carry):
        cur, prev, it = carry
        ch = jax.tree_util.tree_reduce(
            jnp.logical_or,
            jax.tree_util.tree_map(changed, cur, prev),
        )
        return ch & (it < max_iters)

    def body(carry):
        cur, _, it = carry
        return block(cur), cur, it + BLOCK

    first = block(init)
    out, _, _ = jax.lax.while_loop(cond, body, (first, init, jnp.int32(BLOCK)))
    return out


def roll2(a, dx, dy):
    """jnp.roll by (dx, dy) as per-axis rolls, skipping zero shifts."""
    if dx:
        a = jnp.roll(a, dx, axis=0)
    if dy:
        a = jnp.roll(a, dy, axis=1)
    return a


def _push_once(payload, slot, edge):
    """Dense one-hot push: each cell sends `payload` to its receiver.

    Masks come from slot compares in-loop (cheaper than 8 mask arrays).
    jnp.roll wraps, but receivers never point off-grid (out-of-bounds
    neighbors have NaN slope and are never selected by steepest/
    direction/random_weighted), so every wrapped lane carries zero.
    """
    shifts = shifts_for(edge)
    out = jnp.zeros_like(payload)
    for d, (dx, dy) in enumerate(shifts):
        contrib = jnp.where(slot == d, payload, 0.0)
        out = out + roll2(contrib, int(dx), int(dy))
    return out


def accumulate_stencil(direction_slots, value, weight=None, edge: int = D8,
                       max_iters: int = None):
    """Upstream accumulation from a *direction-slot* graph ((W, H) int32 of
    neighbor slots, -1 at roots — the `direction` op's output).

    Args:
      direction_slots: (W, H) int32 receiver slots.
      value: (W, H) per-cell source.
      weight: optional (W, H) per-donor edge weight (already including the
        diagonal exponent — use ops.graph._edge_weights).
      edge: D4/D8.
      max_iters: hard bound on rounds. Default W*H — the true worst-case
        path length (a descending path visits each cell at most once), so
        the result is always exact; the convergence check exits far
        earlier on real terrain.

    Returns (W, H) float32: value + weighted upstream sum.
    """
    slot = jnp.asarray(direction_slots)
    v = jnp.asarray(value, jnp.float32)
    W, H = v.shape
    if max_iters is None:
        max_iters = W * H
    w = jnp.ones_like(v) if weight is None else jnp.asarray(weight, jnp.float32)
    G = fixed_point(
        lambda G: _push_once(w * (v + G), slot, edge), jnp.zeros_like(v),
        max_iters,
    )
    return v + G
