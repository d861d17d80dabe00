"""Linear upwind transport sweep (`transportMethod="field-static"`).

The transport fixed point iterates G <- PUSH(att * (E + G)) for `iters`
rounds (ops/transport.py) in channel-first (C, W, H) layout; XLA fuses
each round's weighted push into one pass over the payload.

The sharded solve (parallel/halo.py `ShardHalo.run_transport`) advances
HALO_K rounds block-locally between K-wide halo exchanges. Correctness
argument (trapezoid rule): one upwind round propagates information
exactly one cell, so after k rounds only block cells within k of the
padded edge are stale; keeping the interior after K rounds reproduces K
global rounds exactly. Global boundaries are handled by zero padding:
vx = vy = 0 outside the domain means no emission, and outflow into the
pad is dropped — identical to `upwind_push`'s lost-at-boundary semantics
(path.cu:104).

Ref: the MC trajectory loop this replaces is path.cu:52-139 /
erosion.cu:29-141.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Rounds advanced per halo exchange == halo ring width of the sharded
# K-blocked solves (transport and cohort).
HALO_K = 16


def _round_weights(vx, vy):
    """Loop-invariant outflow mask-weights: payload leaving toward
    +x/-x/+y/-y is payload * M_dir (|v̂x| : |v̂y| split, ops/transport.py)."""
    ax, ay = jnp.abs(vx), jnp.abs(vy)
    denom = ax + ay
    denom = jnp.where(denom == 0.0, 1.0, denom)
    wx, wy = ax / denom, ay / denom
    z = jnp.zeros_like(wx)
    return (
        jnp.where(vx > 0, wx, z),
        jnp.where(vx < 0, wx, z),
        jnp.where(vy > 0, wy, z),
        jnp.where(vy < 0, wy, z),
    )


def upwind_push_cf(payload, vx, vy):
    """Channel-first implementation of one PUSH round."""
    mxp, mxn, myp, myn = _round_weights(vx, vy)

    def shift_from(a, dx, dy):
        pad = [(0, 0)] * (a.ndim - 2) + [(max(0, dx), max(0, -dx)),
                                         (max(0, dy), max(0, -dy))]
        ap = jnp.pad(a, pad)
        W, H = a.shape[-2], a.shape[-1]
        x0, y0 = max(0, -dx), max(0, -dy)
        return ap[..., x0:x0 + W, y0:y0 + H]

    return (
        shift_from(payload * mxp[None], +1, 0)
        + shift_from(payload * mxn[None], -1, 0)
        + shift_from(payload * myp[None], 0, +1)
        + shift_from(payload * myn[None], 0, -1)
    )


def transport_advance_reference(G0, E, att, vx, vy, iters: int):
    """`iters` rounds of G <- PUSH(att * (E + G)) from an arbitrary G0.

    Args:
      G0:   (C, W, H) initial inflow state (zeros for a fresh solve).
      E:    (C, W, H) per-cell emission (channel-first).
      att:  (C, W, H) per-cell, per-channel attenuation.
      vx, vy: (W, H) unit flow direction components.
      iters: number of rounds (static).
    """
    def body(_, G):
        return upwind_push_cf(att * (E + G), vx, vy)

    return jax.lax.fori_loop(0, iters, body, G0)


def transport_sweep_reference(E, att, vx, vy, iters: int):
    """`iters` rounds of G <- PUSH(att * (E + G)) from G = 0."""
    return transport_advance_reference(
        jnp.zeros_like(E), E, att, vx, vy, iters
    )


def run_transport(E, att, vx, vy, iters: int):
    """Single-device `iters`-round transport solve (channel-first)."""
    return transport_sweep_reference(E, att, vx, vy, int(iters))
