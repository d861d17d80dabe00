"""Differential stencil operators over 2-D fields.

Re-designs of the reference's grad ops (model/grad/grad.cu) and the CPU
normal op (op/normal.hpp). All are pure jnp stencils — XLA fuses the
shifted reads into a single pass, which is memory-bandwidth optimal for
these radius-1 kernels.

Boundary semantics are reproduced exactly:
  * gradient:  central difference; where a neighbor is missing, fall back to
    the available one-sided difference, then 0 (grad.cu:62-71).
  * negslope:  per-axis max of *positive* one-sided downhill slopes, ignoring
    missing neighbors; magnitude of the (gx, gy) vector (grad.cu:119-129).
  * laplacian: 9-point = 1/2 * (4-neighbor) + 1/2 * (diagonal, half-weight)
    with clamp-to-edge continuation (grad.cu:163-181).
  * normal:    n = normalize(-gx, -gy, 1) from a lerped central-difference
    gradient (op/normal.hpp:29-34).
"""

from __future__ import annotations

import jax.numpy as jnp


def _shift(h, dx: int, dy: int, fill):
    """h shifted so result[x, y] = h[x + dx, y + dy]; out-of-range -> fill.

    Works for (W, H) and (W, H, C) arrays (shift applies to first two dims).
    """
    pad_width = [(max(0, -dx), max(0, dx)), (max(0, -dy), max(0, dy))]
    pad_width += [(0, 0)] * (h.ndim - 2)
    hp = jnp.pad(h, pad_width, constant_values=fill)
    W, H = h.shape[0], h.shape[1]
    x0 = max(0, -dx) + dx
    y0 = max(0, -dy) + dy
    return hp[x0 : x0 + W, y0 : y0 + H, ...]


def _shift_edge(h, dx: int, dy: int):
    """Shift with clamp-to-edge (reference 'boundary continuation')."""
    W, H = h.shape[0], h.shape[1]
    xi = jnp.clip(jnp.arange(W) + dx, 0, W - 1)
    yi = jnp.clip(jnp.arange(H) + dy, 0, H - 1)
    return h[xi][:, yi, ...]


def gradient(tensor, scale):
    """Central-difference gradient with one-sided boundary fallback.

    Args:
      tensor: (W, H) height field.
      scale: (sx, sy) cell widths.
    Returns:
      (W, H, 2) gradient field. Ref: grad.cu:22-97.
    """
    h = jnp.asarray(tensor)
    sx, sy = float(scale[0]), float(scale[1])
    nan = jnp.float32(jnp.nan)
    hn0 = _shift(h, -1, 0, nan)
    hp0 = _shift(h, +1, 0, nan)
    h0n = _shift(h, 0, -1, nan)
    h0p = _shift(h, 0, +1, nan)

    gxn = (h - hn0) / sx
    gxp = (hp0 - h) / sx
    gyn = (h - h0n) / sy
    gyp = (h0p - h) / sy

    gx = 0.5 * (hp0 - hn0) / sx
    gy = 0.5 * (h0p - h0n) / sy

    # NaN fallback chain: central -> backward -> forward -> 0 (grad.cu:65-71).
    gx = jnp.where(jnp.isnan(gx), gxn, gx)
    gx = jnp.where(jnp.isnan(gx), gxp, gx)
    gx = jnp.where(jnp.isnan(gx), 0.0, gx)
    gy = jnp.where(jnp.isnan(gy), gyn, gy)
    gy = jnp.where(jnp.isnan(gy), gyp, gy)
    gy = jnp.where(jnp.isnan(gy), 0.0, gy)

    return jnp.stack([gx, gy], axis=-1)


def negslope(tensor, scale):
    """'Safe negative slope': norm of per-axis max downhill one-sided slopes.

    Zero in pits; boundaries contribute nothing. Ref: grad.cu:101-141.
    """
    h = jnp.asarray(tensor)
    sx, sy = float(scale[0]), float(scale[1])
    nan = jnp.float32(jnp.nan)
    hn0 = _shift(h, -1, 0, nan)
    hp0 = _shift(h, +1, 0, nan)
    h0n = _shift(h, 0, -1, nan)
    h0p = _shift(h, 0, +1, nan)

    gx = jnp.zeros_like(h)
    gx = jnp.where(~jnp.isnan(hn0), jnp.maximum(gx, (h - hn0) / sx), gx)
    gx = jnp.where(~jnp.isnan(hp0), jnp.maximum(gx, (h - hp0) / sx), gx)
    gy = jnp.zeros_like(h)
    gy = jnp.where(~jnp.isnan(h0n), jnp.maximum(gy, (h - h0n) / sy), gy)
    gy = jnp.where(~jnp.isnan(h0p), jnp.maximum(gy, (h - h0p) / sy), gy)

    return jnp.sqrt(gx * gx + gy * gy)


def laplacian(tensor, scale):
    """9-point Laplacian with clamp-to-edge boundary continuation.

    Accepts (W, H) or (W, H, C) with C in {1, 2} like the reference's channel
    dispatch (grad.cu:196-202) — in fact any C works here.
    Ref: grad.cu:147-206.
    """
    v = jnp.asarray(tensor)
    sx, sy = float(scale[0]), float(scale[1])
    hx = 1.0 / (sx * sx)
    hy = 1.0 / (sy * sy)

    v00 = v
    vn0 = _shift_edge(v, -1, 0)
    vp0 = _shift_edge(v, +1, 0)
    v0n = _shift_edge(v, 0, -1)
    v0p = _shift_edge(v, 0, +1)
    vnn = _shift_edge(v, -1, -1)
    vpp = _shift_edge(v, +1, +1)
    vpn = _shift_edge(v, +1, -1)
    vnp = _shift_edge(v, -1, +1)

    LH = (vn0 - v00) * hx + (vp0 - v00) * hx + (v0n - v00) * hy + (v0p - v00) * hy
    LD = (
        0.5 * (vnn - v00) * hx
        + 0.5 * (vpp - v00) * hx
        + 0.5 * (vpn - v00) * hy
        + 0.5 * (vnp - v00) * hy
    )
    return 0.5 * LH + 0.5 * LD


def normal(tensor, scale=(1.0, 1.0, 1.0)):
    """Surface normal normalize(-gx, -gy, 1) from the height gradient.

    The reference computes the gradient with a 5-point lerp gather
    (op/normal.hpp:29-34, silt lerp5_t); behaviorally a central difference
    with clamp-to-edge boundaries, with height scaled by scale.z and cell
    widths scale.x/y.

    Args:
      tensor: (W, H) height field.
      scale: (sx, sy, sz).
    Returns:
      (W, H, 3) unit normals.
    """
    h = jnp.asarray(tensor)
    sx, sy = float(scale[0]), float(scale[1])
    sz = float(scale[2]) if len(scale) > 2 else 1.0
    hn0 = _shift_edge(h, -1, 0)
    hp0 = _shift_edge(h, +1, 0)
    h0n = _shift_edge(h, 0, -1)
    h0p = _shift_edge(h, 0, +1)
    gx = 0.5 * (hp0 - hn0) * sz / sx
    gy = 0.5 * (h0p - h0n) * sz / sy
    n = jnp.stack([-gx, -gy, jnp.ones_like(gx)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)
