"""Filter operators (reference: model/filter/filter.cu).

`gaussian_blur` reproduces the reference's separable 2-pass blur with a fixed
±16-tap window, clamp-to-edge sampling, and the *truncated-but-unrenormalized*
kernel (each tap weighted exp(-k²/2σ²)/(√(2π)σ), filter.cu:47-48 — for large
σ the truncation loses mass; this is reproduced, not fixed).

Unlike the reference — which writes the second pass back into its input and
returns it (filter.cu:82-90) — this is a pure function returning a new array;
in JAX, donation/aliasing under jit recovers the in-place memory behavior.

Implementation: each pass is a 33-tap 1-D correlation. We express it as a
sum of 33 statically-shifted reads so XLA fuses it into one pass per
axis; with clamp-to-edge handled by index clamping.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

_KWINDOW = 16  # fixed window half-width (filter.cu:34)


def _blur_axis(v, sigma: float, axis: int):
    Z = math.sqrt(2.0 * math.pi) * sigma
    n = v.shape[axis]
    idx = jnp.arange(n)
    out = jnp.zeros_like(v)
    for k in range(-_KWINDOW, _KWINDOW + 1):
        w = math.exp(-0.5 * (k / sigma) * (k / sigma)) / Z
        ki = jnp.clip(idx + k, 0, n - 1)
        out = out + w * jnp.take(v, ki, axis=axis)
    return out


def gaussian_blur(tensor, sigma: float):
    """Separable Gaussian blur, x-pass then y-pass. (W, H) or (W, H, C)."""
    v = jnp.asarray(tensor)
    v = _blur_axis(v, float(sigma), axis=0)
    v = _blur_axis(v, float(sigma), axis=1)
    return v
