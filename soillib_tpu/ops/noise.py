"""Procedural fractal noise (reference: op/noise.hpp + vendored FastNoiseLite).

The reference samples FastNoiseLite OpenSimplex2 FBm on the CPU, one cell at
a time, at coordinates (x/ext.x, y/ext.y, seed) — the seed rides in as the
*third* noise coordinate (op/noise.hpp:37-39). Parameter defaults match
noise_param_t: frequency=1, octaves=8, gain=0.6, lacunarity=2, ext=(512,512)
(op/noise.hpp:29-34).

Two evaluation modes, both whole-grid vectorized jnp programs (no per-cell
loop):

* `compat=True` (default): an exact re-implementation of the FastNoiseLite
  3-D OpenSimplex2 FBm pipeline the reference runs — int32 prime-hash
  lattice, the two offset rotated cube grids, the DefaultOpenSimplex2
  rotation transform, FBm with per-octave seed increment and fractal
  bounding — matching the vendored library to float32 roundoff, so the
  reference example terrains (e.g. erosion_gpu.py's seed-3 DEM) are
  reproduced field-for-field (tests/test_noise.py pins goldens dumped from
  the vendored FastNoiseLite itself).
* `compat=False`: a leaner simplex-lattice FBm with a counter-based hash —
  same parameter semantics, not bit-compatible; kept for speed when parity
  does not matter.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

_F3 = 1.0 / 3.0  # 3-D simplex skew factor
_G3 = 1.0 / 6.0  # 3-D simplex unskew factor

# 12 gradient directions: edge midpoints of a cube.
_GRAD3 = np.array(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    ],
    dtype=np.float32,
)


def _hash3(i, j, k, seed):
    """Counter-based lattice hash -> uint32. Murmur-style avalanche mix."""
    h = (
        i.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
        + j.astype(jnp.uint32) * jnp.uint32(0xD8163841)
        + k.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F)
        + jnp.uint32(seed) * jnp.uint32(0x9E3779B9)
    )
    h ^= h >> 15
    h *= jnp.uint32(0x85EBCA6B)
    h ^= h >> 13
    h *= jnp.uint32(0xC2B2AE35)
    h ^= h >> 16
    return h


def _grad_dot(i, j, k, seed, dx, dy, dz):
    """dot(gradient(lattice point), displacement)."""
    g = _hash3(i, j, k, seed) % jnp.uint32(12)
    gv = jnp.asarray(_GRAD3)[g]
    return gv[..., 0] * dx + gv[..., 1] * dy + gv[..., 2] * dz


def simplex3(x, y, z, seed: int = 0):
    """Vectorized 3-D simplex noise in [-1, 1] (approx)."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    z = jnp.asarray(z, jnp.float32)

    s = (x + y + z) * _F3
    i = jnp.floor(x + s).astype(jnp.int32)
    j = jnp.floor(y + s).astype(jnp.int32)
    k = jnp.floor(z + s).astype(jnp.int32)
    t = (i + j + k).astype(jnp.float32) * _G3
    x0 = x - (i.astype(jnp.float32) - t)
    y0 = y - (j.astype(jnp.float32) - t)
    z0 = z - (k.astype(jnp.float32) - t)

    # Rank the components to find the simplex traversal order.
    gx = (x0 >= y0).astype(jnp.int32) + (x0 >= z0).astype(jnp.int32)
    gy = (y0 > x0).astype(jnp.int32) + (y0 >= z0).astype(jnp.int32)
    gz = (z0 > x0).astype(jnp.int32) + (z0 > y0).astype(jnp.int32)
    i1 = (gx >= 2).astype(jnp.int32)
    j1 = (gy >= 2).astype(jnp.int32)
    k1 = (gz >= 2).astype(jnp.int32)
    i2 = (gx >= 1).astype(jnp.int32)
    j2 = (gy >= 1).astype(jnp.int32)
    k2 = (gz >= 1).astype(jnp.int32)

    x1 = x0 - i1 + _G3
    y1 = y0 - j1 + _G3
    z1 = z0 - k1 + _G3
    x2 = x0 - i2 + 2.0 * _G3
    y2 = y0 - j2 + 2.0 * _G3
    z2 = z0 - k2 + 2.0 * _G3
    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3

    def corner(dx, dy, dz, ci, cj, ck):
        tt = 0.6 - dx * dx - dy * dy - dz * dz
        tt = jnp.maximum(tt, 0.0)
        return (tt * tt) * (tt * tt) * _grad_dot(ci, cj, ck, seed, dx, dy, dz)

    n = (
        corner(x0, y0, z0, i, j, k)
        + corner(x1, y1, z1, i + i1, j + j1, k + k1)
        + corner(x2, y2, z2, i + i2, j + j2, k + k2)
        + corner(x3, y3, z3, i + 1, j + 1, k + 1)
    )
    return 32.0 * n


# ---------------------------------------------------------------------------
# FastNoiseLite-compatible OpenSimplex2 (compat=True)
# ---------------------------------------------------------------------------

# Lattice hashing primes and the avalanche multiplier (FastNoiseLite.h:487-505).
_PRIME_X = np.int32(501125321)
_PRIME_Y = np.int32(1136930381)
_PRIME_Z = np.int32(1720413743)
_HASH_MUL = np.int32(0x27D4EB2D)

# 64-entry 3-D gradient table (FastNoiseLite.h Gradients3D): five repeats of
# the 12 cube-edge-midpoint directions, then a 4-entry tail (aliases of
# rows 8, 1, 9, 3). Kept for the oracle test; the hot path decodes the
# components arithmetically (see _os2_grad).
_OS2_GRADS = np.array(
    [[0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
     [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
     [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0]] * 5
    + [[1, 1, 0], [0, -1, 1], [-1, 1, 0], [0, -1, -1]],
    dtype=np.float32,
)


def _os2_grad(seed, i, j, k, xd, yd, zd):
    """GradCoord (FastNoiseLite.h:537-550): prime-XOR hash, avalanche
    multiply, arithmetic >>15 fold, 64-way gradient dot product. All int
    arithmetic is wrapping int32 (XLA semantics match C here).

    The table lookup is decoded arithmetically instead of gathered, so
    no (N, 3) gather temporaries exist: every component is in {-1, 0, +1}
    with a regular structure — row m of the 12 base directions zeroes
    axis m>>2 and signs the other two by bits m&1 / m&2
    (tests/test_noise.py pins the decode against the table)."""
    h = (seed ^ i ^ j ^ k) * _HASH_MUL
    h = h ^ (h >> 15)
    gi = (h >> 2) & 63
    t = gi - 60
    m_tail = jnp.where(
        t == 0, 8, jnp.where(t == 1, 1, jnp.where(t == 2, 9, 3))
    )
    m = jnp.where(gi < 60, gi % 12, m_tail)
    g2 = m >> 2  # which axis is zero: 0 -> x, 1 -> y, 2 -> z
    s0 = (1 - ((m & 1) << 1)).astype(jnp.float32)
    s1 = (1 - (m & 2)).astype(jnp.float32)
    zero = jnp.zeros_like(xd)
    gx = jnp.where(g2 == 0, zero, s0)
    gy = jnp.where(g2 == 0, s0, jnp.where(g2 == 2, s1, zero))
    gz = jnp.where(g2 == 2, zero, s1)
    return gx * xd + gy * yd + gz * zd


def _fast_round(f):
    """C-truncation round-half-away-from-zero ((int)(f±0.5f))."""
    return jnp.where(
        f >= 0.0, (f + 0.5).astype(jnp.int32), (f - 0.5).astype(jnp.int32)
    )


def opensimplex2(x, y, z, seed: int):
    """FastNoiseLite `SingleOpenSimplex2` 3-D noise, vectorized.

    Exact port of the two-offset-rotated-cube-grids sampler
    (FastNoiseLite.h:1054-1150): the per-cell `for (l = 0;;)` loop runs
    exactly twice, so it is unrolled with the branchy axis selection
    turned into `where` masks. Inputs must already be rotation-transformed
    (see `_os2_transform`). float32 throughout to match the C float path.
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    z = jnp.asarray(z, jnp.float32)
    seed = jnp.int32(seed)

    i = _fast_round(x)
    j = _fast_round(y)
    k = _fast_round(z)
    x0 = x - i.astype(jnp.float32)
    y0 = y - j.astype(jnp.float32)
    z0 = z - k.astype(jnp.float32)

    # xNSign = (int)(-1.0f - x0) | 1  ->  -1 where x0 >= 0 else +1.
    xns = jnp.where(x0 >= 0.0, jnp.int32(-1), jnp.int32(1))
    yns = jnp.where(y0 >= 0.0, jnp.int32(-1), jnp.int32(1))
    zns = jnp.where(z0 >= 0.0, jnp.int32(-1), jnp.int32(1))
    ax0 = xns.astype(jnp.float32) * -x0
    ay0 = yns.astype(jnp.float32) * -y0
    az0 = zns.astype(jnp.float32) * -z0

    i = i * _PRIME_X
    j = j * _PRIME_Y
    k = k * _PRIME_Z

    value = jnp.zeros_like(x0)
    a = (0.6 - x0 * x0) - (y0 * y0 + z0 * z0)

    for l in range(2):
        value = value + jnp.where(
            a > 0.0,
            (a * a) * (a * a) * _os2_grad(seed, i, j, k, x0, y0, z0),
            0.0,
        )

        # Second vertex: step along the largest-|displacement| axis
        # (ties resolved x-first then y, matching the if/else chain).
        pick_x = (ax0 >= ay0) & (ax0 >= az0)
        pick_y = ~pick_x & (ay0 > ax0) & (ay0 >= az0)
        pick_z = ~pick_x & ~pick_y
        xnsf = xns.astype(jnp.float32)
        ynsf = yns.astype(jnp.float32)
        znsf = zns.astype(jnp.float32)
        x1 = jnp.where(pick_x, x0 + xnsf, x0)
        y1 = jnp.where(pick_y, y0 + ynsf, y0)
        z1 = jnp.where(pick_z, z0 + znsf, z0)
        b = a + 1.0
        b = jnp.where(pick_x, b - xnsf * 2.0 * x1, b)
        b = jnp.where(pick_y, b - ynsf * 2.0 * y1, b)
        b = jnp.where(pick_z, b - znsf * 2.0 * z1, b)
        i1 = jnp.where(pick_x, i - xns * _PRIME_X, i)
        j1 = jnp.where(pick_y, j - yns * _PRIME_Y, j)
        k1 = jnp.where(pick_z, k - zns * _PRIME_Z, k)
        value = value + jnp.where(
            b > 0.0,
            (b * b) * (b * b) * _os2_grad(seed, i1, j1, k1, x1, y1, z1),
            0.0,
        )

        if l == 1:
            break

        # Hop to the second (offset) cube grid.
        ax0 = 0.5 - ax0
        ay0 = 0.5 - ay0
        az0 = 0.5 - az0
        x0 = xns.astype(jnp.float32) * ax0
        y0 = yns.astype(jnp.float32) * ay0
        z0 = zns.astype(jnp.float32) * az0
        a = a + ((0.75 - ax0) - (ay0 + az0))
        # i += (xNSign >> 1) & PrimeX: adds the prime only on the -1 side.
        i = i + ((xns >> 1) & _PRIME_X)
        j = j + ((yns >> 1) & _PRIME_Y)
        k = k + ((zns >> 1) & _PRIME_Z)
        xns = -xns
        yns = -yns
        zns = -zns
        seed = ~seed

    return value * jnp.float32(32.69428253173828125)


def _os2_transform(x, y, z, frequency):
    """TransformNoiseCoordinate, TransformType3D_DefaultOpenSimplex2
    (FastNoiseLite.h:716-724): frequency scale then the R3 rotation."""
    f = jnp.float32(frequency)
    x = jnp.asarray(x, jnp.float32) * f
    y = jnp.asarray(y, jnp.float32) * f
    z = jnp.asarray(z, jnp.float32) * f
    r = (x + y + z) * jnp.float32(2.0 / 3.0)
    return r - x, r - y, r - z


def opensimplex2_fbm(
    x, y, z, *, seed=1337, octaves=8, gain=0.6, lacunarity=2.0, frequency=1.0
):
    """FastNoiseLite `GetNoise` 3-D with FractalType_FBm + OpenSimplex2.

    Matches the vendored library to float32 roundoff: the rotation
    transform runs once on the base coordinates; each octave increments
    the int seed and multiplies the *transformed* coordinates by the
    lacunarity in float32 (FastNoiseLite.h:866-889); amplitudes are
    gain^o scaled by the fractal bounding 1/sum(gain^o).
    """
    xr, yr, zr = _os2_transform(x, y, z, frequency)
    gain = np.float32(abs(gain))
    amp_fractal = np.float32(1.0)
    amp = gain
    for _ in range(1, int(octaves)):
        amp_fractal += amp
        amp *= gain
    bounding = np.float32(1.0) / amp_fractal

    total = jnp.zeros_like(xr)
    amp = jnp.float32(bounding)
    lac = jnp.float32(lacunarity)
    s = int(seed)
    for o in range(int(octaves)):
        total = total + opensimplex2(xr, yr, zr, s + o) * amp
        xr = xr * lac
        yr = yr * lac
        zr = zr * lac
        amp = amp * jnp.float32(gain)
    return total


@dataclasses.dataclass
class noise_t:
    """Noise parameter set, field-compatible with noise_param_t
    (op/noise.hpp:14-40). `compat=True` runs the exact FastNoiseLite
    OpenSimplex2 pipeline (the reference's vendored noise source);
    `iseed` is FastNoiseLite's int lattice seed (mSeed, default 1337 —
    the reference never rebinds it; the float `seed` rides in as the
    third noise coordinate, op/noise.hpp:37-39)."""

    frequency: float = 1.0
    octaves: int = 8
    gain: float = 0.6
    lacunarity: float = 2.0
    seed: float = 0.0
    ext: tuple = (512.0, 512.0)
    compat: bool = True
    iseed: int = 1337


def noise(shape, param: noise_t = None):
    """FBm fractal noise over a (W, H) grid.

    Samples at (x/ext.x, y/ext.y, seed) like the reference's per-cell loop
    (op/noise.hpp:42-56). With `param.compat` (default) the result equals
    the reference's `soil.noise` output to float32 roundoff.

    Args:
      shape: (W, H) or a Shape.
      param: noise_t.
    Returns:
      (W, H) float32 array.
    """
    if param is None:
        param = noise_t()
    W, H = int(shape[0]), int(shape[1])
    ext = param.ext
    x = (jnp.arange(W, dtype=jnp.float32) / jnp.float32(ext[0]))[:, None]
    y = (jnp.arange(H, dtype=jnp.float32) / jnp.float32(ext[1]))[None, :]
    x = jnp.broadcast_to(x, (W, H))
    y = jnp.broadcast_to(y, (W, H))

    if param.compat:
        z = jnp.full((W, H), jnp.float32(param.seed))
        return opensimplex2_fbm(
            x, y, z,
            seed=param.iseed,
            octaves=param.octaves,
            gain=param.gain,
            lacunarity=param.lacunarity,
            frequency=param.frequency,
        )

    z = jnp.float32(param.seed)
    total = jnp.zeros((W, H), dtype=jnp.float32)
    amp = 1.0
    bounding = 0.0
    freq = float(param.frequency)
    # Octave index is folded into the hash seed so octaves decorrelate.
    for o in range(int(param.octaves)):
        total = total + amp * simplex3(x * freq, y * freq, z * freq, seed=o * 1013 + 7)
        bounding += amp
        amp *= float(param.gain)
        freq *= float(param.lacunarity)
    return total / jnp.float32(bounding)
