"""Steady-state transport solvers (reference: model/path/path.cu).

The reference estimates steady states of linear conservation laws with a
grid-free Monte-Carlo particle method: particles start uniformly, carry a
sampled source rate, drift along a velocity field with a DDA step rule, and
atomicAdd their attenuated source into every cell they enter
(path.cu:52-139); a normalize pass converts the flux integral to a cell
value (path.cu:141-170).

Re-design — two interchangeable methods:

* method="field" (default): the *expected value* of the MC estimator is the
  fixed point of a linear upwind transport operator. Per cell, the unit
  flow direction splits outflow between the two downwind neighbors in ratio
  |v̂x| : |v̂y|; one cell-crossing attenuates by exp(-Δλ·decay) with the same
  mean-DDA step rule the particles use. Iterating

      G <- PUSH( att * (A*source + G) )

  for `iterations` rounds (default: the reference's W+H Manhattan bound,
  path.cu:200) converges to the same normalized field, deterministically,
  as one fused radius-1 stencil per round (dense elementwise work, no
  atomics, no gathers).

* method="particles": a faithful vectorized port of the MC estimator —
  threefry keys replace curand (deterministic in (seed, offset)), vmapped
  trajectories, and scatter-adds replace atomics. Use for distributional
  parity studies against the reference.

Both return the normalized field (A*source + flux) / norm with
norm = |vx|*sy + |vy|*sx evaluated from the *actual* flow (path.cu:160-168).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from soillib_tpu.core.halo import NO_HALO

_SQRT2 = math.sqrt(2.0)


def stepsize(pos, d):
    """Mean DDA cell-crossing distance in grid space (path.cu:27-49).

    pos: (..., 2) float grid positions; d: (..., 2) unit directions.
    """
    px, py = pos[..., 0], pos[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    x_neg = jnp.floor(px)
    y_neg = jnp.floor(py)

    # CUDA fmaxf/fminf return the non-NaN operand when one side is NaN
    # (0/0 arises when a coordinate sits exactly on a lattice line with a
    # zero direction component); jnp.maximum would propagate the NaN and
    # silently kill the particle.
    def fmax(a, b):
        return jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a,
                                                    jnp.maximum(a, b)))

    def fmin(a, b):
        return jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a,
                                                    jnp.minimum(a, b)))

    tx = fmin(fmax((x_neg - px) / dx, (x_neg + 1.0 - px) / dx), _SQRT2)
    ty = fmin(fmax((y_neg - py) / dy, (y_neg + 1.0 - py) / dy), _SQRT2)
    return 0.5 * (tx + ty)


def stepsize_center(vx, vy):
    """`stepsize` evaluated at cell centers (pos frac = 0.5): the per-cell
    mean crossing distance used by the field method, from unit-direction
    components.

    The small-component branch is double-where'd: min(0.5/a, sqrt2) equals
    sqrt2 exactly for a <= 0.5/sqrt2, and masking the division there keeps
    reverse-mode free of 1/a^2 overflow (f32)."""
    def axis(a):
        capped = a <= 0.5 / _SQRT2
        return jnp.where(capped, _SQRT2, 0.5 / jnp.where(capped, 1.0, a))

    return 0.5 * (axis(jnp.abs(vx)) + axis(jnp.abs(vy)))


def stepsize_expected(vx, vy):
    """E_u[`stepsize`] over a uniform within-cell position — the exact mean
    first-crossing distance of a uniformly-born particle.

    Per axis with |d| = a, the crossing distance is T = min(U/a, sqrt2)
    with U ~ Uniform(0,1):  E[T] = 1/(2a) for a >= 1/sqrt2, else sqrt2 - a
    (the sqrt2 cap binds with probability 1 - sqrt2*a). `stepsize_center`
    (T at U = 1/2) overestimates E[T] by up to 8% for mid-range a, which
    measurably over-attenuates first-hop deposits in the cohort sweep
    (benchmarks/parity.py). Division masked for reverse-mode safety."""
    inv_s2 = 1.0 / _SQRT2

    def axis(a):
        big = a >= inv_s2
        return jnp.where(big, 0.5 / jnp.where(big, a, 1.0), _SQRT2 - a)

    return 0.5 * (axis(jnp.abs(vx)) + axis(jnp.abs(vy)))


def stepsize_var(vx, vy):
    """Var_u[`stepsize`] over a uniform within-cell position.

    The crossing distance is RANDOM in the particle reference (uniform
    birth position, path.cu:27-49): T = min(U/a, sqrt2) per axis with
    U ~ Uniform(0,1), step = (Tx + Ty)/2, Tx ⊥ Ty. A cohort closure
    that advances velocity with only the EXPECTED step drops the
    variance the random step injects into the velocity ensemble each
    transit (Var[v'] += w1² a² Var[dL]) and over-concentrates discharge
    on rough terrain (field/MC std ratio 1.54 before this term —
    benchmarks/parity.py). E[T²] − E[T]² simplifies EXACTLY (both
    branches) to the cancellation-free
      Var[T] = (2√2/3)·a − a²   for a < 1/√2,
      Var[T] = 1/(12 a²)        for a ≥ 1/√2,
      Var[step] = (Var[Tx] + Var[Ty])/4,
    needing no subnormal guard (the subtractive form hit 0/0 = NaN at
    a ~ 1e-19 under flush-to-zero and lost ~3% to f32 cancellation near
    its small-a seam). Division masked for reverse-mode safety."""
    def axis_var(a):
        big = a >= 1.0 / _SQRT2
        a_s = jnp.where(big, a, 1.0)
        return jnp.where(
            big, 1.0 / (12.0 * a_s * a_s), 0.9428090415820634 * a - a * a
        )

    return 0.25 * (axis_var(jnp.abs(vx)) + axis_var(jnp.abs(vy)))


def expected_exp_step(vx, vy, coef):
    """E_u[exp(coef * `stepsize`)] over a uniform within-cell position —
    the exact expected per-transit attenuation factor of a uniformly-born
    particle whose decay exponent is linear in the crossing distance.

    step = (Tx + Ty)/2 with independent per-axis crossings
    T = min(U/a, sqrt2), U ~ Uniform(0,1), so the factor splits into two
    closed-form axis MGFs evaluated at beta = coef/2:

      E[exp(beta T)] = (a/beta) expm1(beta u*/a) + max(0, 1-sqrt2 a) e^{sqrt2 beta}

    with u* = min(1, sqrt2 a). exp(coef * E[step]) understates the heavy
    particle tail (Jensen) — at debris-default rates that is a several-%
    first-hop deposit bias (benchmarks/parity.py).

    Exponents are clipped to +-40, not merely the f32-safe +-88: each
    axis factor is bounded by ~2 e^clip, so the PRODUCT of the two axis
    MGFs must stay under f32 max (clip 80 gives e^160 = inf; 40 gives
    ~2e35, finite). A primal inf here is poison even though callers
    saturate carried totals at 1e30 — the saturating clip zeroes the
    cotangent, but the multiply's own vjp still evaluates ybar * inf =
    NaN in reverse mode. Growth factors beyond e^80 total are collapsed-
    cell regimes already clamped downstream, so the forward change is
    confined to states that were saturated anyway. a -> 0 reduces to the
    pure sqrt2 cap."""
    def expm1_k(x):
        """expm1 as an explicit decomposition (the goldens are pinned to
        it): cubic Taylor under |x| < 0.01 (rel error
        < 2e-8 there — exp(x)-1 alone loses ~1e-7/|x| relative), plain
        exp(x)-1 elsewhere (rel error <= 1.2e-5 at the branch point)."""
        small = jnp.abs(x) < 0.01
        series = x * (1.0 + x * (0.5 + x * (1.0 / 6.0)))
        return jnp.where(small, series, jnp.exp(x) - 1.0)

    def axis_mgf(a, beta):
        tiny_a = a < 1e-20
        a_s = jnp.where(tiny_a, 1.0, a)
        u_star = jnp.minimum(1.0, _SQRT2 * a)
        arg = jnp.clip(beta * u_star / a_s, -40.0, 40.0)
        small_b = jnp.abs(beta) < 1e-12
        beta_s = jnp.where(small_b, 1.0, beta)
        integral = jnp.where(
            small_b, u_star, (a_s / beta_s) * expm1_k(arg)
        )
        tail = jnp.maximum(0.0, 1.0 - _SQRT2 * a) * jnp.exp(
            jnp.clip(_SQRT2 * beta, -40.0, 40.0)
        )
        full = integral + tail
        return jnp.where(
            tiny_a, jnp.exp(jnp.clip(_SQRT2 * beta, -40.0, 40.0)), full
        )

    beta = 0.5 * coef
    return axis_mgf(jnp.abs(vx), beta) * axis_mgf(jnp.abs(vy), beta)


def bilinear_gather(field, pos):
    """Bilinear sample of a (W, H[, C]) field at (..., 2) grid positions.

    Mirrors sample_t<.,2,1>::gather (sample.hpp:155-186): integer-floor cell
    corners, NaN when pos is out of [0, W-1] x [0, H-1], weight zeroed at the
    far edge.
    """
    W, H = field.shape[0], field.shape[1]
    x, y = pos[..., 0], pos[..., 1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    wx = x - x0
    wy = y - y0

    # Far-edge clamp (sample.hpp:173-174): drop the +1 sample and weight.
    wx = jnp.where(x + 1.0 > W - 1.0, 0.0, wx)
    wy = jnp.where(y + 1.0 > H - 1.0, 0.0, wy)

    x0c = jnp.clip(x0, 0, W - 1)
    y0c = jnp.clip(y0, 0, H - 1)
    x1c = jnp.clip(x0 + 1, 0, W - 1)
    y1c = jnp.clip(y0 + 1, 0, H - 1)

    if field.ndim == 3:
        wxe, wye = wx[..., None], wy[..., None]
    else:
        wxe, wye = wx, wy

    v = (
        field[x0c, y0c] * (1 - wxe) * (1 - wye)
        + field[x0c, y1c] * (1 - wxe) * wye
        + field[x1c, y0c] * wxe * (1 - wye)
        + field[x1c, y1c] * wxe * wye
    )
    oob = (x < 0) | (y < 0) | (x > W - 1.0) | (y > H - 1.0)
    if field.ndim == 3:
        oob = oob[..., None]
    return jnp.where(oob, jnp.nan, v)


def linear_gather(field, pos):
    """1-D linear sample of a (N[, C]) field at (...,) positions —
    returns (value, gradient) with gradient in cell units.

    Mirrors sample_t<., 1, 1> (sample.hpp:32-66: val = lerp(v0, v1; t),
    grad = v1 - v0), with the 2-D gather's boundary conventions
    (sample.hpp:155-186) applied along the one axis: NaN outside
    [0, N-1], far-edge sample/weight dropped."""
    N = field.shape[0]
    x = pos
    x0 = jnp.floor(x).astype(jnp.int32)
    t = x - x0
    t = jnp.where(x + 1.0 > N - 1.0, 0.0, t)
    x0c = jnp.clip(x0, 0, N - 1)
    x1c = jnp.clip(x0 + 1, 0, N - 1)
    v0 = field[x0c]
    v1 = field[x1c]
    if field.ndim == 2:
        t = t[..., None]
    val = v0 + t * (v1 - v0)
    grad = v1 - v0
    oob = (x < 0) | (x > N - 1.0)
    if field.ndim == 2:
        oob = oob[..., None]
    return jnp.where(oob, jnp.nan, val), jnp.where(oob, jnp.nan, grad)


def bilinear_gather_grad(field, pos):
    """Bilinear sample WITH its first-order gradient at (..., 2) grid
    positions -> (value, (..., 2) gradient), gradient in cell units.

    Mirrors sample_t<., 2, 1>::grad (sample.hpp:96-101): grad.x is the
    difference of the two y-lerped x-slices, grad.y the x-lerp of the
    per-slice y-differences; boundary conventions as `bilinear_gather`.
    (The reference uses this internally for its CPU normal op; exposed
    here for parity and for user-side DEM sampling.)"""
    W, H = field.shape[0], field.shape[1]
    x, y = pos[..., 0], pos[..., 1]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    wx = x - x0
    wy = y - y0
    wx = jnp.where(x + 1.0 > W - 1.0, 0.0, wx)
    wy = jnp.where(y + 1.0 > H - 1.0, 0.0, wy)
    x0c = jnp.clip(x0, 0, W - 1)
    y0c = jnp.clip(y0, 0, H - 1)
    x1c = jnp.clip(x0 + 1, 0, W - 1)
    y1c = jnp.clip(y0 + 1, 0, H - 1)
    h00, h01 = field[x0c, y0c], field[x0c, y1c]
    h10, h11 = field[x1c, y0c], field[x1c, y1c]
    l0 = h00 + wy * (h01 - h00)
    l1 = h10 + wy * (h11 - h10)
    val = l0 + wx * (l1 - l0)
    gx = l1 - l0
    gy = (h01 - h00) + wx * ((h11 - h10) - (h01 - h00))
    oob = (x < 0) | (y < 0) | (x > W - 1.0) | (y > H - 1.0)
    nan = jnp.where(oob, jnp.nan, 0.0)
    return val + nan, jnp.stack([gx + nan, gy + nan], axis=-1)


def upwind_push(payload, dirs):
    """One round of the upwind transport operator.

    payload: (W, H[, C]) quantity leaving each cell this round.
    dirs:    (W, H, 2) unit flow directions.
    Returns the quantity arriving at each cell: contributions from the four
    neighbors whose outflow points at it, split |v̂x| : |v̂y|. Outflow across
    the domain boundary is lost (particles exit, path.cu:104).
    """
    vx = dirs[..., 0]
    vy = dirs[..., 1]
    denom = jnp.abs(vx) + jnp.abs(vy)
    denom = jnp.where(denom == 0.0, 1.0, denom)
    wx = jnp.abs(vx) / denom
    wy = jnp.abs(vy) / denom
    if payload.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]
        vxm = vx[..., None]
        vym = vy[..., None]
    else:
        vxm, vym = vx, vy

    out_xp = jnp.where(vxm > 0, payload * wx, 0.0)  # leaves toward +x
    out_xn = jnp.where(vxm < 0, payload * wx, 0.0)  # leaves toward -x
    out_yp = jnp.where(vym > 0, payload * wy, 0.0)
    out_yn = jnp.where(vym < 0, payload * wy, 0.0)

    def shift_from(a, dx, dy):
        # arriving[x, y] = a[x - dx, y - dy] with zero inflow at the boundary
        pad = [(max(0, dx), max(0, -dx)), (max(0, dy), max(0, -dy))]
        pad += [(0, 0)] * (a.ndim - 2)
        ap = jnp.pad(a, pad)
        Wd, Hd = a.shape[0], a.shape[1]
        x0 = max(0, -dx)
        y0 = max(0, -dy)
        return ap[x0 : x0 + Wd, y0 : y0 + Hd, ...]

    return (
        shift_from(out_xp, +1, 0)
        + shift_from(out_xn, -1, 0)
        + shift_from(out_yp, 0, +1)
        + shift_from(out_yn, 0, -1)
    )


def _solve_field(flow, source, decay, scale, iterations, halo=NO_HALO):
    """Deterministic fixed-point evaluation of the expected MC flux."""
    W, H = flow.shape[0], flow.shape[1]
    A = float(scale[0]) * float(scale[1])
    L = math.sqrt(float(scale[0]) ** 2 + float(scale[1]) ** 2)

    v_len = jnp.linalg.norm(flow, axis=-1)
    alive = v_len > 0.0
    safe = jnp.where(alive, v_len, 1.0)
    vx = flow[..., 0] / safe
    vy = flow[..., 1] / safe
    step = stepsize_center(vx, vy)
    dlam = step * L / safe
    att = jnp.where(alive, jnp.exp(jnp.where(alive, -dlam * decay, 0.0)), 0.0)

    emit = A * source  # expected per-cell source emission [X*m^D/s]

    # Channel-first solve (ops/sweep.py; K-blocked ppermute when sharded).
    E = jnp.moveaxis(emit, -1, 0) if source.ndim == 3 else emit[None]
    attc = jnp.broadcast_to(att[None], E.shape)
    G = halo.run_transport(E, attc, vx, vy, iterations)
    return jnp.moveaxis(G, 0, -1) if source.ndim == 3 else G[0]


def _solve_particles(flow, source, decay, scale, count, key, maxstep):
    """Faithful vectorized MC estimator (path.cu:52-139)."""
    W, H = flow.shape[0], flow.shape[1]
    K = source.shape[2] if source.ndim == 3 else 1
    src = source.reshape(W * H, K)
    dec = decay.reshape(W * H)
    A = float(scale[0]) * float(scale[1])
    L = math.sqrt(float(scale[0]) ** 2 + float(scale[1]) ** 2)
    P = 1.0 / (A * W * H)
    eps = 1e-16

    N = count
    kx, ky = jax.random.split(key)
    pos = jnp.stack(
        [
            jax.random.uniform(kx, (N,), jnp.float32) * W,
            jax.random.uniform(ky, (N,), jnp.float32) * H,
        ],
        axis=-1,
    )
    ind = (pos[:, 0].astype(jnp.int32) * H + pos[:, 1].astype(jnp.int32))
    S = src[ind] / P  # (N, K)
    alive0 = jnp.linalg.norm(S, axis=-1) >= eps

    flux0 = jnp.zeros((W * H, K), dtype=jnp.float32)

    def body(_, carry):
        flux, pos, ind, att, alive = carry
        x, y = pos[:, 0], pos[:, 1]
        inb = (x >= 0) & (y >= 0) & (x < W) & (y < H)
        alive = alive & inb & (eps < jnp.abs(att))

        pos_c = jnp.clip(pos, 0.0, jnp.array([W - 1e-3, H - 1e-3]))
        nind = pos_c[:, 0].astype(jnp.int32) * H + pos_c[:, 1].astype(jnp.int32)
        entered = alive & (nind != ind)
        ind = jnp.where(entered, nind, ind)
        dep = jnp.where(entered[:, None], S * att[:, None], 0.0)
        flux = flux.at[ind].add(dep)

        v = bilinear_gather(flow, pos)  # (N, 2), NaN fully OOB
        v = jnp.where(jnp.isnan(v), 0.0, v)
        v_len = jnp.linalg.norm(v, axis=-1)
        alive = alive & (v_len >= eps)

        v_norm = v / jnp.maximum(v_len, 1e-30)[:, None]
        stp = stepsize(pos, v_norm)
        new_pos = pos + stp[:, None] * v_norm
        dlam = stp * L / jnp.maximum(v_len, 1e-30)
        new_att = att * jnp.exp(-dlam * dec[ind])

        pos = jnp.where(alive[:, None], new_pos, pos)
        att = jnp.where(alive, new_att, att)
        return flux, pos, ind, att, alive

    # `++step < maxstep` -> maxstep - 1 iterations (path.cu:104).
    flux, *_ = jax.lax.fori_loop(
        0, max(maxstep - 1, 0), body,
        (flux0, pos, ind, jnp.ones((N,), jnp.float32), alive0),
    )
    G = flux.reshape(W, H, K) / float(count)
    return G if source.ndim == 3 else G[..., 0]


def solve_uniform(
    flow,
    source,
    decay,
    scale=(1.0, 1.0),
    count: int = None,
    *,
    method: str = "field",
    iterations: int = None,
    seed: int = 0,
    offset: int = 0,
    key=None,
    halo=NO_HALO,
):
    """Steady-state solve of a linear conservation law along a flow field.

    Args:
      flow: (W, H, 2) velocity field [m/s].
      source: (W, H) or (W, H, K<=2) source rate [X/s].
      decay: (W, H) decay rate [1/s].
      scale: (sx, sy) cell widths [m].
      count: particle count (method="particles"); defaults to W*H.
      method: "field" (deterministic upwind fixed point) or "particles".
      iterations: field-method rounds; default W+H (the reference's
        Manhattan step bound, path.cu:200).
      seed, offset / key: RNG stream for the particle method (replaces
        silt.seed(rng, seed, offset)).

    Returns:
      Normalized transported field, same shape as `source`.
      Ref: path.cu:180-219.
    """
    flow = jnp.asarray(flow, jnp.float32)
    source = jnp.asarray(source, jnp.float32)
    decay = jnp.asarray(decay, jnp.float32)
    from soillib_tpu.core.grid import check_channel_last

    check_channel_last("flow", flow, channels=(2,))
    if source.ndim == 3 and source.shape[2] > 2:
        raise ValueError(
            f"source must be (W, H) or channel-LAST (W, H, K<=2); got "
            f"shape {tuple(source.shape)} (path.cu:192-214 dispatches on "
            f"the trailing channel dim)."
        )
    W, H = flow.shape[0], flow.shape[1]
    A = float(scale[0]) * float(scale[1])

    if method == "field":
        it = int(iterations) if iterations is not None else (W + H)
        G = _solve_field(flow, source, decay, scale, it, halo)
    elif method == "particles":
        if halo is not NO_HALO:
            raise NotImplementedError(
                "particle transport is single-device; use method='field' under shard_map"
            )
        if key is None:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), offset)
        n = int(count) if count is not None else W * H
        G = _solve_particles(flow, source, decay, scale, n, key, maxstep=W + H)
    else:
        raise ValueError(f"unknown method: {method!r}")

    norm = jnp.abs(flow[..., 0]) * float(scale[1]) + jnp.abs(flow[..., 1]) * float(
        scale[0]
    )
    norm = jnp.where(norm == 0.0, jnp.inf, norm)  # zero-flow cells -> 0/inf = 0
    if source.ndim == 3:
        norm = norm[..., None]
    return (source * A + G) / norm
