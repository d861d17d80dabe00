"""Unified erosion model — XLA-compiled field solvers.

Re-design of the reference's coupled hydraulic + debris-flow erosion model
(model/path/erosion.cu, 921 LoC CUDA). The terrain is a two-layer state
`layers` = (bedrock, sediment) heights, stored dimensionless and
dimensionalized by scale.z (erosion.hpp:60; erosion.cu:441-451).

Layout: every multichannel field is channel-FIRST — layers (2, W, H),
momentum (2, W, H), albedo (3, W, H), gradients (2, W, H) — so the minor
(contiguous) dimension is always spatial and per-channel slices are
contiguous planes.

Per step (see SURVEY.md §3.1):
  1. `transport_fluvial`  — steady-state water/sediment-mass/momentum fields
  2. `transport_debris`   — steady-state debris-flow mass/momentum fields
  3. `mass_transfer`      — Eulerian height-field delta (suspend/deposit/
                             uplift, stability-clamped, two-layer bookkeeping)
  4. `mass_creep`         — thermal creep (rate-limited symmetric transfer)
  5. apply delta; `layer_merge` for export

The transport phase keeps the reference's *model* (per-cell sources,
exponential attenuation, flux deposition along the flow) but replaces the
Monte-Carlo particle ensemble with the deterministic upwind fixed-point
iteration of ops.transport (method="field", the default); a
faithful particle method (threefry, scatter-add) is available with
method="particles" for distributional parity with the reference.

Numerical quirks of the reference reproduced on purpose (do not "fix"):
  * empirical rescalings ks/64, kd*1.33, fD/8 (erosion.cu:68-70, 478-480)
  * the normalize kernels' fixed v=(1,0) -> norm = scale.y
    (erosion.cu:165-166, 372-373)
  * the ±0.25*L transfer clamps (erosion.cu:527-528)
  * sediment-before-bedrock erosion order, uplift to bedrock only
    (erosion.cu:530-547)
  * creep symmetry => exact mass conservation (erosion.cu:633-710)
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from soillib_tpu.core.halo import NO_HALO
from soillib_tpu.models.params import ErosionParams
from soillib_tpu.ops.stencil import _shift
from soillib_tpu.ops.transport import (
    bilinear_gather,
    expected_exp_step,
    stepsize,
    stepsize_center,
    upwind_push,
)

_EPS = 1e-12


def _birth_density(W, H, halo=NO_HALO):
    """Relative particle-birth density of the reference MC sampler.

    erosion.cu births particles at pos = 0.5 + u * (shape - 1) — uniform
    over the INSET (W-1)x(H-1) area, not over all cells as the stated
    sample probability P = 1/(A*elem) assumes (erosion.cu:53-58). Interior
    cells therefore receive W*H/((W-1)*(H-1)) times the nominal density
    and edge cells half of that (corners a quarter). The field method
    scales its emissions by this factor to reproduce the reference
    estimator exactly (a deliberate quirk reproduction; ~4% interior at
    48², vanishing as the grid grows)."""
    x0, y0, Wg, Hg = halo.global_offsets((W, H))
    gx = x0 + jnp.arange(W)
    gy = y0 + jnp.arange(H)
    fx = jnp.where((gx == 0) | (gx == Wg - 1), 0.5, 1.0) * (Wg / max(Wg - 1.0, 1.0))
    fy = jnp.where((gy == 0) | (gy == Hg - 1), 0.5, 1.0) * (Hg / max(Hg - 1.0, 1.0))
    return fx[:, None] * fy[None, :]


def merged_height(layers):
    """height = bedrock + sediment (dimensionless); layers is (2, W, H)."""
    return layers[0] + layers[1]


def layer_merge(layers):
    """Ref: erosion.cu:733-757."""
    return merged_height(layers)


def godunov_gradient(height, scale, exit_slope, halo=NO_HALO):
    """Godunov-style steepest one-sided gradient with exit-slope BC.

    Per axis: the backward slope (h - h_neg)*sz/sx is clamped uphill-to-zero
    (only kept if the neighbor is lower); the forward slope (h_pos - h)*sz/sx
    is clamped downhill-to-zero; out-of-bounds neighbors contribute the
    signed exit slope; the steeper magnitude wins (backward on ties).
    Ref: __glocal, erosion_map.cu:107-159.

    Args:
      height: (W, H) merged dimensionless height.
      scale: (sx, sy, sz).
      exit_slope: boundary slope [m/m].
    Returns:
      (2, W, H) channel-first gradient.
    """
    h = halo.pad(jnp.asarray(height), jnp.nan)
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    nan = jnp.float32(jnp.nan)
    hn0 = _shift(h, -1, 0, nan)
    hp0 = _shift(h, +1, 0, nan)
    h0n = _shift(h, 0, -1, nan)
    h0p = _shift(h, 0, +1, nan)

    def one_axis(hn, hp, s):
        # Double-where: substitute the missing neighbor BEFORE the
        # arithmetic so reverse-mode cotangents never touch a NaN branch
        # (where(p, c, f(NaN)) back-propagates 0 * NaN = NaN otherwise).
        miss_n = jnp.isnan(hn)
        miss_p = jnp.isnan(hp)
        gn = (h - jnp.where(miss_n, h, hn)) * sz / s
        gn = jnp.where(miss_n, exit_slope, jnp.maximum(gn, 0.0))
        gp = (jnp.where(miss_p, h, hp) - h) * sz / s
        gp = jnp.where(miss_p, -exit_slope, jnp.minimum(gp, 0.0))
        return jnp.where(jnp.abs(gp) > jnp.abs(gn), gp, gn)

    gx = one_axis(hn0, hp0, sx)
    gy = one_axis(h0n, h0p, sy)
    return jnp.stack([halo.crop(gx), halo.crop(gy)], axis=0)


def _len2(x, y):
    """2-norm of component fields with a NaN-free gradient at 0 (d sqrt(0)
    is inf; the double-where keeps the primal exact, cotangent finite)."""
    sq = x * x + y * y
    zero = sq == 0.0
    return jnp.where(zero, 0.0, jnp.sqrt(jnp.where(zero, 1.0, sq)))


def _length(v):
    """_len2 over a trailing component axis (particle-path layout)."""
    return _len2(v[..., 0], v[..., 1])


def _safe_pow(x, alpha):
    """x**alpha for x >= 0 with a finite gradient at x == 0 (the reference
    configs use alpha < 1, where d x^alpha at 0 is inf)."""
    zero = x == 0.0
    return jnp.where(zero, 0.0, jnp.power(jnp.where(zero, 1.0, x), alpha))


def _masked_exp(alive, arg):
    """where(alive, exp(arg), 0) with the argument itself masked, so huge
    dead-cell exponents cannot leak NaN/inf into reverse mode."""
    return jnp.where(alive, jnp.exp(jnp.where(alive, arg, 0.0)), 0.0)


# Exp-rate coefficients fed to `expected_exp_step` are clipped to this
# magnitude on the PRIMAL: collapsed-speed cells reach ~1e31 (inv^2 terms
# at the 1e-12 speed floor), and although the MGF saturates internally,
# carrying the astronomical coefficient through the chain leaves
# near-f32-overflow residuals in reverse mode that XLA's scan compilation
# is free to reassociate into inf (the eager op-order stays finite; the
# compiled fori_loop NaNs — tests/test_checkpoint.py). At +-1e4 every
# attenuation is already ~0 and every growth already saturates the 1e30
# carried-total clamp, so no physical trajectory changes.
_RATE_CLIP = 1e4


# ---------------------------------------------------------------------------
# Age-structured cohort sweep (nonlinear per-particle state transport)
# ---------------------------------------------------------------------------


def _cohort_state(w0, speed0, carried0):
    """Pack the initial cohort state (see ops/cohort.py): weight, weighted
    mean velocity, weighted per-axis second velocity moments and the
    cross-moment (newborns are velocity-deterministic, so E[v^2] = v^2
    and E[vx*vy] = vx*vy), carried totals.

    Returned as a channel tuple; the solvers stack it with ops/cohort.py
    `as_stack`."""
    return (w0, w0 * speed0[0], w0 * speed0[1],
            w0 * speed0[0] * speed0[0],
            w0 * speed0[1] * speed0[1],
            w0 * speed0[0] * speed0[1],
            # Newborn sub-cell offsets: uniform over the birth cell
            # (erosion.cu:47-52 seeds pos uniformly): mean 1/2,
            # raw second moment E[f^2] = 1/3.
            w0 * 0.5, w0 * 0.5,
            w0 * (1.0 / 3.0), w0 * (1.0 / 3.0)) + tuple(carried0)


def _color_masks(M, rule, speed, shape, halo=NO_HALO):
    """Disjoint {0,1} birth-partition masks for the colored sub-ensemble
    quality mode (ops/cohort.py CohortClosure.colors); masks sum to 1.

    "dir": birth-velocity angle sectors, rotated half a bin so the M=2/4
    boundaries don't sit ON the axis directions (where most of a rough
    terrain's cells point).  "hash": Knuth-mix of the GLOBAL cell index
    (shard-invariant), the split-ensemble study's origin-decorrelated
    partition."""
    W, H = shape
    if rule == "dir":
        theta = jnp.arctan2(speed[1], speed[0])  # (-pi, pi]
        sect = jnp.floor((theta + jnp.pi) * (M / (2.0 * jnp.pi)) + 0.5)
        idx = sect.astype(jnp.int32) % M
    elif rule == "peak":
        # SOURCE-REGION partition: follow the steepest-ASCENT direction
        # (-speed ~ +grad) to the local peak each birth cell drains
        # FROM, and color by a hash of that peak id.  Confluence
        # partners arrive from different hillsides — different peaks —
        # so this separates exactly the co-located mixtures the moment
        # closure represents worst, where "hash" decorrelates origins
        # blindly and "dir" only separates by arrival angle.  (The
        # descent analog — outlet basins — POOLS confluence partners:
        # streams that merge share their downstream outlet.)  Cost: one
        # D8 quantization + ~log2(W+H) pointer-doubling gather rounds
        # per solve.  Single-device only: the pointer chase is global
        # (the sharded quality path keeps "hash"/"dir").
        if halo is not NO_HALO:
            raise NotImplementedError(
                "color_rule='peak' needs a global pointer chase; use "
                "'hash' or 'dir' under shard_map"
            )
        theta = jnp.arctan2(-speed[1], -speed[0])
        sect = (jnp.floor(theta * (4.0 / jnp.pi) + 0.5)
                .astype(jnp.int32) % 8)
        # Two (8,) tables, not one (8, 2): no C=2 minor dims (the
        # channel-first layout invariant, CLAUDE.md).
        d8x = jnp.array([1, 1, 0, -1, -1, -1, 0, 1], jnp.int32)
        d8y = jnp.array([0, 1, 1, 1, 0, -1, -1, -1], jnp.int32)
        dx = d8x[sect]
        dy = d8y[sect]
        xi = jnp.arange(W, dtype=jnp.int32)[:, None]
        yi = jnp.arange(H, dtype=jnp.int32)[None, :]
        self_idx = xi * H + yi
        up = (jnp.clip(xi + dx, 0, W - 1) * H
              + jnp.clip(yi + dy, 0, H - 1))
        still = _len2(speed[0], speed[1]) <= _EPS
        r = jnp.where(still, self_idx, up).reshape(-1)
        # Pointer doubling covers chains up to W*H (winding ridge paths
        # exceed W+H); ceil(log2(W*H)) rounds reach any chain's end.
        # Quantization cycles (the ascent graph is built from `speed`,
        # which includes momentum, so it is not a pure gradient) never
        # resolve to a single root — r stabilizes ON the cycle and its
        # cells hash to a few colors, harmless partition noise.
        for _ in range(max(1, math.ceil(math.log2(float(W) * H)))):
            r = r[r]
        h = r.astype(jnp.uint32) * jnp.uint32(2654435761)
        h = (h ^ (h >> 16)) * jnp.uint32(2246822519)
        idx = ((h ^ (h >> 13)) % jnp.uint32(M)).astype(jnp.int32)
        idx = idx.reshape(W, H)
    elif rule == "hash":
        x0, y0, _, Hg = halo.global_offsets((W, H))
        gx = x0 + jnp.arange(W, dtype=jnp.uint32)[:, None]
        gy = y0 + jnp.arange(H, dtype=jnp.uint32)[None, :]
        h = (gx * jnp.uint32(Hg) + gy) * jnp.uint32(2654435761)
        h = (h ^ (h >> 16)) * jnp.uint32(2246822519)
        idx = ((h ^ (h >> 13)) % jnp.uint32(M)).astype(jnp.int32)
        idx = jnp.broadcast_to(idx, (W, H))
    else:
        raise ValueError(f"unknown color_rule: {rule!r}")
    return [jnp.where(idx == m, 1.0, 0.0) for m in range(M)]


def _node_masks(nnodes, speed, node_rule="face"):
    """Birth-node assignment for the N-node mixture
    (CohortClosure.nodes): face rule — a newborn cohort joins the node
    of the face its velocity points toward ([+x, -x, +y, -y]; nodes=2
    pools the signs per axis); sign rule — its velocity sign quadrant
    ([++, +-, -+, --]), matching ops/cohort.py `_cohort_round_nodes`."""
    if node_rule == "speed":
        # [fast, slow]: newborns all carry birth-scale speed — they
        # start in the fast component; the slow one seeds from slow
        # ARRIVALS (ops/cohort.py _cohort_round_cluster speed mode).
        if nnodes != 2:
            raise ValueError("node_rule='speed' requires nodes=2")
        one = jnp.ones_like(speed[0])
        return [one, jnp.zeros_like(one)]
    if node_rule in ("sign", "cluster"):
        # Cluster births seed from the sign-quadrant prototypes too
        # (ops/cohort.py _cohort_round_cluster dead-node seeding).
        if nnodes != 4:
            raise ValueError(f"node_rule={node_rule!r} requires nodes=4")
        xpos = speed[0] >= 0.0
        ypos = speed[1] >= 0.0
        return [jnp.where(xpos & ypos, 1.0, 0.0),
                jnp.where(xpos & ~ypos, 1.0, 0.0),
                jnp.where(~xpos & ypos, 1.0, 0.0),
                jnp.where(~xpos & ~ypos, 1.0, 0.0)]
    ax_, ay_ = jnp.abs(speed[0]), jnp.abs(speed[1])
    isx = ax_ >= ay_
    if nnodes == 2:
        mx = jnp.where(isx, 1.0, 0.0)
        return [mx, 1.0 - mx]
    if nnodes == 4:
        xpos = speed[0] >= 0.0
        ypos = speed[1] >= 0.0
        return [jnp.where(isx & xpos, 1.0, 0.0),
                jnp.where(isx & ~xpos, 1.0, 0.0),
                jnp.where(~isx & ypos, 1.0, 0.0),
                jnp.where(~isx & ~ypos, 1.0, 0.0)]
    raise ValueError(f"nodes must be 1, 2 or 4, got {nnodes}")


def _build_cohort_state(w0, speed, carried0, closure):
    """Initial cohort state channels, node-split when the closure asks
    for the N-node mixture (every channel carries a w0 factor, so node
    masking is a per-channel multiply)."""
    nnodes = int(getattr(closure, "nodes", 1) or 1) if closure else 1
    if nnodes <= 1:
        return _cohort_state(w0, speed, carried0)
    rule = getattr(closure, "node_rule", "face")
    chans = ()
    for mk in _node_masks(nnodes, speed, rule):
        chans += _cohort_state(w0 * mk, speed, [c * mk for c in carried0])
    return chans


def _debris_closure(p):
    """Effective debris-transport closure (see ErosionParams.
    closureDebris): default strips the mixture-refinement quality knobs
    (nodes/colors) from `closure` — the debris cohort already matches
    MC at the floor with the single-ensemble closure, so quality cost
    belongs on the fluvial solve only."""
    import dataclasses as _dc

    cd = getattr(p, "closureDebris", None)
    if cd == "same":
        return p.closure
    if cd is not None:
        return cd
    if p.closure is None:
        return None
    return _dc.replace(p.closure, nodes=1, colors=1)


def _run_cohort_colored(halo, w0, speed, carried0, aux, rules, iters,
                        Llen, closure, tol=0.0):
    """Cohort solve, optionally split into `closure.colors` disjoint
    birth sub-populations whose deposits sum (transport is linear in
    sources — identical physics, finer mixture representation; see
    CohortClosure.colors). Every state channel carries a w0 factor, so
    masking the births is a per-channel multiply.

    The colours are solved one after another, in a `lax.scan` over the
    masks (one compiled solve, one colour's state live at a time): the
    round is bound by memory traffic, which batching does not reduce,
    while a batched state holds all M colour groups — and the round's
    temporaries for each — at once (544 channels at nodes=4, colors=8)."""
    import dataclasses as _dc

    from soillib_tpu.ops.cohort import ENV_CLOSURE

    cl = closure or ENV_CLOSURE
    M = int(getattr(cl, "colors", 1) or 1)
    if M <= 1:
        st0 = _build_cohort_state(w0, speed, carried0, cl)
        return halo.run_cohort(st0, aux, rules, iters, Llen, closure,
                               tol=tol)
    cl1 = _dc.replace(cl, colors=1)
    masks = jnp.stack(_color_masks(M, cl.color_rule, speed, w0.shape, halo))

    def one_color(G, mk):
        st0 = _build_cohort_state(w0 * mk, speed,
                                  [c * mk for c in carried0], cl)
        return G + halo.run_cohort(st0, aux, rules, iters, Llen, cl1,
                                   tol=tol), None

    G0 = jnp.zeros((len(carried0),) + tuple(w0.shape), jnp.float32)
    return jax.lax.scan(one_color, G0, masks)[0]


# ---------------------------------------------------------------------------
# Fluvial transport
# ---------------------------------------------------------------------------


def _fluvial_terms(
    layers, rainfall, discharge, momentum, albedo_surface, scale, p, halo=NO_HALO
):
    """Shared source/attenuation terms of the fluvial transport model
    (erosion.cu:62-96)."""
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    A = sx * sy
    Lvec = jnp.array([sx, sy], jnp.float32)
    Llen = math.sqrt(sx * sx + sy * sy)

    rho_w = p.densityWater
    nu = p.viscosityWater
    tau = p.bedShearWater
    g = p.gravity
    ks = p.suspensionRateFluvial / 64.0   # erosion.cu:68
    kd = p.depositionRateFluvial * 1.33   # erosion.cu:69
    fD = p.frictionFactor / 8.0           # erosion.cu:70
    alpha = p.fluvialExponent
    R = p.rainfall
    force = jnp.array(p.force, jnp.float32)

    grad = godunov_gradient(merged_height(layers), scale, p.exitSlope, halo)
    vel = momentum  # (2, W, H)

    # Trajectory-initial speed (erosion.cu:75-79): normalized by sqrt(|L*v|).
    speed = -(g * grad) + nu * vel + force[:, None, None]
    speed = speed / jnp.sqrt(
        jnp.maximum(_len2(sx * speed[0], sy * speed[1]), _EPS)
    )[None]

    # Source terms (erosion.cu:83-91); Q normalization is absorbed: the
    # field method uses expected per-cell emissions E = A * source-rate.
    v = _len2(vel[0], vel[1])
    shear = 0.125 * fD * rho_w * v * v
    power = _safe_pow(jnp.maximum(shear * _len2(grad[0], grad[1]), 0.0), alpha)
    E_m = A * ks * power
    # Broadcast here: rainfall may be a (1, 1) constant field (see
    # ErosionState.zeros) and E_w is concatenated with full-size channels.
    E_w = jnp.broadcast_to(
        A * R * jnp.asarray(rainfall, jnp.float32), E_m.shape
    )
    E_v = A * (-(g * grad) + nu * vel)
    E_a = E_m[None] * albedo_surface if p.trackAlbedo else None

    return dict(
        A=A, Llen=Llen, grad=grad, speed=speed, force=force,
        E_w=E_w, E_m=E_m, E_v=E_v, E_a=E_a,
        kd=kd, fD=fD, nu=nu, tau=tau, g=g,
    )


def transport_fluvial(
    layers,
    rainfall,
    discharge,
    mass,
    momentum,
    albedo_surface,
    scale,
    param: ErosionParams,
    *,
    method: str = None,
    key=None,
    iterations: int = None,
    halo=NO_HALO,
):
    """Fluvial transport: steady-state water height (discharge), suspended
    sediment mass, momentum, and transported albedo.

    Ref: __transport_fluvial + __normalize_fluvial (erosion.cu:29-239).

    Args:
      layers: (2, W, H) terrain state (bedrock, sediment).
      rainfall: (W, H) water source field (or any shape
        broadcastable to it, e.g. a (1, 1) constant).
      discharge: (W, H) previous water height (velocity-attenuation input).
      mass: (W, H) previous suspended mass (unused; kept for API parity).
      momentum: (2, W, H) previous momentum field.
      albedo_surface: (3, W, H) surface albedo (transport color source).
      scale: (sx, sy, sz).
    Returns:
      (discharge', mass', momentum', albedo_transport') new fields
      (channel-first for the multichannel ones).
    """
    p = param
    method = method or p.transportMethod
    t = _fluvial_terms(
        layers, rainfall, discharge, momentum, albedo_surface, scale, p, halo
    )

    if method in ("field", "field-static"):
        # Default rounds = maxage - 2: the MC trajectory loop runs
        # maxage-1 iterations and its first iteration never deposits
        # (the particle is still inside its birth cell).
        iters = iterations or (p.transportIterations or max(p.maxage - 2, 1))
        if method == "field":
            Gcf = _fluvial_cohort(t, rainfall, discharge, p, iters, halo)
        else:
            # Static-attenuation linear solve: fast, but blind to the
            # trajectory velocity evolution — on rough terrain particles
            # oscillate through pits with evolving speed and the static
            # direction field over-accumulates there (benchmarks/
            # parity.py: noise-terrain discharge corr 0.19 vs 0.99).
            Gcf = _fluvial_field(t, discharge, p, iters, halo)
    elif method == "particles":
        if halo is not NO_HALO:
            raise NotImplementedError(
                "method='particles' does not run inside a shard_map'd "
                "step (the field solve is the in-step sharded "
                "formulation); for distributional MC at mesh scale use "
                "parallel.fluvial_particles_sharded, which migrates "
                "particles across blocks by ppermute"
            )
        if key is None:
            key = jax.random.PRNGKey(0)
        Gcf = jnp.moveaxis(
            _fluvial_particles(
                layers, rainfall, discharge, momentum, albedo_surface,
                scale, p, key,
            ),
            -1, 0,
        )  # particle path returns (W, H, 7)
    else:
        raise ValueError(f"unknown transport method: {method!r}")

    # Unpack/normalize channel-FIRST; the (W, H, C) outputs are formed only
    # at the return boundary, so no large channel-last intermediate (a
    # strided (N*N, C) layout) exists inside the step.
    G_w, G_m = Gcf[0], Gcf[1]
    G_vx, G_vy = Gcf[2], Gcf[3]
    G_a = Gcf[4:7] if Gcf.shape[0] > 4 else None

    # Normalization (erosion.cu:143-187). Fixed v=(1,0) -> norm = scale.y.
    norm = float(scale[1])
    A = t["A"]
    grad = t["grad"]
    force = t["force"]
    sv_x = -p.gravity * grad[0] + force[0]
    sv_y = -p.gravity * grad[1] + force[1]
    discharge_out = (A * p.rainfall * rainfall + G_w) / norm
    mass_out = G_m / norm
    momentum_out = jnp.stack(
        [(A * sv_x + G_vx) / norm, (A * sv_y + G_vy) / norm], axis=0
    )

    if G_a is None:
        albedo_out = albedo_surface  # untracked: identity pass-through
    else:
        has_mass = (G_m > 0.0) & (jnp.sum(G_a * G_a, axis=0) > 0.0)
        albedo_out = jnp.where(
            has_mass[None], G_a / jnp.maximum(G_m, _EPS)[None],
            albedo_surface,
        )
    return discharge_out, mass_out, momentum_out, albedo_out


def _3len(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def make_fluvial_rules(p, Llen, albedo_on=None):
    """The fluvial cohort physics callback (module-level so bench.py's
    roofline can trace the REAL closure — see bench.py cohort_round_ops).
    Captures only static scalars; per-cell inputs ride in `aux`.

    Returns per-CLASS transit factors (water/mass/momentum); the static
    `rules.classes` maps carried channels (water, mass, vel_x, vel_y
    [, albedo rgb]) to classes so ops/cohort.py can fold each stream's
    factors into its push weights once per class."""
    kd = p.depositionRateFluvial * 1.33   # erosion.cu:69
    nu = p.viscosityWater
    tau = p.bedShearWater
    evap = p.evapRate
    if albedo_on is None:
        albedo_on = p.trackAlbedo

    def rules(dL, inv, w, carried, unit2, aux):
        ux, uy = unit2
        rate_v = aux[0]  # static per-cell momentum-decay rate, hoisted
        w1 = 1.0 / (1.0 + dL * (tau + nu))
        # ds = dL / v exponents are << 1 at fluvial rates — plain exp at
        # the mean step suffices (Jensen correction immaterial); the
        # momentum decay 0.125*fD/waterHeight can be O(1)+, so it takes
        # the exact position-averaged factor. Its per-cell rate depends
        # only on the static discharge field, so the caller precomputes
        # it once per solve (aux[0]) instead of per round.
        fac_w = jnp.exp(-jnp.minimum(dL * inv * evap, 88.0))
        fac_m = jnp.exp(-jnp.minimum(dL * inv * kd, 88.0))
        fac_v = expected_exp_step(ux, uy, rate_v)
        return w1, (fac_w, fac_m, fac_v)

    # (water, mass, vel_x, vel_y[, albedo r, g, b]); albedo shares the
    # mass attenuation (erosion.cu:111-113).
    rules.classes = (0, 1, 2, 2) + ((1, 1, 1) if albedo_on else ())
    # Every transit factor <= 1 when the decay rates are non-negative
    # (fac_w/fac_m are exp(-rate*ds), fac_v's rate is clipped <= 0 by
    # the caller) — the contract the adaptive exit's live*remaining
    # deposit bound needs (ops/cohort.py carried_live).  A user-set
    # negative evapRate/depositionRate (growth) drops the declaration
    # and the exit falls back to the rigorous live == 0 criterion.
    rules.contractive = bool(evap >= 0.0 and kd >= 0.0)
    return rules


def _fluvial_cohort(t, rainfall, discharge, p, iters, halo=NO_HALO):
    """Age-structured cohort solve of the fluvial transport — the default
    field method. Carries the per-particle attenuation products
    (att_w*source_w, att_m*source_m, att_v*source_v, att_m*source_a) as
    cohort totals while the cohort velocity evolves by the implicit-Euler
    friction update (erosion.cu:100-136), so trajectory curvature, pit
    oscillation damping, and speed-dependent transit times are all
    represented (the static-attenuation solve is not — see
    transport_fluvial). Returns (7, W, H) deposits."""
    speed = t["speed"]
    Llen = t["Llen"]
    A = t["A"]
    accel = t["E_v"] / A + t["force"][:, None, None]
    rules = make_fluvial_rules(p, Llen)

    W, H = discharge.shape
    bd = _birth_density(W, H, halo=halo)
    carried0 = [bd * t["E_w"], bd * t["E_m"], bd * t["E_v"][0],
                bd * t["E_v"][1]]
    if t["E_a"] is not None:
        carried0 += [bd * t["E_a"][0], bd * t["E_a"][1], bd * t["E_a"][2]]
    # Static per-cell momentum-decay rate (the expression the rules used
    # to evaluate per round; bitwise-identical hoist — see make_fluvial_
    # rules).
    fD = p.frictionFactor / 8.0
    rate_v = jnp.clip(
        -Llen * 0.125 * fD / (_EPS + discharge), -_RATE_CLIP, 0.0
    )
    aux = (accel[0], accel[1], jnp.ones_like(discharge), rate_v)
    return _run_cohort_colored(halo, bd, speed, carried0, aux, rules,
                               iters, Llen, p.closure, tol=p.transportTol)


def _fluvial_field(t, discharge, p, iters, halo=NO_HALO):
    """Deterministic upwind fixed point of the fluvial transport operator.

    Returns the flux tensor channel-FIRST, (7, W, H) = (water, mass, vel_x,
    vel_y, albedo_rgb), solved by `halo.run_transport` — one fused push
    per round on a single device (ops/sweep.py), the K-blocked ppermute
    exchange under shard_map."""
    speed = t["speed"]
    v_norm = _len2(speed[0], speed[1])
    alive = v_norm >= _EPS
    inv = 1.0 / jnp.maximum(v_norm, _EPS)
    vx, vy = speed[0] * inv, speed[1] * inv

    step = stepsize_center(vx, vy)
    dL = step * t["Llen"]
    ds = dL * inv

    att_m = _masked_exp(alive, -ds * t["kd"])
    att_w = _masked_exp(alive, -ds * p.evapRate)
    att_v = _masked_exp(alive, -dL * 0.125 * t["fD"] / (_EPS + discharge))

    # Emissions carry the reference sampler's birth-density quirk; the
    # A*source terms of the normalize pass stay nominal (erosion.cu:163).
    bd = _birth_density(*t["E_w"].shape, halo=halo)[None]
    parts = [t["E_w"][None], t["E_m"][None], t["E_v"]]
    atts = [att_w, att_m, att_v, att_v]
    if t["E_a"] is not None:
        parts.append(t["E_a"])
        atts += [att_m, att_m, att_m]
    E = bd * jnp.concatenate(parts, axis=0)
    att = jnp.stack(atts, axis=0)
    return halo.run_transport(E, att, vx, vy, iters)


def _fluvial_particles(
    layers, rainfall, discharge, momentum, albedo_surface, scale, p, key
):
    """Faithful vectorized MC fluvial transport (erosion.cu:29-141).

    Returns the expected-flux tensor G (W, H, 7) = (water, mass, vel2,
    albedo3), already divided by nothing — the reference normalization
    absorbs Q = 1/(P*N) into the per-particle source; equivalently each
    particle deposits source-rate * A * Ncells / N.
    """
    W, H = discharge.shape
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    A = sx * sy
    Lvec = jnp.array([sx, sy], jnp.float32)
    Llen = math.sqrt(sx * sx + sy * sy)
    N = int(p.nSamples)
    Q = A * W * H / N  # = 1/(P*N), P = 1/(A*elem)   (erosion.cu:53-54)

    g = p.gravity
    nu = p.viscosityWater
    tau = p.bedShearWater
    rho_w = p.densityWater
    ks = p.suspensionRateFluvial / 64.0
    kd = p.depositionRateFluvial * 1.33
    fD = p.frictionFactor / 8.0
    alpha = p.fluvialExponent
    R = p.rainfall
    force = jnp.array(p.force, jnp.float32)

    height = merged_height(layers)
    grad_field = godunov_gradient(height, scale, p.exitSlope)  # (2, W, H)

    ku, kv = jax.random.split(key)
    pos = jnp.stack(
        [
            0.5 + jax.random.uniform(ku, (N,)) * (W - 1),
            0.5 + jax.random.uniform(kv, (N,)) * (H - 1),
        ],
        axis=-1,
    )
    ind = pos[:, 0].astype(jnp.int32) * H + pos[:, 1].astype(jnp.int32)

    mom_flat = jnp.moveaxis(jnp.asarray(momentum), 0, -1).reshape(-1, 2)
    rain_flat = jnp.broadcast_to(
        jnp.asarray(rainfall, jnp.float32), (W, H)
    ).reshape(-1)
    alb_flat = jnp.moveaxis(jnp.asarray(albedo_surface), 0, -1).reshape(-1, 3)
    dis_flat = jnp.asarray(discharge).reshape(-1)
    grad_flat = jnp.moveaxis(grad_field, 0, -1).reshape(-1, 2)

    def grad_at(pcell):
        return grad_flat[pcell]

    vel0 = mom_flat[ind]
    grad0 = grad_at(ind)
    speed = -(g * grad0) + nu * vel0 + force
    speed = speed / jnp.sqrt(
        jnp.maximum(_length(Lvec[None, :] * speed), _EPS)
    )[:, None]
    alive = _length(speed) >= _EPS

    v = _length(vel0)
    shear = 0.125 * fD * rho_w * v * v
    power = jnp.power(jnp.maximum(shear * _length(grad0), 0.0), alpha)
    source_m = Q * ks * power
    source_w = Q * R * rain_flat[ind]
    source_v = Q * (-(g * grad0) + nu * vel0)
    source_a = source_m[:, None] * alb_flat[ind]

    flux0 = jnp.zeros((W * H, 7), jnp.float32)
    att0 = jnp.ones((N, 3), jnp.float32)  # (w, m, v)

    def body(_, carry):
        flux, pos, ind, att, speed, alive = carry
        x, y = pos[:, 0], pos[:, 1]
        inb = (x >= 0) & (y >= 0) & (x < W) & (y < H)
        alive = alive & inb

        posc = jnp.clip(pos, 0.0, jnp.array([W - 1e-3, H - 1e-3]))
        nind = posc[:, 0].astype(jnp.int32) * H + posc[:, 1].astype(jnp.int32)
        entered = alive & (nind != ind)
        ind = jnp.where(entered, nind, ind)
        dep = jnp.concatenate(
            [
                (att[:, 0] * source_w)[:, None],
                (att[:, 1] * source_m)[:, None],
                att[:, 2:3] * source_v,
                att[:, 1:2] * source_a,
            ],
            axis=-1,
        )
        flux = flux.at[ind].add(jnp.where(entered[:, None], dep, 0.0))

        v_norm = _length(speed)
        ok = v_norm >= _EPS
        alive = alive & ok
        v_unit = speed / jnp.maximum(v_norm, _EPS)[:, None]
        stp = stepsize(pos, v_unit)
        dL = stp * Llen
        ds = dL / jnp.maximum(v_norm, _EPS)

        gradp = grad_at(ind)
        accel = -(g * gradp) + nu * mom_flat[ind] + force
        w1 = 1.0 / (1.0 + dL * (tau + nu))
        new_speed = w1[:, None] * speed + (dL * w1)[:, None] * accel

        decay_v = 0.125 * fD / (_EPS + dis_flat[ind])
        new_att = jnp.stack(
            [
                att[:, 0] * jnp.exp(-ds * p.evapRate),
                att[:, 1] * jnp.exp(-ds * kd),
                att[:, 2] * jnp.exp(-dL * decay_v),
            ],
            axis=-1,
        )
        new_pos = pos + stp[:, None] * v_unit

        pos = jnp.where(alive[:, None], new_pos, pos)
        att = jnp.where(alive[:, None], new_att, att)
        speed = jnp.where(alive[:, None], new_speed, speed)
        return flux, pos, ind, att, speed, alive

    # The reference loop `while(... && ++iter < maxage)` executes at most
    # maxage - 1 iterations (erosion.cu:101).
    flux, *_ = jax.lax.fori_loop(
        0, max(int(p.maxage) - 1, 0), body, (flux0, pos, ind, att0, speed, alive)
    )
    return flux.reshape(W, H, 7)


# ---------------------------------------------------------------------------
# Debris transport
# ---------------------------------------------------------------------------


def make_debris_rules(p, Llen, rho, albedo_on=None):
    """The debris cohort physics callback (module-level so bench.py's
    roofline can trace the REAL closure). `rho` = particles born per cell
    (N-aware closure, see transport_debris). Factor-class form — see
    make_fluvial_rules."""
    nu = p.viscosityDebris
    tau = p.bedShearDebris
    g = p.gravity
    kdd = p.depositionRateDebris
    kds = p.suspensionRateDebris
    tau_y = p.yieldStress
    if albedo_on is None:
        albedo_on = p.trackAlbedo

    def rules(dL, inv, w, carried, unit2, aux):
        ux, uy = unit2
        excess0 = aux[0]
        M = carried[0]
        # Per-particle carried mass, capped at 1e12 (double-where):
        # thin-but-alive cohorts keep the exact intensive M/(w rho)
        # — carried totals scale with w, so the ratio stays O(1) as
        # cohorts spread — while saturated pathology (M at the 1e30
        # clamp over w ~ 1e-12) would otherwise put the division's
        # reverse-mode residual out/den ~ 1e43 past f32 under XLA's
        # reassociation freedom (see _RATE_CLIP).
        den = w * rho
        big = M > den * 1e12
        m_pp = jnp.where(big, 1e12, M / jnp.where(big, 1.0, den))
        debrisHeight = _EPS + m_pp
        decay = nu + tau / debrisHeight
        w1 = 1.0 / (1.0 + dL * decay)

        excessStress = g * (excess0 - tau_y / debrisHeight)
        shearRate = jnp.where(excessStress < 0.0, kdd, kds)
        # decay_d = ds * rate * stress / v (erosion.cu:344) with
        # ds = dL/v — linear in the crossing distance, so the cohort
        # factor is the exact position-averaged expectation rather
        # than exp at the mean step (Jensen bias otherwise).
        fac_d = expected_exp_step(
            ux, uy,
            jnp.clip(Llen * inv * shearRate * excessStress * inv,
                     -_RATE_CLIP, _RATE_CLIP),
        )
        fac_v = expected_exp_step(
            ux, uy, jnp.clip(-Llen * decay, -_RATE_CLIP, 0.0)
        )
        return w1, (fac_d, fac_v)

    # (mass, vel_x, vel_y[, albedo r, g, b]); albedo shares the mass
    # factor (erosion.cu:311-321).
    rules.classes = (0, 1, 1) + ((0, 0, 0) if albedo_on else ())
    return rules


def transport_debris(
    layers,
    mass,
    momentum,
    albedo_surface,
    scale,
    param: ErosionParams,
    *,
    method: str = None,
    key=None,
    iterations: int = None,
    halo=NO_HALO,
):
    """Debris-flow / landslide transport with Bingham-plastic-like rheology.

    Source = kl * max(0, |∇h| - critSlopeBedrock); the carried mass grows
    above the yield-stress balance (suspension) and decays below it
    (deposition), with asymmetric rates. Ref: erosion.cu:245-436.

    Args:
      layers: (2, W, H); mass: (W, H) previous debris field;
      momentum: (2, W, H); albedo_surface: (3, W, H).
    Returns:
      (mass', momentum', albedo_transport') — channel-first.
    """
    p = param
    method = method or p.transportMethod
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    A = sx * sy
    Lvec = jnp.array([sx, sy], jnp.float32)
    Llen = math.sqrt(sx * sx + sy * sy)

    theta = p.critSlopeBedrock
    nu = p.viscosityDebris
    g = p.gravity
    kl = p.landslideRateDebris

    grad = godunov_gradient(merged_height(layers), scale, p.exitSlope, halo)
    vel = momentum  # (2, W, H)
    speed = -(g * grad) + nu * vel
    speed = speed / jnp.sqrt(
        jnp.maximum(_len2(sx * speed[0], sy * speed[1]), _EPS)
    )[None]

    excess0 = _len2(grad[0], grad[1]) - theta
    suspend = jnp.maximum(0.0, kl * excess0)
    E_d = A * suspend
    E_v = A * (-(g * grad) + nu * vel)
    E_a = E_d[None] * albedo_surface if p.trackAlbedo else None

    if method in ("field", "field-static"):
        # maxage - 2 deposit opportunities (see transport_fluvial).
        # ("field-static" is a fluvial-only distinction; debris always
        # needs the cohort rheology.)
        iters = iterations or (p.transportIterations or max(p.maxage - 2, 1))

        # The debris rheology is evaluated per particle with ITS carried
        # mass (debrisHeight = eps + att_d * source_d, erosion.cu:333) and
        # its trajectory-evolved velocity — with the default bed shear
        # (0.99) and tiny carried masses, particle speed collapses within
        # a couple of cells, so debris is short-range in a way no static
        # initial-attenuation field can represent (benchmarks/parity.py).
        # The age-structured cohort sweep transports the evolving particle
        # state directly. The newborn carried mass scales with particle
        # density rho = N/cells (Q = A*cells/N, erosion.cu:267), so the
        # closure is N-aware.
        W, H = mass.shape
        _, _, Wg, Hg = halo.global_offsets((W, H))  # global grid dims
        rho = float(p.nSamples) / float(Wg * Hg)    # particles born per cell
        accel = E_v / A
        rules = make_debris_rules(p, Llen, rho)

        # Cohort weight = the reference sampler's birth density (quirk,
        # see _birth_density); per-particle carried mass M/(w*rho) is
        # invariant to it since carried totals scale identically.
        w0 = _birth_density(W, H, halo=halo)
        carried0 = [w0 * E_d, w0 * E_v[0], w0 * E_v[1]]
        if E_a is not None:
            carried0 += [w0 * E_a[0], w0 * E_a[1], w0 * E_a[2]]
        # aux = (accel, domain mask (ones; zero-padding kills escapees),
        #        rules aux...) — see ops/cohort.py layout.
        aux = (accel[0], accel[1], jnp.ones_like(excess0), excess0)
        Gcf = _run_cohort_colored(halo, w0, speed, carried0, aux, rules,
                                  iters, Llen, _debris_closure(p),
                                  tol=p.transportTol)
    elif method == "particles":
        if halo is not NO_HALO:
            raise NotImplementedError(
                "method='particles' does not run inside a shard_map'd "
                "step; use method='field' (see parallel.particles for "
                "the cross-block-migration MC estimators)"
            )
        if key is None:
            key = jax.random.PRNGKey(0)
        Gcf = jnp.moveaxis(
            _debris_particles(layers, mass, momentum, albedo_surface, scale, p, key),
            -1, 0,
        )
    else:
        raise ValueError(f"unknown transport method: {method!r}")

    # Channel-first unpack/normalize (see transport_fluvial for why).
    G_d = Gcf[0]
    G_vx, G_vy = Gcf[1], Gcf[2]
    G_a = Gcf[3:6] if Gcf.shape[0] > 3 else None

    # Normalization (erosion.cu:353-393): fixed v=(1,0) -> norm = scale.y.
    norm = float(scale[1])
    mass_out = G_d / norm
    momentum_out = jnp.stack(
        [(A * (-p.gravity * grad[0]) + G_vx) / norm,
         (A * (-p.gravity * grad[1]) + G_vy) / norm], axis=0
    )
    if G_a is None:
        albedo_out = albedo_surface  # untracked: identity pass-through
    else:
        has_mass = (G_d > 0.0) & (jnp.sum(G_a * G_a, axis=0) > 0.0)
        albedo_out = jnp.where(
            has_mass[None], G_a / jnp.maximum(G_d, _EPS)[None],
            albedo_surface,
        )
    return mass_out, momentum_out, albedo_out


def _debris_particles(layers, mass, momentum, albedo_surface, scale, p, key):
    """Faithful vectorized MC debris transport (erosion.cu:245-351)."""
    W, H = mass.shape
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    A = sx * sy
    Lvec = jnp.array([sx, sy], jnp.float32)
    Llen = math.sqrt(sx * sx + sy * sy)
    N = int(p.nSamples)
    Q = A * W * H / N

    theta = p.critSlopeBedrock
    nu = p.viscosityDebris
    tau = p.bedShearDebris
    g = p.gravity
    kl = p.landslideRateDebris
    kdd = p.depositionRateDebris
    kds = p.suspensionRateDebris
    tau_y = p.yieldStress

    grad_field = godunov_gradient(merged_height(layers), scale, p.exitSlope)
    grad_flat = jnp.moveaxis(grad_field, 0, -1).reshape(-1, 2)
    mom_flat = jnp.moveaxis(jnp.asarray(momentum), 0, -1).reshape(-1, 2)
    alb_flat = jnp.moveaxis(jnp.asarray(albedo_surface), 0, -1).reshape(-1, 3)

    ku, kv = jax.random.split(key)
    pos = jnp.stack(
        [
            0.5 + jax.random.uniform(ku, (N,)) * (W - 1),
            0.5 + jax.random.uniform(kv, (N,)) * (H - 1),
        ],
        axis=-1,
    )
    ind = pos[:, 0].astype(jnp.int32) * H + pos[:, 1].astype(jnp.int32)

    vel0 = mom_flat[ind]
    grad0 = grad_flat[ind]
    speed = -(g * grad0) + nu * vel0
    speed = speed / jnp.sqrt(
        jnp.maximum(_length(Lvec[None, :] * speed), _EPS)
    )[:, None]
    alive = _length(speed) >= _EPS

    excess0 = _length(grad0) - theta
    source_d = Q * jnp.maximum(0.0, kl * excess0)
    source_v = Q * (-(g * grad0) + nu * vel0)
    source_a = source_d[:, None] * alb_flat[ind]

    flux0 = jnp.zeros((W * H, 6), jnp.float32)
    att0 = jnp.ones((N, 2), jnp.float32)  # (d, v)

    def body(_, carry):
        flux, pos, ind, att, speed, alive = carry
        x, y = pos[:, 0], pos[:, 1]
        inb = (x >= 0) & (y >= 0) & (x < W) & (y < H)
        alive = alive & inb

        posc = jnp.clip(pos, 0.0, jnp.array([W - 1e-3, H - 1e-3]))
        nind = posc[:, 0].astype(jnp.int32) * H + posc[:, 1].astype(jnp.int32)
        entered = alive & (nind != ind)
        ind = jnp.where(entered, nind, ind)
        dep = jnp.concatenate(
            [
                (att[:, 0] * source_d)[:, None],
                att[:, 1:2] * source_v,
                att[:, 0:1] * source_a,
            ],
            axis=-1,
        )
        flux = flux.at[ind].add(jnp.where(entered[:, None], dep, 0.0))

        v_norm = _length(speed)
        ok = v_norm >= _EPS
        alive = alive & ok
        v_unit = speed / jnp.maximum(v_norm, _EPS)[:, None]
        stp = stepsize(pos, v_unit)
        dL = stp * Llen
        ds = dL / jnp.maximum(v_norm, _EPS)

        gradp = grad_flat[ind]
        debrisHeight = _EPS + att[:, 0] * source_d
        accel = -(g * gradp) + nu * mom_flat[ind]
        decay = nu + tau / debrisHeight
        w1 = 1.0 / (1.0 + dL * decay)
        new_speed = w1[:, None] * speed + (w1 * dL)[:, None] * accel

        excess = _length(gradp) - theta
        excessStress = g * (excess - tau_y / debrisHeight)
        shearRate = jnp.where(excessStress < 0.0, kdd, kds)
        decay_d = ds * shearRate * excessStress / jnp.maximum(v_norm, _EPS)
        new_att = jnp.stack(
            [att[:, 0] * jnp.exp(decay_d), att[:, 1] * jnp.exp(-dL * decay)],
            axis=-1,
        )
        new_pos = pos + stp[:, None] * v_unit

        pos = jnp.where(alive[:, None], new_pos, pos)
        att = jnp.where(alive[:, None], new_att, att)
        speed = jnp.where(alive[:, None], new_speed, speed)
        return flux, pos, ind, att, speed, alive

    # `++iter < maxage` -> maxage - 1 iterations (erosion.cu:281-style loop).
    flux, *_ = jax.lax.fori_loop(
        0, max(int(p.maxage) - 1, 0), body, (flux0, pos, ind, att0, speed, alive)
    )
    return flux.reshape(W, H, 6)


# ---------------------------------------------------------------------------
# Mass transfer + creep
# ---------------------------------------------------------------------------


def mass_transfer(
    delta,
    layers,
    uplift,
    discharge,
    mass,
    momentum,
    debris,
    momentum_debris,
    albedo_bedrock,
    albedo_transport_fluvial,
    albedo_transport_debris,
    albedo_surface,
    scale,
    param: ErosionParams,
    halo=NO_HALO,
):
    """Eulerian height-field update: fluvial suspend/deposit, debris
    suspend/deposit, uplift — stability-clamped, two-layer bookkeeping,
    surface-albedo mixing. Ref: __transfer (erosion.cu:453-611).

    Returns (delta', albedo_surface').
    """
    p = param
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    dt = p.timeStep
    ku = p.uplift
    kfs = p.suspensionRateFluvial / 64.0
    kfd = p.depositionRateFluvial * 1.33
    fD = p.frictionFactor / 8.0
    alpha = p.fluvialExponent
    rho = p.densityWater
    g = p.gravity
    tau_y = p.yieldStress
    kds = p.suspensionRateDebris
    kdd = p.depositionRateDebris
    kL = p.landslideRateDebris
    eps = _EPS

    grad = godunov_gradient(merged_height(layers), scale, p.exitSlope, halo)
    L = math.sqrt(sx * sx + sy * sy)
    slope = _len2(grad[0], grad[1])

    # Fluvial erosion (erosion.cu:496-506)
    v = _len2(momentum[0], momentum[1])
    shear = 0.125 * fD * rho * v * v
    power = _safe_pow(jnp.maximum(shear * slope, 0.0), alpha)
    suspend = kfs * power
    deposit = kfd * mass
    uplift_rate = ku * uplift

    # Debris erosion (erosion.cu:508-514)
    debrisHeight = debris
    excessSlope = slope - p.critSlopeBedrock
    shearLandslide = jnp.maximum(0.0, kL * excessSlope)
    shearYield = g * (debrisHeight * excessSlope - tau_y)
    suspendDebris = shearLandslide + kds * jnp.maximum(0.0, shearYield)
    depositDebris = jnp.minimum(debrisHeight, jnp.maximum(0.0, -kdd * shearYield))

    # Stability-clamped transfer (erosion.cu:526-528)
    transfer = dt * (deposit - suspend + depositDebris - suspendDebris)
    transfer = jnp.maximum(transfer, -0.25 * L * slope)
    transfer = jnp.minimum(transfer, 0.25 * L * 0.3)

    # Two-layer bookkeeping (erosion.cu:530-547): deposition -> sediment,
    # erosion eats sediment then bedrock, uplift -> bedrock only.
    d_bed = delta[0] + dt * uplift_rate / sz
    d_sed = delta[1] + jnp.maximum(0.0, transfer) / sz

    sed = layers[1]
    neg = transfer < 0.0
    limited = jnp.maximum(-sed * sz, transfer)  # sediment portion (<= 0)
    residual = transfer - limited                # bedrock portion  (<= 0)
    d_sed = d_sed + jnp.where(neg, limited / sz, 0.0)
    d_bed = d_bed + jnp.where(neg, residual / sz, 0.0)
    transfer_post = jnp.where(neg, residual, transfer)

    delta_out = jnp.stack([d_bed, d_sed], axis=0)

    # Surface / transport albedo mixing (erosion.cu:549-572); albedo fields
    # are channel-first so channel broadcasts use [None].
    totalHeight = mass + debrisHeight
    if not p.trackAlbedo:
        return delta_out, albedo_surface  # untracked: identity

    mixDepth = 1.0
    wMass = jnp.minimum(mass / jnp.maximum(totalHeight, _EPS), 1.0)
    colorTransport = jnp.minimum(
        1.0,
        wMass[None] * albedo_transport_fluvial
        + (1.0 - wMass[None]) * albedo_transport_debris,
    )
    colorSurface = jnp.minimum(1.0, albedo_surface)
    wSurf = jnp.minimum(mixDepth, sed * sz)
    wTrsp = jnp.maximum(eps, transfer_post)
    wmix = jnp.minimum(wTrsp / (wTrsp + wSurf), 1.0)
    colorMix = wmix[None] * colorTransport + (1.0 - wmix[None]) * colorSurface

    bare = sed == 0.0
    depositing = (totalHeight > 0.0) & (transfer_post > eps)
    albedo_out = jnp.where(
        bare[None],
        albedo_bedrock,
        jnp.where(depositing[None], colorMix, albedo_surface),
    )
    return delta_out, albedo_out


def mass_creep(delta, layers, scale, param: ErosionParams, halo=NO_HALO):
    """Thermal erosion / hillslope creep: symmetric rate-limited transfer of
    sediment between 4-neighbors, unconditionally stable (x0.25), exactly
    mass-conservative by symmetry. Ref: __mass_creep (erosion.cu:633-727).

    Returns delta'.
    """
    p = param
    sx, sy, sz = float(scale[0]), float(scale[1]), float(scale[2])
    critSlope = p.critSlopeSediment

    bed = layers[0]
    # Edge-pad: for a radius-1 shift, clamp-to-edge reproduces the creep
    # kernel's clamp-to-self substitution (erosion.cu:655-658) exactly —
    # the substituted neighbor equals the center cell, making the pair
    # transfer vanish at the boundary either way.
    sed = halo.pad(layers[1], "edge")
    h = (halo.pad(bed, "edge") + sed) * sz

    def pair_transfer(dx, dy, s):
        """Net gain at each cell from its (+dx, +dy) neighbor (may be <0)."""
        # Neighbor values with clamp-to-self at the boundary (erosion.cu:655-658)
        hn = _shift_self(h, dx, dy)
        sed_n = _shift_self(sed, dx, dy)
        # Downhill-from-neighbor: neighbor higher -> we gain t = transfer(us, nbr)
        gain = jnp.maximum(
            0.0, jnp.minimum(sed_n * sz, 0.5 * ((hn - h) - critSlope * s))
        )
        # Uphill: we are higher -> we lose transfer(nbr, us)
        loss = jnp.maximum(
            0.0, jnp.minimum(sed * sz, 0.5 * ((h - hn) - critSlope * s))
        )
        return jnp.where(hn > h, gain, -loss)

    t = (
        pair_transfer(+1, 0, sx)
        + pair_transfer(-1, 0, sx)
        + pair_transfer(0, +1, sy)
        + pair_transfer(0, -1, sy)
    )
    d_sed = delta[1] + 0.25 * halo.crop(t) / sz
    return jnp.stack([delta[0], d_sed], axis=0)


def _shift_self(h, dx, dy):
    """Shift with boundary cells replaced by the center value (the creep
    kernel's oob -> l00 substitution, erosion.cu:655-658)."""
    W, H = h.shape[0], h.shape[1]
    shifted = jnp.roll(h, shift=(-dx, -dy), axis=(0, 1))
    x = jnp.arange(W)[:, None] + dx
    y = jnp.arange(H)[None, :] + dy
    oob = (x < 0) | (x >= W) | (y < 0) | (y >= H)
    return jnp.where(oob, h, shifted)


# ---------------------------------------------------------------------------
# Albedo generators (in-sim visualization instrumentation)
# ---------------------------------------------------------------------------


def albedo_stratum(uplift, layers, scale, param, colorA, colorB, age, freq):
    """Striped bedrock color from total uplift displacement.
    Ref: erosion.cu:794-854."""
    sz = float(scale[2])
    shift = age * param.uplift * uplift
    depth = jnp.maximum(shift - layers[0] * sz, 0.0)
    index = jnp.floor(depth / freq).astype(jnp.int32)
    even = index % 2 == 0
    cA = jnp.asarray(colorA, jnp.float32)[:, None, None]
    cB = jnp.asarray(colorB, jnp.float32)[:, None, None]
    return jnp.where(even[None], cA, cB)


def albedo_layer(albedo_bedrock, albedo_sediment, layers, scale_sediment, shift_sediment):
    """Bedrock-sediment blend 1/(1 + scale*sed). Ref: erosion.cu:759-791."""
    cS = jnp.minimum(1.0, albedo_sediment + jnp.asarray(shift_sediment, jnp.float32))
    blend = 1.0 / (1.0 + scale_sediment * layers[1])
    return blend[None] * albedo_bedrock + (1.0 - blend[None]) * cS


def albedo_discharge(albedo, discharge, color_discharge, extinction, scale):
    """Extinction blend toward the water color. Ref: erosion.cu:857-919."""
    value = jnp.maximum(0.0, discharge)
    blend = scale * (1.0 - jnp.exp(-extinction * value))
    c = jnp.asarray(color_discharge, jnp.float32)[:, None, None]
    return blend[None] * c + (1.0 - blend[None]) * albedo
