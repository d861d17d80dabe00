"""Age-structured cohort transport: the per-round field solve.

The cohort transport (models/erosion.py `_cohort_round`-style dynamics:
per-cell particle cohorts whose velocity/carried-mass state evolves each
transit, deposits accumulated on arrival) is a *nonlinear* radius-1
stencil per round. Each round is plain `jax.numpy`/`lax` code that XLA
fuses; `cohort_advance_reference` iterates it, and the sharded solve
(parallel/halo.py `ShardHalo.run_cohort`) advances the same round
K rounds at a time between K-wide halo exchanges — information moves
one cell per round, so stale ring values never reach a block interior
within K rounds (the trapezoid argument). Stale halo values stay finite
(divisions are eps-guarded, exponents clipped).

Ref: the per-particle trajectory loop this models is erosion.cu:281-351
(debris); the deposits are the atomicAdd entries at erosion.cu:311-321.

State layout (channel-first):
  st  = (NSTATE + C, W, H): [w, w*vx, w*vy, w*E[vx^2], w*E[vy^2],
                             w*E[vx*vy], w*E[fx], w*E[fy],
                             w*E[fx^2], w*E[fy^2], carried...]
  aux = (3 + A, W, H): [accel_x, accel_y, domain mask, rules aux...]
  G   = (C, W, H) accumulated arrival deposits.

The domain mask (ones over the domain) is what makes the K-round block
advance safe at boundaries: cohort state pushed into a zero-padded ring
would evolve and re-emit within the K rounds, so the zero padding of aux
turns the ring into a kill zone (particles leaving the domain die,
erosion.cu:281 `__oob`).

`rules(dL, inv_speed, w, carried, (ux, uy), aux_tail)` is the physics
callback (traced into the round); it returns the implicit-Euler friction
weight w1 and a tuple of per-attenuation-CLASS transit factors; the static
attribute `rules.classes` maps each carried channel to its factor class.
The factor form (rather than pre-multiplied carried totals) is what makes
per-stream evaluation affordable: each directional stream's factors fold
into its push weights once per class instead of once per channel.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

from soillib_tpu.ops.transport import stepsize_expected, stepsize_var

_EPS = 1e-12

# Moment channels ahead of the carried totals:
# [w, w*vx, w*vy, w*E[vx^2], w*E[vy^2], w*E[vx*vy],
#  w*E[fx], w*E[fy], w*E[fx^2], w*E[fy^2]]
# where (fx, fy) in [0,1]^2 are SUB-CELL position offsets (distance from
# the -x / -y cell faces, in cell units).  The reference particle carries
# continuous position (erosion.cu:135 `pos += v_step * v_unit`), so a
# deterministic trajectory walks an exact DDA staircase of width <= 1
# cell forever; a closure without position state re-randomizes the exit
# face every round and spreads any non-axis-aligned stream binomially
# (sd ~ sqrt(rounds)/2 cells — measured corr 0.51 vs MC on a tilted
# plane).  Carrying the offset MEANS restores the deterministic
# staircase while reducing EXACTLY to the old dispersed-ensemble split
# when offsets are uniform; carrying the SECOND moments makes the
# distribution width real — shrinking under exit-branch truncation
# (convergent flow focuses), growing as mixture variance under merges —
# instead of the 2*min(m, 1-m) inference that reads a deterministic
# mid-cell offset as a full-width uniform (which re-injects the full
# birth-position step variance every round and plumes a point-source
# stream to ~4x the MC footprint; /tmp one-stream census).
NSTATE = 10

@dataclasses.dataclass(frozen=True)
class CohortClosure:
    """Trace-time closure configuration (hashable; enters jit cache keys
    via `ErosionParams.freeze()` — env toggles alone would NOT, the
    round-3 footgun for in-process variant comparisons).

    Fields (ablation studies: benchmarks/parity.py, RESULTS.md):
      * offsets: route the exit-face split through the carried sub-cell
        position offsets (quadrant-count-based DDA walk; see
        cohort_round). Uniform offsets reduce to the legacy dispersion
        split, so this only changes behavior where the ensemble is
        spatially coherent — which is exactly where the legacy split's
        per-round Bernoulli exit smears thin streams laterally.
      * offstep: offset-conditional crossing-distance moments. The
        legacy stepsize_expected/var assume a UNIFORM within-cell
        position every round — re-injecting Var[dL]*a^2 of velocity
        variance per transit even into a spatially coherent stream;
        that variance ratchet turns a single point-source stream into
        an ~8-cell-wide plume (measured: visit ratio 1.73x, corr 0.39
        vs the MC stream's 1-cell path). With offstep the step moments
        are taken over the CARRIED offset distribution (mean + inferred
        width), which reduces exactly to the legacy formulas for
        uniform offsets (newborns) and collapses Var[dL] -> O(width^2)
        for coherent streams. Only active together with `offsets`.
        Values: True (default) = POOLED per-cell moments from the
        count-mixed wall distances — exact for coherent streams, ~300
        fma-eq/cell-round cheaper; "stream" = per-face-stream moments
        (the round-4 form; the ablation point); False = off.
      * vdist: per-axis velocity marginal family for the directional
        stream decomposition — "gauss" (truncated-Gaussian, the
        default/headline closure) or "uniform" (bounded support; zero
        backward leakage for coherent streams). See _axis_streams.
      * xmom: condition each directional stream's TRANSVERSE velocity
        moments on the stream via the E[vx*vy] cross-moment regression
        (off: streams carry the unconditional transverse moments).
      * perstream: evaluate the step rule and the attenuation physics
        per directional stream — each stream's own crossing distance,
        RMS speed, friction weight and transit factors (off: one shared
        evaluation at the cell's pooled dispersion-weighted direction
        and RMS speed). xmom/perstream default OFF: measured against
        the converged-MC oracle neither moves rough-terrain discharge
        correlation (~0.70 in every variant) and xmom trades mass
        rel_mean for corr; the cross-moment channel is still carried so
        the ablations stay one flag away.
    """

    offsets: bool = True
    offstep: object = True  # True (pooled) | "stream" | False
    vdist: str = "gauss"
    xmom: bool = False
    perstream: bool = False
    # Colored sub-ensembles (quality mode): partition the BIRTHS into
    # `colors` disjoint sub-populations and transport each through its
    # own full moment state, summing deposits.  Transport is linear in
    # sources, so colors > 1 changes no physics — it only refines the
    # mixture representation: the measured residual of the closure is
    # NOT per-stream kinematics (an isolated cohort reproduces the MC
    # stream cell-for-cell, RESULTS.md) but the pooling of CO-LOCATED
    # cohorts from different origins into one 10-moment ensemble
    # (split-ensemble study: warm-noise discharge corr 0.78 at 1 color
    # -> 0.92 at 64).  Cost is ~linear in `colors` (M full solves).
    # `color_rule` assigns births to colors:
    #   * "dir":  by birth-velocity angle sector — separates exactly the
    #     streams that later merge at confluences from different
    #     directions (the mixtures the moment state represents worst).
    #   * "hash": spatial hash of the global birth cell (the
    #     split-ensemble study's partition; origin-decorrelated).
    colors: int = 1
    color_rule: str = "dir"
    # N-node face-routed mixture (quality mode): the state carries
    # `nodes` independent full ensembles per cell and arrivals are
    # routed to a node by ENTRY FACE (nodes=2: x-crossers vs y-crossers;
    # nodes=4: one per face).  Unlike `colors` (a birth partition), this
    # separates exactly the populations the pooled closure represents
    # worst — streams merging at a confluence from different directions
    # — and re-pools them automatically once relaxation aligns their
    # velocities.  State and round cost scale ~linearly with `nodes`.
    # See _cohort_round_nodes.
    nodes: int = 1
    # Node routing rule (nodes=4 only):
    #   * "face" — by ENTRY FACE (the round-4 rule).  Flaw for diagonal
    #     flows: a single coherent diagonal stream alternates x and y
    #     exits along its DDA staircase, so face routing SPLITS one
    #     population across two nodes every round and each half
    #     re-disperses against the other's arrivals.
    #   * "sign" — by VELOCITY SIGN QUADRANT of the arriving
    #     sub-population ([++, +-, -+, --]; requires `offsets`, whose
    #     quadrant exit weights supply the per-face sign split).  A
    #     coherent diagonal stream keeps ALL its arrivals in one node
    #     through both exit faces, while head-on and transverse-sign
    #     confluence partners stay separated until relaxation actually
    #     aligns their velocities.  Round-5 study (RESULTS.md): the
    #     noise mixture metrics the face rule saturates on.
    #   * "cluster" — SIMILARITY routing: each direction's pooled
    #     arrival joins the target node with the nearest current mean
    #     velocity (dead nodes compete with their sign-quadrant
    #     prototype, which seeds the clusters).  The k-means-like
    #     adaptive refinement of "sign"; see _cohort_round_cluster and
    #     the single-origin probe study (RESULTS.md round 5).
    #   * "speed" (nodes=2) — fast/slow components, 1-D speed k-means
    #     on the same machinery (the age-deficit counter-experiment;
    #     measured null — per-face pooling routes slow mass inside
    #     fast-dominated arrivals.  RESULTS.md round 5).
    node_rule: str = "face"


def _env_closure() -> CohortClosure:
    """Process-default closure from the SOIL_COHORT_* env vars (ablation
    back-compat; prefer `ErosionParams.closure` which enters jit keys)."""
    _ost = os.environ.get("SOIL_COHORT_OFFSTEP", "1")
    return CohortClosure(
        offsets=os.environ.get("SOIL_COHORT_OFFSETS", "1") == "1",
        offstep="stream" if _ost == "stream" else _ost == "1",
        vdist=os.environ.get("SOIL_COHORT_VDIST", "gauss"),
        xmom=os.environ.get("SOIL_COHORT_XMOM", "0") == "1",
        perstream=os.environ.get("SOIL_COHORT_PERSTREAM", "0") == "1",
        colors=int(os.environ.get("SOIL_COHORT_COLORS", "1")),
        color_rule=os.environ.get("SOIL_COHORT_COLOR_RULE", "dir"),
        nodes=int(os.environ.get("SOIL_COHORT_NODES", "1")),
        node_rule=os.environ.get("SOIL_COHORT_NODE_RULE", "face"),
    )


ENV_CLOSURE = _env_closure()


# Inferred-width floor for the offset distributions: one-sided-cut
# populations are endpoint-anchored uniforms whose width is exactly
# 2*min(m, 1-m); merged bundles violate that, and the floor keeps a
# residual smoothing so the split never becomes a hard switch on a
# mixture that only LOOKS coherent.
_OFF_WMIN = 0.05


def shift_push(payloads):
    """Zero-boundary directional push: `payloads` = (toward +x, -x, +y,
    -y), each pad + slice shifted one cell along its axis (negative axes
    keep it shape-generic). A `None` payload is a TRACE-TIME zero
    (structurally-empty directions, e.g. the own-axis offset reset
    channels) and contributes neither a shift nor an add."""

    def shift_from(a, dx, dy):
        pad = [(0, 0)] * (a.ndim - 2) + [(max(0, dx), max(0, -dx)),
                                         (max(0, dy), max(0, -dy))]
        ap = jnp.pad(a, pad)
        W, H = a.shape[-2], a.shape[-1]
        x0, y0 = max(0, -dx), max(0, -dy)
        return ap[..., x0:x0 + W, y0:y0 + H]

    pxp, pxn, pyp, pyn = payloads
    terms = []
    if pxp is not None:
        terms.append(shift_from(pxp, +1, 0))
    if pxn is not None:
        terms.append(shift_from(pxn, -1, 0))
    if pyp is not None:
        terms.append(shift_from(pyp, 0, +1))
    if pyn is not None:
        terms.append(shift_from(pyn, 0, -1))
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _norm_cdf(z, gauss):
    """Standard-normal CDF via the Abramowitz-Stegun 7.1.26 rational
    erf approximation (max abs error 1.5e-7 — below f32 noise on the
    stream weights). The goldens (tests/test_golden.py) are pinned to
    this approximation, so swapping in `jax.lax.erf` is a deliberate
    re-pin, not a refactor.

    `gauss` = exp(-z²/2), shared with the caller's phi — the erf
    approximation needs exp(-x²) at x = z/√2, which is the same value,
    so the round's hottest transcendental is computed once."""
    x = jnp.abs(z) * 0.7071067811865476
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * gauss
    erf_z = jnp.sign(z) * erf_abs
    return 0.5 * (1.0 + erf_z)


def _axis_streams(mu, m2, vdist="gauss"):
    """Directional decomposition of a per-axis velocity ensemble with
    mean mu and raw second moment m2 into its positive- and negative-
    going streams.

    Returns (E[v+], E[v-], E[v|v>0], E[v|v<0], E[v^2|v>0], E[v^2|v<0],
    P(v>0)): the half-moment magnitudes that set the outflow split
    weights, plus the conditional moments each stream CARRIES — the
    conditioning is what keeps sub-streams ballistic (a +x-going stream
    arrives still moving +x) instead of re-randomizing into a diffusion
    every round. sigma -> 0 collapses everything onto the deterministic
    single-direction particle.

    Two marginal families (CohortClosure.vdist):
      * "gauss" (default; the headline closure — RESULTS.md):
        truncated-Gaussian conditioning.
      * "uniform": v ~ U[mu - sqrt(3) sigma, mu + sqrt(3) sigma]
        — BOUNDED support.  The reference particle's velocity relaxes
        toward the local gradient (erosion.cu:124-136) and a coherent
        downslope ensemble has NO backward-moving members; the Gaussian
        family leaks Phi(-mu/sigma) backward weight every round, a
        random walk along the flow axis that measurably inflates
        residence time (census: 1.175x total interior deposits at
        evap=0).  For mu > sqrt(3) sigma the uniform family's backward
        weight is exactly 0.  Also transcendental-free (no exp/erf).
    """
    var = jnp.maximum(m2 - mu * mu, 0.0)
    small = var <= 1e-12 * jnp.maximum(m2, _EPS)
    sigma = jnp.where(small, 0.0, jnp.sqrt(jnp.where(small, 1.0, var)))

    if vdist == "uniform":
        # Support [lo, hi], half-width sqrt(3) sigma, length L = hi - lo.
        s3 = 1.7320508075688772 * sigma
        lo, hi = mu - s3, mu + s3
        L = jnp.where(small, 1.0, 2.0 * s3)
        inv_L = 1.0 / jnp.maximum(L, _EPS)
        lo_p, hi_p = jnp.maximum(lo, 0.0), jnp.maximum(hi, 0.0)
        lo_n, hi_n = jnp.minimum(lo, 0.0), jnp.minimum(hi, 0.0)
        Epos = jnp.where(small, jnp.maximum(mu, 0.0),
                         0.5 * (hi_p * hi_p - lo_p * lo_p) * inv_L)
        Eneg = jnp.maximum(Epos - mu, 0.0)
        c_pos = jnp.where(small, mu, 0.5 * (lo_p + hi_p))
        c_neg = jnp.where(small, mu, 0.5 * (lo_n + hi_n))
        third = 1.0 / 3.0
        m2_pos = jnp.where(
            small, m2,
            third * (hi_p * hi_p + hi_p * lo_p + lo_p * lo_p))
        m2_neg = jnp.where(
            small, m2,
            third * (hi_n * hi_n + hi_n * lo_n + lo_n * lo_n))
        P_pos = jnp.where(
            small, jnp.where(mu > 0, 1.0, jnp.where(mu < 0, 0.0, 0.5)),
            jnp.clip(hi * inv_L, 0.0, 1.0))
        return Epos, Eneg, c_pos, c_neg, m2_pos, m2_neg, P_pos

    sigma_s = jnp.where(small, 1.0, sigma)
    # |z| capped at 6: the minority stream's weight is already < 1e-9
    # there (pure noise), and the cap keeps the inverse-Mills residuals
    # (phi/Phi^2 in reverse mode) around 1e18 instead of the 1e40 a
    # 1e-20 floor would leave — margin XLA's reassociation freedom in
    # compiled scans requires (see models/erosion.py _RATE_CLIP).
    z = jnp.clip(mu / sigma_s, -6.0, 6.0)
    gauss = jnp.exp(-0.5 * z * z)
    phi = gauss * 0.3989422804014327
    Phi = jnp.clip(_norm_cdf(z, gauss), 1e-9, 1.0)
    Phn = jnp.clip(1.0 - Phi, 1e-9, 1.0)

    Epos = jnp.where(small, jnp.maximum(mu, 0.0),
                     jnp.maximum(mu * Phi + sigma * phi, 0.0))
    Eneg = jnp.maximum(Epos - mu, 0.0)

    lam_p = phi / Phi
    lam_n = phi / Phn
    c_pos = jnp.where(small, mu, mu + sigma * lam_p)
    c_neg = jnp.where(small, mu, mu - sigma * lam_n)
    m2_pos = jnp.where(small, m2, mu * mu + var + mu * sigma * lam_p)
    m2_neg = jnp.where(small, m2, mu * mu + var - mu * sigma * lam_n)
    # Sign probability P(v > 0) — the COUNT share of the positive-going
    # sub-population (vs Epos/Eneg, the SPEED-weighted shares).  The
    # deterministic branch snaps to {0, 1/2, 1} on sign(mu).
    P_pos = jnp.where(
        small, jnp.where(mu > 0, 1.0, jnp.where(mu < 0, 0.0, 0.5)), Phi
    )
    return Epos, Eneg, c_pos, c_neg, jnp.maximum(m2_pos, 0.0), \
        jnp.maximum(m2_neg, 0.0), P_pos


def _cond_stream(c_own, m2_own, mu_own, mu_t, m2_t, b, var_own):
    """Transverse moments of a directional stream, conditioned on the
    own-axis truncation through the cross-moment regression
    v_t = mu_t + b (v_own - mu_own) + eps, b = cov/var_own.

    Returns (E[v_t|S], E[v_t^2|S], E[v_own*v_t|S]) given the stream's
    own-axis conditional moments (c_own = E[v_own|S], m2_own =
    E[v_own^2|S]). b = None is the xmom-off TRACE-TIME specialization —
    bitwise-identical to b = 0 (every dropped term is exactly +0.0) but
    ~18 fewer elementwise ops per call, and counting multiply-by-
    structural-zero work would also overstate the compute roofline that
    bench.py's vs_baseline divides by. The m2 floor at
    mean² guards against roundoff producing a negative conditional
    variance."""
    if b is None:
        mt = mu_t
        m2t = jnp.maximum(m2_t, mt * mt)
        return mt, m2t, mu_t * c_own
    dmu = c_own - mu_own
    mt = mu_t + b * dmu
    ex2c = m2_own - 2.0 * mu_own * c_own + mu_own * mu_own
    m2t = m2_t + 2.0 * mu_t * b * dmu + b * b * (ex2c - var_own)
    m2t = jnp.maximum(m2t, mt * mt)
    mxyc = mu_t * c_own + b * (m2_own - mu_own * c_own)
    return mt, m2t, mxyc


def _regress_coef(m2_own, var_own, cov):
    """cov/var_own with the deterministic-axis branch zeroed (conditioning
    on a dispersion-free axis is a no-op) — double-where'd for f32
    reverse-mode safety."""
    small = var_own <= 1e-12 * jnp.maximum(m2_own, _EPS)
    return jnp.where(small, 0.0, cov / jnp.where(small, 1.0, var_own))


def _stream_geom(m2_own, m2_t):
    """Per-stream kinematics from the stream's raw second moments:
    (1/RMS-speed, own-axis direction cosine, transverse cosine) with
    u_own² = m2_own / (m2_own + m2_t) — RMS components, exact in the
    deterministic limit.

    Every sqrt/rsqrt is double-where'd: still cells and dead streams hit
    m2 == 0 exactly, where d sqrt(x) = inf and a downstream zero mask
    turns it into 0*inf = NaN in reverse mode (this was the round-3
    all-NaN-gradient regression — the offset-conditional step path is the
    only caller with OFFSETS on). Primals are bitwise unchanged."""
    zo = jnp.maximum(m2_own, 0.0)
    zt = jnp.maximum(m2_t, 0.0)
    s2 = zo + zt
    dead = s2 <= _EPS * _EPS
    inv_s = jnp.where(dead, 1.0 / _EPS,
                      jax.lax.rsqrt(jnp.where(dead, 1.0, s2)))
    zo_z = zo <= 0.0
    zt_z = zt <= 0.0
    u_own = jnp.where(zo_z, 0.0, jnp.sqrt(jnp.where(zo_z, 1.0, zo))) * inv_s
    u_t = jnp.where(zt_z, 0.0, jnp.sqrt(jnp.where(zt_z, 1.0, zt))) * inv_s
    return inv_s, u_own, u_t


def _trunc_step_moments(m, h, a):
    """(E[T], Var[T]) of the per-axis crossing time T = min(g/a, sqrt2)
    with the distance-to-wall g ~ U(max(0, m-h), min(1, m+h)) — the
    offset-conditional generalization of transport.stepsize_expected/
    stepsize_var, to which it reduces exactly at (m, h) = (1/2, 1/2).

    Piecewise closed form via the cap threshold g* = sqrt2*a clipped to
    the support: below g* the time is linear in g, above it the cap
    binds.  All divisions floored (a <= tiny means the axis barely
    moves: g* ~ 0 ends up <= lo, the linear branch weight vanishes, and
    T = sqrt2 exactly — the correct limit)."""
    lo = jnp.maximum(m - h, 0.0)
    hi = jnp.minimum(m + h, 1.0)
    inv_L = 1.0 / jnp.maximum(hi - lo, 1e-6)
    a_s = jnp.maximum(a, 1e-6)
    inv_a = 1.0 / a_s
    gs = jnp.clip(1.4142135623730951 * a_s, lo, hi)
    w_lin = (gs - lo) * inv_L
    w_cap = (hi - gs) * inv_L
    e_lin = 0.5 * (lo + gs) * inv_a
    e2_lin = (gs * gs + gs * lo + lo * lo) * (inv_a * inv_a) * (1.0 / 3.0)
    et = w_lin * e_lin + w_cap * 1.4142135623730951
    et2 = w_lin * e2_lin + w_cap * 2.0
    return et, jnp.maximum(et2 - et * et, 0.0)


def _stream_advance(w1, dL, dvar, ax, ay, mx, my, m2x_, m2y_, mxy_):
    """Post-transit velocity moments of one stream: implicit-Euler
    friction weight w1 on (v + dL*a), with the random-crossing-distance
    variance dvar = Var[dL] injected into the second moments (the
    particle reference's step is random in the birth position; see
    stepsize_var). The cross-moment picks up the SHARED step randomness
    of the two axes: E[(vx+ax dL)(vy+ay dL)] = mxy + dax my + day mx +
    ax ay E[dL²], with E[dL²] = dL² + dvar."""
    dax, day = dL * ax, dL * ay
    w2 = w1 * w1
    vox = w1 * (mx + dax)
    voy = w1 * (my + day)
    m2xo = w2 * (m2x_ + 2.0 * dax * mx + dax * dax + dvar * (ax * ax))
    m2yo = w2 * (m2y_ + 2.0 * day * my + day * day + dvar * (ay * ay))
    mxyo = w2 * (mxy_ + dax * my + day * mx + dax * day + dvar * (ax * ay))
    return vox, voy, m2xo, m2yo, mxyo


def cohort_round(st, G, aux, rules, Llen, push, closure=None):
    """One cohort transit: mix -> particle-state step -> push -> deposit.

    Shared verbatim by the single-device loop and the sharded block
    advance, so the two stay numerically identical.

    The physics per ensemble lives in `_round_payloads`; this assembles
    the pushed arrivals — for the default single-node closure each
    channel's four directional payloads merge into one ensemble; for
    `closure.nodes` in (2, 4) arrivals are routed into separate
    sub-ensembles by ENTRY FACE (see _cohort_round_nodes); for
    `closure.colors` M > 1 the state carries M independent color groups
    (disjoint birth sub-populations batched through one solve — see
    CohortClosure.colors) whose deposits sum and whose ensembles never
    exchange."""
    cl = closure or ENV_CLOSURE
    nnodes = int(getattr(cl, "nodes", 1) or 1)
    ncol = int(getattr(cl, "colors", 1) or 1)
    if ncol > 1:
        import dataclasses as _dc

        P = st.shape[0] // ncol
        cl1 = _dc.replace(cl, colors=1)
        arrs = []
        for j in range(ncol):
            a, G = cohort_round(
                st[j * P:(j + 1) * P], G, aux, rules, Llen, push, cl1,
            )
            arrs.append(a)
        return jnp.concatenate(arrs, axis=0), G
    if nnodes > 1:
        return _cohort_round_nodes(st, G, aux, rules, Llen, push, cl,
                                   nnodes)
    out = [push(t) for t in _round_payloads(st, aux, rules, Llen, cl)]
    arrivals = jnp.stack(out, axis=0)
    return arrivals, G + arrivals[NSTATE:]


def _cohort_round_cluster(st, G, aux, rules, Llen, push, cl, nnodes):
    """k-component mixture with SIMILARITY (online k-means-like) arrival
    routing — `node_rule="cluster"`, nodes=4.

    The single-origin probe (benchmarks/residual_probe.py) shows the
    closure residual on rough terrain is intrinsic to ONE origin's flow
    (self-splitting/merging multi-modality), which no fixed geometric
    routing fully separates: sign-quadrant routing lifts the probe's
    discharge corr 0.643 -> 0.759 but mis-buckets populations whose
    velocities differ WITHIN a quadrant.  Cluster routing instead sends
    each direction's pooled arrival to the target node whose CURRENT
    mean velocity is nearest (squared L2), so components track the
    actual velocity modes present at the cell; dead nodes compete with
    their sign-quadrant PROTOTYPE direction (scaled to the arrival
    speed), which seeds clusters geometrically and lets them adapt once
    alive.  Granularity: arrivals are routed per ENTRY DIRECTION (the
    four face streams, pooled over source nodes) — distinct velocity
    modes at a cell overwhelmingly arrive via different faces.

    Costs ~16% over face routing (4 single-direction pushes replace the
    4-tuple push per channel, plus 4x4 distance masks and the routing
    multiplies); the shifted per-direction channel stack must be
    materialized."""
    S = st.shape[0]
    P = S // nnodes
    speed_mode = getattr(cl, "node_rule", "face") == "speed"
    if speed_mode:
        if nnodes != 2:
            raise ValueError("node_rule='speed' requires nodes=2")
    elif nnodes != 4:
        raise ValueError("node_rule='cluster' requires nodes=4")
    gens = [
        _round_payloads(st[j * P:(j + 1) * P], aux, rules, Llen, cl)
        for j in range(nnodes)
    ]

    def nadd(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    # Per-direction payloads pooled over source nodes, all P channels.
    chans = []
    for ts in zip(*gens):
        xp, xn, yp, yn = ts[0]
        for t in ts[1:]:
            xp = nadd(xp, t[0])
            xn = nadd(xn, t[1])
            yp = nadd(yp, t[2])
            yn = nadd(yn, t[3])
        chans.append((xp, xn, yp, yn))

    def sh1(c, d):
        """Single-direction shift through the push callback (None slots
        are trace-time zeros, so this costs one shift, not four)."""
        if c is None:
            return None
        t = [None] * 4
        t[d] = c
        return push(tuple(t))

    shifted = [[sh1(ch[d], d) for ch in chans] for d in range(4)]

    Z = jnp.zeros_like(st[0])

    def zval(x):
        return Z if x is None else x

    # Target node means from the round-entry state.
    wj = [st[j * P] for j in range(nnodes)]
    live = [w > _EPS for w in wj]
    inv_wj = [1.0 / jnp.maximum(w, _EPS) for w in wj]
    vjx = [st[j * P + 1] * inv_wj[j] for j in range(nnodes)]
    vjy = [st[j * P + 2] * inv_wj[j] for j in range(nnodes)]
    # Sign-quadrant prototype directions ([++, +-, -+, --], unit).
    inv_s2 = 0.7071067811865476
    proto = ((inv_s2, inv_s2), (inv_s2, -inv_s2),
             (-inv_s2, inv_s2), (-inv_s2, -inv_s2))

    masks = []
    for d in range(4):
        wa = zval(shifted[d][0])
        inv_wa = 1.0 / jnp.maximum(wa, _EPS)
        vax = zval(shifted[d][1]) * inv_wa
        vay = zval(shifted[d][2]) * inv_wa
        sa = jnp.sqrt(jnp.maximum(vax * vax + vay * vay, _EPS * _EPS))
        dists = []
        if speed_mode:
            # 1-D speed clustering ([fast, slow]): the age-deficit
            # study's target — pit-trapped slow sub-populations stop
            # pooling into the fast ensemble's RMS speed.  Dead-node
            # seeds: fast = the arrival's own speed (first arrivals
            # land fast), slow = sa/4 (captures arrivals under ~57% of
            # the live fast mean once they appear).
            for j in range(2):
                sj = jnp.sqrt(jnp.maximum(
                    vjx[j] * vjx[j] + vjy[j] * vjy[j], _EPS * _EPS))
                dl = (sa - sj) ** 2
                dd = jnp.square(sa - (sa if j == 0 else 0.25 * sa))
                dists.append(jnp.where(live[j], dl, dd))
        else:
            for j in range(4):
                dl = (vax - vjx[j]) ** 2 + (vay - vjy[j]) ** 2
                px, py = proto[j]
                dd = (vax - sa * px) ** 2 + (vay - sa * py) ** 2
                dists.append(jnp.where(live[j], dl, dd))
        dmin = dists[0]
        for dj in dists[1:]:
            dmin = jnp.minimum(dmin, dj)
        taken = None
        mrow = []
        for j in range(nnodes):
            hit = dists[j] <= dmin
            if taken is not None:
                hit = hit & ~taken
            m = jnp.where(hit, 1.0, 0.0)
            taken = hit if taken is None else (taken | hit)
            mrow.append(m)
        masks.append(mrow)

    # Route every channel's four shifted directions by the masks.
    arr_ch = []
    for j in range(nnodes):
        for c in range(P):
            acc = None
            for d in range(4):
                s = shifted[d][c]
                if s is None:
                    continue
                term = masks[d][j] * s
                acc = term if acc is None else acc + term
            arr_ch.append(Z if acc is None else acc)
    arrivals = jnp.stack(arr_ch, axis=0)

    # Deposits: the masks partition each arrival, so the node sum is
    # just the direction sum of the carried channels.
    dep = []
    for c in range(NSTATE, P):
        acc = None
        for d in range(4):
            s = shifted[d][c]
            if s is None:
                continue
            acc = s if acc is None else acc + s
        dep.append(Z if acc is None else acc)
    return arrivals, G + jnp.stack(dep, axis=0)


def _cohort_round_nodes(st, G, aux, rules, Llen, push, cl, nnodes):
    """N-node mixture transit: the state carries `nnodes` independent
    full ensembles per cell ([node0 moments+carried, node1 ...]) and
    arrivals are routed to a node by the face they entered through —
    nodes=2 separates x-crossers from y-crossers, nodes=4 every face.

    This is the mixture-representation fix the split-ensemble study
    scoped (RESULTS.md): the closure's measured residual is pooling
    CO-LOCATED cohorts from different origins into one 10-moment
    ensemble, and the worst such mixtures are confluences — streams
    merging from DIFFERENT directions.  Face routing keeps exactly those
    populations separate while their velocities differ, and re-pools
    them (into the same entry node) once relaxation has aligned them —
    when pooling is cheap.  Deposits sum over nodes; each node advances
    with the identical single-ensemble physics, so an axis-aligned flow
    (only x faces used) is node-count-invariant to f32 roundoff (the
    quadrant speed floor leaks ~1e-7 of exit weight to the transverse
    faces, which lands in the other node instead of merging back)."""
    S = st.shape[0]
    P = S // nnodes
    rule = getattr(cl, "node_rule", "face")
    if rule in ("cluster", "speed"):
        return _cohort_round_cluster(st, G, aux, rules, Llen, push, cl,
                                     nnodes)
    sign_rule = rule == "sign"
    if sign_rule and nnodes != 4:
        raise ValueError("node_rule='sign' requires nodes=4")
    ratios = [None] * nnodes

    def mk_sink(j):
        def sink(r):
            ratios[j] = r

        return sink

    gens = [
        _round_payloads(st[j * P:(j + 1) * P], aux, rules, Llen, cl,
                        ratio_sink=mk_sink(j) if sign_rule else None)
        for j in range(nnodes)
    ]

    def nadd(a, b):
        """None-aware payload sum (None = trace-time zero)."""
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def nmul(a, r):
        return None if a is None else a * r

    Z = jnp.zeros_like(st[0])

    def pz(t):
        """Push with all-None guarded to a real zero field."""
        return Z if all(p is None for p in t) else push(t)

    outs = [[] for _ in range(nnodes)]
    for ts in zip(*gens):
        if sign_rule:
            # Split every source node's face payloads by its quadrant
            # shares and sum the per-target parts across sources:
            # node order [++, +-, -+, --]; ++ receives the ++ share of
            # every xp payload and the ++ share of every yp payload.
            acc = [[None, None, None, None] for _ in range(4)]
            for j, t in enumerate(ts):
                r = ratios[j]
                txp, txn, typ, tyn = t
                acc[0][0] = nadd(acc[0][0], nmul(txp, r["xp"][0]))
                acc[1][0] = nadd(acc[1][0], nmul(txp, r["xp"][1]))
                acc[2][1] = nadd(acc[2][1], nmul(txn, r["xn"][0]))
                acc[3][1] = nadd(acc[3][1], nmul(txn, r["xn"][1]))
                acc[0][2] = nadd(acc[0][2], nmul(typ, r["yp"][0]))
                acc[2][2] = nadd(acc[2][2], nmul(typ, r["yp"][1]))
                acc[1][3] = nadd(acc[1][3], nmul(tyn, r["yn"][0]))
                acc[3][3] = nadd(acc[3][3], nmul(tyn, r["yn"][1]))
            for k in range(4):
                outs[k].append(pz(tuple(acc[k])))
            continue
        xp, xn, yp, yn = ts[0]
        for t in ts[1:]:
            xp = nadd(xp, t[0])
            xn = nadd(xn, t[1])
            yp = nadd(yp, t[2])
            yn = nadd(yn, t[3])
        if nnodes == 2:
            outs[0].append(pz((xp, xn, None, None)))
            outs[1].append(pz((None, None, yp, yn)))
        elif nnodes == 4:
            outs[0].append(pz((xp, None, None, None)))
            outs[1].append(pz((None, xn, None, None)))
            outs[2].append(pz((None, None, yp, None)))
            outs[3].append(pz((None, None, None, yn)))
        else:
            raise ValueError(f"nodes must be 1, 2 or 4, got {nnodes}")
    arrivals = jnp.stack([c for o in outs for c in o], axis=0)
    dep = jnp.stack(outs[0][NSTATE:], axis=0)
    for j in range(1, nnodes):
        dep = dep + jnp.stack(outs[j][NSTATE:], axis=0)
    return arrivals, G + dep


def _round_payloads(st, aux, rules, Llen, cl, ratio_sink=None):
    """Pre-shift directional payloads of one ensemble's transit round.

    `ratio_sink`, when given, receives (before the first yield) the
    per-face QUADRANT SHARES {face: (share_a, share_b)} — the fraction
    of each face's exit weight belonging to each velocity-sign quadrant
    (xp: ++/+-, xn: -+/--, yp: ++/-+, yn: +-/--) — the split the
    sign-quadrant node routing multiplies into the face payloads
    (requires the offsets closure, whose quadrant exit weights define
    the shares).

    Yields, for each output channel in state-layout order (NSTATE moment
    channels, then the carried-total deposits), the 4-tuple of payloads
    pushed toward (+x, -x, +y, -y).  A generator so the consumer pushes
    each channel as it is produced (never four full stream stacks at
    once).

    The cohort velocity is a Gaussian moment closure — per-axis mean,
    second moments AND the E[vx*vy] cross-moment — because the MC
    ensemble at a cell is velocity-DISPERSED (merged histories,
    cross-valley oscillation, staircase dither). A mean-only cohort
    collapses every stream onto the single steepest line and over-
    concentrates discharge 2-4x in valleys/pits (benchmarks/parity.py);
    splitting the outflow by the expected positive/negative velocity
    parts keeps the dispersion, and merging sums all moments exactly.
    Each directional stream carries truncated-Gaussian conditional
    moments on its own axis; optionally (xmom) cross-moment-regressed
    moments on the transverse axis, and optionally (perstream) its OWN
    crossing distance, RMS speed, friction weight and attenuation
    factors. The physics being modeled is the per-particle trajectory
    loop of erosion.cu:100-136."""
    w = st[0]
    safe_w = jnp.maximum(w, _EPS)
    inv_w = 1.0 / safe_w  # one reciprocal instead of five divides
    vbx, vby = st[1] * inv_w, st[2] * inv_w
    m2x, m2y = st[3] * inv_w, st[4] * inv_w
    mxy = st[5] * inv_w
    carried = st[NSTATE:]
    accel = aux[:2]
    axl, ayl = accel[0], accel[1]

    # RMS speed: non-cancelling (a mean-velocity norm fakes near-zero
    # speeds at convergent cells and exp-overflows the rate physics).
    srms_sq = m2x + m2y
    szero = srms_sq <= 0.0
    sbar = jnp.where(szero, 0.0, jnp.sqrt(jnp.where(szero, 1.0, srms_sq)))
    alive = (sbar >= _EPS) & (w > 0.0) & (aux[2] > 0.0)

    # Directional stream decomposition (split weights + the conditional
    # moments each stream carries).
    Exp, Exn, cxp, cxn, m2xp, m2xn, Pxp = _axis_streams(vbx, m2x, cl.vdist)
    Eyp, Eyn, cyp, cyn, m2yp, m2yn, Pyp = _axis_streams(vby, m2y, cl.vdist)

    if cl.offsets:
        # Quadrant-offset exit routing.  The reference particle crosses
        # exactly ONE cell per round in its current direction
        # (erosion.cu:117-135): the per-round exit flux is COUNT-based
        # (every alive particle exits), and the exit FACE is determined
        # by the sub-cell position — t_x = d_x/|vx| vs t_y = d_y/|vy|,
        # d = distance to the facing wall.  Model: sign-quadrant weights
        # from the per-axis count probabilities, per-quadrant direction
        # magnitudes from the truncated conditional means, offsets as
        # endpoint-anchored uniforms (mean carried, width inferred as
        # 2*min(m, 1-m)).  Uniform offsets (newborns) give P(x-exit) =
        # ux/(ux+uy) — exactly the legacy dispersion split — so the
        # routing only bites where the ensemble is spatially coherent.
        # Work in DISTANCE-TO-WALL coordinates per sign: g = distance
        # (in cell units) to the face the quadrant is moving toward, so
        # all four quadrants share one formula set.  t_x = g_x/|vx|,
        # t_y = g_y/|vy|; x-exit iff g_y*|vx| > g_x*|vy|.
        mfx = jnp.clip(st[6] * inv_w, 0.0, 1.0)
        mfy = jnp.clip(st[7] * inv_w, 0.0, 1.0)
        # Widths from the carried second moments: a uniform with
        # variance v has width sqrt(12 v), additionally bounded by the
        # support constraint 2*min(m, 1-m) (an endpoint-anchored uniform
        # in [0,1] can be no wider), floored at _OFF_WMIN.  The var clip
        # bounds sqrt away from 0 so reverse-mode stays finite.
        vfx = st[8] * inv_w - mfx * mfx
        vfy = st[9] * inv_w - mfy * mfy
        vmin = _OFF_WMIN * _OFF_WMIN / 12.0

        def width(v, m):
            v = jnp.clip(v, vmin, 1.0 / 12.0)
            wv = jnp.sqrt(12.0 * v)
            return jnp.maximum(
                jnp.minimum(wv, 2.0 * jnp.minimum(m, 1.0 - m)), _OFF_WMIN
            )

        gwx = width(vfx, mfx)
        gwy = width(vfy, mfy)

        # Speed floor: quadrants whose conditional speed sits at the
        # floor carry ~zero quadrant weight, so the floor only guards
        # the division.  It must NOT be denormal-small: reverse-mode
        # d(x/u)/du = -x/u^2 overflows f32 at u ~ 1e-20 and the clip's
        # zero cotangent then meets inf as 0*inf = NaN.
        tiny = 1e-6
        uxp_m = jnp.maximum(cxp, tiny)
        uxn_m = jnp.maximum(-cxn, tiny)
        uyp_m = jnp.maximum(cyp, tiny)
        uyn_m = jnp.maximum(-cyn, tiny)
        hwx, hwy = 0.5 * gwx, 0.5 * gwy

        def quadrant(ux_m, uy_m, mgx, mgy):
            """One sign quadrant: (P(x-exit), transverse-g mean and
            variance after an x-exit, own-g mean and variance after a
            y-exit).

            The exit split treats (g_x, g_y) as independent uniforms
            (means + widths carried) — margin A over combined width.
            The pushed offsets are CONDITIONED on the exit branch, each
            variable truncated against the threshold at the PARTNER'S
            MEAN: without the conditioning the pushed transverse mean
            is biased high and the walked slope steepens ~6% on a plane
            (measured).  The truncation is also what lets widths
            SHRINK: convergent exits cut the distribution, so the
            carried variance contracts toward the deterministic DDA
            staircase.  (A joint-margin form that conditions both
            pushed distances on the single margin variable
            M = g_y|vx| - g_x|vy| was tried and REGRESSED coupled noise
            parity mass rel 0.067 -> 0.75: dividing the conditional
            margin mean back by one axis speed misassigns the g_x-side
            variance to the transverse coordinate.)"""
            A = mgy * ux_m - mgx * uy_m
            Wu = gwy * ux_m + gwx * uy_m
            p_x = jnp.clip(0.5 + A / jnp.maximum(Wu, tiny), 0.0, 1.0)
            # x-exit population: g_y > c_y = (uy/ux)*mgx; afterwards the
            # remaining y-distance is g_y - c_y (exact when g_x is at
            # its mean).  The survivor is uniform on [lo_y, mgy + hwy],
            # variance (hi - lo)^2/12, shift-invariant under the -c_y.
            c_y = jnp.minimum(mgx * (uy_m / ux_m), 1.0)
            lo_y = jnp.clip(c_y, mgy - hwy, mgy + hwy)
            gy_c = 0.5 * (lo_y + mgy + hwy)
            gy_out = jnp.clip(gy_c - c_y, 0.0, 1.0)
            v_gy = (mgy + hwy - lo_y) ** 2 * (1.0 / 12.0)
            # y-exit population: g_x > c_x = (ux/uy)*mgy.
            c_x = jnp.minimum(mgy * (ux_m / uy_m), 1.0)
            lo_x = jnp.clip(c_x, mgx - hwx, mgx + hwx)
            gx_c = 0.5 * (lo_x + mgx + hwx)
            gx_out = jnp.clip(gx_c - c_x, 0.0, 1.0)
            v_gx = (mgx + hwx - lo_x) ** 2 * (1.0 / 12.0)
            return p_x, gy_out, gx_out, v_gy, v_gx

        mgx_p, mgx_n = 1.0 - mfx, mfx
        mgy_p, mgy_n = 1.0 - mfy, mfy
        Pxe_pp, gyo_pp, gxo_pp, vy_pp, vx_pp = quadrant(
            uxp_m, uyp_m, mgx_p, mgy_p)
        Pxe_pn, gyo_pn, gxo_pn, vy_pn, vx_pn = quadrant(
            uxp_m, uyn_m, mgx_p, mgy_n)
        Pxe_np, gyo_np, gxo_np, vy_np, vx_np = quadrant(
            uxn_m, uyp_m, mgx_n, mgy_p)
        Pxe_nn, gyo_nn, gxo_nn, vy_nn, vx_nn = quadrant(
            uxn_m, uyn_m, mgx_n, mgy_n)

        Pxn_, Pyn_ = 1.0 - Pxp, 1.0 - Pyp
        a_pp, a_pn = Pxp * Pyp, Pxp * Pyn_
        a_np, a_nn = Pxn_ * Pyp, Pxn_ * Pyn_

        q_pp_x, q_pn_x = a_pp * Pxe_pp, a_pn * Pxe_pn
        q_np_x, q_nn_x = a_np * Pxe_np, a_nn * Pxe_nn
        q_pp_y, q_pn_y = a_pp - q_pp_x, a_pn - q_pn_x
        q_np_y, q_nn_y = a_np - q_np_x, a_nn - q_nn_x

        wxp, wxn = q_pp_x + q_pn_x, q_np_x + q_nn_x
        wyp, wyn = q_pp_y + q_np_y, q_pn_y + q_nn_y

        if ratio_sink is not None:
            def shares(qa, qb, wf):
                """Double-where'd (qa/wf, qb/wf); zero-weight faces emit
                zero payloads, so their shares are irrelevant but must
                stay finite in both modes."""
                z = wf <= 0.0
                inv = jnp.where(z, 0.0, 1.0 / jnp.where(z, 1.0, wf))
                return qa * inv, qb * inv

            ratio_sink({
                "xp": shares(q_pp_x, q_pn_x, wxp),
                "xn": shares(q_np_x, q_nn_x, wxn),
                "yp": shares(q_pp_y, q_np_y, wyp),
                "yn": shares(q_pn_y, q_nn_y, wyn),
            })

        # Pushed f-offsets per face (w-normalized payload factors; they
        # multiply wa below).  Own-axis offset resets to the entry face
        # (0 for +, 1 for -: deterministic, so its second moment is the
        # square); transverse g converts back to f per sign with
        # E[f^2] = mean^2 + branch variance (shift/flip invariant).
        # The structurally-zero payloads (entry at f = 0) are None —
        # trace-time zeros the push skips entirely (no mul/roll/add).
        pay_fx_xp = None
        pay_fx_xn = wxn  # entry at fx = 1
        pay_fy_xp = q_pp_x * (1.0 - gyo_pp) + q_pn_x * gyo_pn
        pay_fy_xn = q_np_x * (1.0 - gyo_np) + q_nn_x * gyo_nn
        pay_fy_yp = None
        pay_fy_yn = wyn  # entry at fy = 1
        pay_fx_yp = q_pp_y * (1.0 - gxo_pp) + q_np_y * gxo_np
        pay_fx_yn = q_pn_y * (1.0 - gxo_pn) + q_nn_y * gxo_nn
        pay_fx2_xp = None
        pay_fx2_xn = wxn
        pay_fy2_xp = (q_pp_x * ((1.0 - gyo_pp) ** 2 + vy_pp)
                      + q_pn_x * (gyo_pn ** 2 + vy_pn))
        pay_fy2_xn = (q_np_x * ((1.0 - gyo_np) ** 2 + vy_np)
                      + q_nn_x * (gyo_nn ** 2 + vy_nn))
        pay_fy2_yp = None
        pay_fy2_yn = wyn
        pay_fx2_yp = (q_pp_y * ((1.0 - gxo_pp) ** 2 + vx_pp)
                      + q_np_y * (gxo_np ** 2 + vx_np))
        pay_fx2_yn = (q_pn_y * ((1.0 - gxo_pn) ** 2 + vx_pn)
                      + q_nn_y * (gxo_nn ** 2 + vx_nn))
    else:
        if ratio_sink is not None:
            raise ValueError(
                "node_rule='sign' requires the offsets closure (the "
                "quadrant exit weights define the sign shares)"
            )
        denom = Exp + Exn + Eyp + Eyn
        inv_denom = 1.0 / jnp.where(denom <= 0.0, 1.0, denom)
        wxp, wxn = Exp * inv_denom, Exn * inv_denom
        wyp, wyn = Eyp * inv_denom, Eyn * inv_denom
        half, third = 0.5, 1.0 / 3.0
        pay_fx_xp, pay_fx_xn = wxp * half, wxn * half
        pay_fy_xp, pay_fy_xn = wxp * half, wxn * half
        pay_fx_yp, pay_fx_yn = wyp * half, wyn * half
        pay_fy_yp, pay_fy_yn = wyp * half, wyn * half
        pay_fx2_xp, pay_fx2_xn = wxp * third, wxn * third
        pay_fy2_xp, pay_fy2_xn = wxp * third, wxn * third
        pay_fx2_yp, pay_fx2_yn = wyp * third, wyn * third
        pay_fy2_yp, pay_fy2_yn = wyp * third, wyn * third

    # Cross-moment regression coefficients (Cauchy-Schwarz-clamped: f32
    # roundoff and the carried clip can push |cov| past sqrt(varx*vary),
    # which would make conditional variances negative).  xmom off: the
    # coefficients are None — the trace-time-zero specialization of
    # _cond_stream (bitwise-identical, no mul-by-zero work).
    if cl.xmom:
        varx = jnp.maximum(m2x - vbx * vbx, 0.0)
        vary = jnp.maximum(m2y - vby * vby, 0.0)
        prod = varx * vary
        pzero = prod <= 0.0
        lim = jnp.where(
            pzero, 0.0, 0.99 * jnp.sqrt(jnp.where(pzero, 1.0, prod))
        )
        cov = jnp.clip(mxy - vbx * vby, -lim, lim)
        bx = _regress_coef(m2x, varx, cov)
        by = _regress_coef(m2y, vary, cov)
    else:
        varx = vary = None
        bx = by = None

    # Transverse moments of each stream (unconditional when bx=by=0).
    my_xp, m2y_xp, mxy_xp = _cond_stream(cxp, m2xp, vbx, vby, m2y, bx, varx)
    my_xn, m2y_xn, mxy_xn = _cond_stream(cxn, m2xn, vbx, vby, m2y, bx, varx)
    mx_yp, m2x_yp, mxy_yp = _cond_stream(cyp, m2yp, vby, vbx, m2x, by, vary)
    mx_yn, m2x_yn, mxy_yn = _cond_stream(cyn, m2yn, vby, vbx, m2x, by, vary)

    aux_tail = aux[3:]
    if cl.perstream:
        def stream_phys(m2_own, m2_t, own_is_x):
            inv_s, u_own, u_t = _stream_geom(m2_own, m2_t)
            u2 = (u_own, u_t) if own_is_x else (u_t, u_own)
            stp = stepsize_expected(*u2)
            dL_s = stp * Llen
            if cl.offsets and cl.offstep:
                dvar_s = None  # replaced wholesale by the offstep block
            else:
                dvar_s = (Llen * Llen) * stepsize_var(*u2)
            w1_s, facs_s = rules(dL_s, inv_s, safe_w, carried, u2, aux_tail)
            return dL_s, dvar_s, w1_s, facs_s

        ph_xp = stream_phys(m2xp, m2y_xp, True)
        ph_xn = stream_phys(m2xn, m2y_xn, True)
        ph_yp = stream_phys(m2x_yp, m2yp, False)
        ph_yn = stream_phys(m2x_yn, m2yn, False)
    else:
        # One shared evaluation at the pooled dispersion-weighted
        # direction (E|v| axis shares) and pooled RMS speed.
        ax = Exp + Exn
        ay = Eyp + Eyn
        inv_an = jax.lax.rsqrt(jnp.maximum(ax * ax + ay * ay, _EPS * _EPS))
        ux = ax * inv_an
        uy = ay * inv_an
        step = stepsize_expected(ux, uy)
        dL = step * Llen
        if cl.offsets and cl.offstep:
            # The offstep block below replaces (dL, dvar) wholesale —
            # tracing stepsize_var here would be dead code XLA DCEs but
            # the compute roofline would still count.
            dvar = None
        else:
            dvar = (Llen * Llen) * stepsize_var(ux, uy)
        inv = 1.0 / jnp.maximum(sbar, _EPS)
        w1, facs = rules(dL, inv, safe_w, carried, (ux, uy), aux_tail)
        ph_xp = ph_xn = ph_yp = ph_yn = (dL, dvar, w1, facs)

    if cl.offsets and cl.offstep:
        # Offset-conditional step moments (CohortClosure.offstep): the rules
        # evaluation (attenuation/friction) above keeps its shared
        # kinematics; only the (dL, Var[dL]) fed to the velocity advance
        # are refined over the CARRIED offset distribution, killing the
        # per-round variance ratchet that plumes coherent streams.  The
        # transverse wall distance mixes the two sign populations by
        # their count shares (the same independence the quadrant exit
        # split assumes).
        mty = Pyp * mgy_p + (1.0 - Pyp) * mgy_n
        mtx = Pxp * mgx_p + (1.0 - Pxp) * mgx_n

        if cl.offstep == "stream":
            # Per-face-stream moments (the round-4 form; ~400 fma-eq/
            # cell-round): each of the four exit streams gets its own
            # conditional wall-distance/direction kinematics.
            def off_step(m_own, m_t, m2_own, m2_t, h_own, h_t):
                _, u_own, u_t = _stream_geom(m2_own, m2_t)
                et_o, vt_o = _trunc_step_moments(m_own, h_own, u_own)
                et_t, vt_t = _trunc_step_moments(m_t, h_t, u_t)
                dL_s = 0.5 * (et_o + et_t) * Llen
                dvar_s = 0.25 * (vt_o + vt_t) * (Llen * Llen)
                return dL_s, dvar_s

            ph_xp = off_step(mgx_p, mty, m2xp, m2y_xp, hwx, hwy) + ph_xp[2:]
            ph_xn = off_step(mgx_n, mty, m2xn, m2y_xn, hwx, hwy) + ph_xn[2:]
            ph_yp = off_step(mgy_p, mtx, m2yp, m2x_yp, hwy, hwx) + ph_yp[2:]
            ph_yn = off_step(mgy_n, mtx, m2yn, m2x_yn, hwy, hwx) + ph_yn[2:]
        else:
            # POOLED moments (default; the round-5 op-diet): one
            # (dL, Var[dL]) per cell from the count-mixed wall distances
            # — mtx/mty ARE exactly the count mixtures of the per-sign
            # distances — and RMS direction cosines from the
            # unconditional second moments (= the count mixture of the
            # per-stream conditionals, by the law of total expectation).
            # For a COHERENT stream (one sign carries ~all count weight)
            # the mixture equals that stream's own geometry, so the
            # variance-ratchet kill that offstep exists for (the 4x MC
            # plume fix) is preserved exactly; for dispersed ensembles
            # uniform offsets make every variant collapse to the legacy
            # formulas.  Only genuinely bidirectional cells with
            # coherent off-center offsets (pit oscillation) see the
            # pooling, at ~300 fewer ops/cell-round (bench.py
            # _count_ops).  Parity: the coupled nets in
            # tests/test_erosion.py hold at the same levels, goldens
            # re-pinned (tools/gen_goldens.py) — see RESULTS.md round 5.
            _, ux_r, uy_r = _stream_geom(m2x, m2y)
            et_x, vt_x = _trunc_step_moments(mtx, hwx, ux_r)
            et_y, vt_y = _trunc_step_moments(mty, hwy, uy_r)
            dL_o = 0.5 * (et_x + et_y) * Llen
            dvar_o = 0.25 * (vt_x + vt_y) * (Llen * Llen)
            ph_xp = (dL_o, dvar_o) + ph_xp[2:]
            ph_xn = (dL_o, dvar_o) + ph_xn[2:]
            ph_yp = (dL_o, dvar_o) + ph_yp[2:]
            ph_yn = (dL_o, dvar_o) + ph_yn[2:]

    # Post-transit moments per stream (each at its own kinematics).
    adv_xp = _stream_advance(ph_xp[2], ph_xp[0], ph_xp[1], axl, ayl,
                             cxp, my_xp, m2xp, m2y_xp, mxy_xp)
    adv_xn = _stream_advance(ph_xn[2], ph_xn[0], ph_xn[1], axl, ayl,
                             cxn, my_xn, m2xn, m2y_xn, mxy_xn)
    adv_yp = _stream_advance(ph_yp[2], ph_yp[0], ph_yp[1], axl, ayl,
                             mx_yp, cyp, m2x_yp, m2yp, mxy_yp)
    adv_yn = _stream_advance(ph_yn[2], ph_yn[0], ph_yn[1], axl, ayl,
                             mx_yn, cyn, m2x_yn, m2yn, mxy_yn)

    wa = jnp.where(alive, w, 0.0)

    # CHANNEL-WISE payload emission: each output channel's four
    # directional payloads are built (and pushed by the consumer)
    # independently — never the four (S, W, H) stream stacks at once.
    wxp_a, wxn_a = wa * wxp, wa * wxn
    wyp_a, wyn_a = wa * wyp, wa * wyn

    yield (wxp_a, wxn_a, wyp_a, wyn_a)
    # adv_* = (vox, voy, m2xo, m2yo, mxyo) per stream, in push order.
    for q in range(5):
        yield (wxp_a * adv_xp[q], wxn_a * adv_xn[q],
               wyp_a * adv_yp[q], wyn_a * adv_yn[q])
    # Sub-cell offset moments (w-weighted; pay_* already carry the face
    # weight factor, so they multiply the ALIVE-masked total weight wa).
    def wmul(p):
        return None if p is None else wa * p

    yield (wmul(pay_fx_xp), wmul(pay_fx_xn), wmul(pay_fx_yp),
           wmul(pay_fx_yn))
    yield (wmul(pay_fy_xp), wmul(pay_fy_xn), wmul(pay_fy_yp),
           wmul(pay_fy_yn))
    yield (wmul(pay_fx2_xp), wmul(pay_fx2_xn),
           wmul(pay_fx2_yp), wmul(pay_fx2_yn))
    yield (wmul(pay_fy2_xp), wmul(pay_fy2_xn),
           wmul(pay_fy2_yp), wmul(pay_fy2_yn))

    # Carried-channel deposits: per-stream per-CLASS attenuated weights
    # (alive-masked), folded once per class and reused across channels.
    classes = getattr(rules, "classes", None)
    if classes is None:
        classes = tuple(range(len(carried)))
    nk = (max(classes) + 1) if len(classes) else 0
    zero = jnp.zeros_like(w)
    wxp_z = jnp.where(alive, wxp, zero)
    wxn_z = jnp.where(alive, wxn, zero)
    wyp_z = jnp.where(alive, wyp, zero)
    wyn_z = jnp.where(alive, wyn, zero)
    fw = [
        (wxp_z * ph_xp[3][k], wxn_z * ph_xn[3][k],
         wyp_z * ph_yp[3][k], wyn_z * ph_yn[3][k])
        for k in range(nk)
    ]
    for c, k in zip(carried, classes):
        fxp, fxn, fyp, fyn = fw[k]
        # Clip AFTER the carried*factor product: growth factors are
        # bounded (expected_exp_step clips exponents), so the product
        # can saturate to inf but never NaN, and the clip restores the
        # ±1e30 carried ceiling before arrivals merge.
        yield (
            jnp.clip(c * fxp, -1e30, 1e30),
            jnp.clip(c * fxn, -1e30, 1e30),
            jnp.clip(c * fyp, -1e30, 1e30),
            jnp.clip(c * fyn, -1e30, 1e30),
        )


def as_stack(x):
    """(S, W, H) array from a channel sequence (identity for arrays)."""
    if isinstance(x, (list, tuple)):
        return jnp.stack([jnp.asarray(c, jnp.float32) for c in x], axis=0)
    return jnp.asarray(x)


def n_deposits(S, closure=None):
    """Deposit-channel count C of an S-channel cohort state: the state
    holds `closure.colors * closure.nodes` independent ensembles of
    (NSTATE moments + C carried) — color groups batch the quality-mode
    birth partition through ONE solve, node groups the
    face-routed mixture; deposits sum over all of them."""
    cl = closure or ENV_CLOSURE
    nnodes = int(getattr(cl, "nodes", 1) or 1)
    ncol = int(getattr(cl, "colors", 1) or 1)
    per, rem = divmod(S, nnodes * ncol)
    if rem or per <= NSTATE:
        raise ValueError(
            f"cohort state of {S} channels is not {ncol} colors x "
            f"{nnodes} nodes of NSTATE={NSTATE} moments + carried totals"
        )
    return per - NSTATE


def carried_live(ST, closure=None):
    """Per-deposit-channel live carried mass: sum over ensembles (nodes)
    and cells of |carried|, (C,) float32.

    For CONTRACTIVE rules (every transit factor <= 1 — declared via
    `rules.contractive`, e.g. the fluvial physics whose attenuation
    rates are clamped non-negative), each round deposits at most the
    arriving carried totals and carried mass never grows, so
    `carried_live(ST) * rounds_remaining` bounds the tail of the
    deposit sum; the adaptive solves stop when that bound drops below
    `tol` of the accumulated deposits (f32-roundoff-equivalent to the
    full fixed depth; see cohort_advance_reference).  For NON-contractive rules
    (debris: the suspension factor exceeds 1 above the yield-stress
    balance, so carried mass can GROW between rounds) the bound is
    invalid and `tail_converged` instead requires live == 0 exactly —
    rigorous for any physics, since dead cohorts emit nothing — which
    the debris solve reaches in practice: its velocity-decay rheology
    collapses cohort speed, the alive mask kills the cohort, and its
    state is overwritten by (zero) arrivals.  The reference runs its
    trajectory loop to the fixed maxage bound instead (erosion.cu:101)
    — there dead particles are idle threads, here a dead ROUND is a
    full-cost pass over the state, which is why the faithful-depth
    default wants the exit."""
    S = ST.shape[0]
    C = n_deposits(S, closure)
    P = NSTATE + C
    ngroups = S // P
    live = None
    for j in range(ngroups):
        blk = ST[j * P + NSTATE:(j + 1) * P]
        s = jnp.sum(jnp.abs(blk), axis=(1, 2))
        live = s if live is None else live + s
    return live


def deposit_gauge(G):
    """Per-channel deposit magnitude gauge, (C,) float32 (see
    carried_live)."""
    return jnp.sum(jnp.abs(G), axis=(1, 2))


def tail_converged(live, gauge, remaining_rounds, tol, contractive=False):
    """True once the solve provably cannot add more than tol of the
    accumulated deposits (replicated scalar; psum live/gauge first
    under shard_map).

    contractive=True (rules declare every transit factor <= 1): the
    live*remaining bound applies.  False (default — safe for arbitrary
    user rules, required for debris whose suspension factor can exceed
    1): exit only when live carried mass is exactly zero, which bounds
    the tail at zero for any physics (see carried_live)."""
    if contractive:
        rem = jnp.asarray(remaining_rounds, jnp.float32)
        return jnp.all(live * rem <= jnp.float32(tol) * gauge)
    return jnp.all(live <= 0.0)


def cohort_advance_reference(st0, aux, rules, iters, Llen, *, closure=None,
                             tol=0.0):
    """jnp fallback: one padded push per round (exact, no blocking).
    Returns (advanced state, deposits).  `tol` > 0 adds the per-round
    convergence exit (see carried_live)."""
    st0 = as_stack(st0)
    aux = as_stack(aux)
    C = n_deposits(st0.shape[0], closure)
    G0 = jnp.zeros((C,) + st0.shape[1:], st0.dtype)

    if tol and tol > 0.0:
        contractive = bool(getattr(rules, "contractive", False))

        def cond(carry):
            i, st, G = carry
            live = carried_live(st, closure)
            return (i < iters) & ~tail_converged(
                live, deposit_gauge(G), jnp.float32(iters) - i, tol,
                contractive,
            )

        def body(carry):
            i, st, G = carry
            st, G = cohort_round(st, G, aux, rules, Llen, shift_push,
                                 closure)
            return i + 1.0, st, G

        _, st, G = jax.lax.while_loop(
            cond, body, (jnp.float32(0.0), st0, G0)
        )
        return st, G

    def body(_, carry):
        st, G = carry
        return cohort_round(st, G, aux, rules, Llen, shift_push, closure)

    return jax.lax.fori_loop(0, int(iters), body, (st0, G0))


def run_cohort(st0, aux, rules, iters, Llen, closure=None, tol=0.0):
    """Single-device cohort solve -> deposits."""
    return cohort_advance_reference(st0, aux, rules, int(iters), Llen,
                                    closure=closure, tol=tol)[1]
