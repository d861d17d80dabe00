"""Colored quality-mode solves.

`closure.colors = M` partitions births into M disjoint sub-populations
whose deposits sum (CohortClosure.colors).  The model solves the colours
one after another (models/erosion.py `_run_cohort_colored`); the cohort
round can also carry all M colour groups as extra channel groups of one
state.  These tests pin the two forms equal to f32 roundoff, through the
reference path, the K-blocked sharded solve, and the full transport
entry point.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import soillib_tpu as soil
from soillib_tpu.ops.cohort import CohortClosure

from tests.test_sweep import _cohort_problem


@pytest.fixture(scope="module")
def mesh():
    from soillib_tpu import parallel as par

    return par.make_mesh()  # (2, 4) over the conftest's 8 cpu devices


def _colored_state(st0, M):
    """Split a single-ensemble state into M disjoint spatial-hash color
    groups (channel concat; every channel carries a w factor)."""
    W, H = st0.shape[1:]
    cell = (jnp.arange(W)[:, None] * 7 + jnp.arange(H)[None, :] * 13) % M
    return jnp.concatenate(
        [st0 * (cell == j)[None] for j in range(M)], axis=0
    ), [(cell == j) for j in range(M)]


@pytest.mark.parametrize("M", [2, 4])
def test_batched_colors_match_looped_reference(M):
    from soillib_tpu.ops.cohort import cohort_advance_reference

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(7), 2, 48, 40)
    stc, masks = _colored_state(st0, M)
    cl = CohortClosure(colors=M)
    _, g_b = cohort_advance_reference(stc, aux, rules, 12, 0.11,
                                      closure=cl)
    cl1 = dataclasses.replace(cl, colors=1)
    g_l = None
    for m in masks:
        _, g = cohort_advance_reference(st0 * m[None], aux, rules, 12,
                                        0.11, closure=cl1)
        g_l = g if g_l is None else g_l + g
    np.testing.assert_allclose(np.asarray(g_b), np.asarray(g_l),
                               rtol=2e-6, atol=1e-6)


def test_batched_colors_sharded_matches_reference(mesh):
    """The K-blocked sharded solve advances the color-wide state
    identically to the per-round reference (deposit contract,
    multi-pass)."""
    from soillib_tpu.ops.cohort import cohort_advance_reference

    from tests.test_sweep import sharded_cohort

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(8), 2, 72, 64)
    stc, _ = _colored_state(st0, 2)
    cl = CohortClosure(colors=2)
    _, g_w = cohort_advance_reference(stc, aux, rules, 21, 0.11, closure=cl)
    g_s = sharded_cohort(mesh, stc, aux, rules, 21, closure=cl)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_w),
                               rtol=2e-5, atol=1e-5)


def test_debris_closure_strips_quality_knobs():
    """Default: the debris transport strips nodes/colors from the
    quality closure (its parity already sits at the MC floor single-
    ensemble), so a quality run == quality-fluvial + default-debris;
    closureDebris='same' restores the verbatim closure."""
    import soillib_tpu.models.erosion as ero

    p = soil.ErosionParams()
    p.closure = CohortClosure(nodes=4, colors=2)
    cd = ero._debris_closure(p)
    assert cd.nodes == 1 and cd.colors == 1
    assert cd.offsets == p.closure.offsets

    p.closureDebris = "same"
    assert ero._debris_closure(p) is p.closure

    explicit = CohortClosure(nodes=2)
    p.closureDebris = explicit
    assert ero._debris_closure(p) is explicit

    p2 = soil.ErosionParams()
    assert ero._debris_closure(p2) is None

    # End-to-end: a quality-closure debris transport equals the
    # default-closure debris transport exactly (same stripped closure).
    h = soil.noise((32, 32), soil.noise_t(seed=4.0, ext=(32, 32)))
    st = soil.ErosionState.zeros((32, 32), height=1.0 + 0.3 * h)
    pq = soil.ErosionParams()
    pq.transportIterations = 8
    pq.closure = CohortClosure(nodes=4, colors=2)
    pd = soil.ErosionParams()
    pd.transportIterations = 8
    args = (st.layers, st.mass, st.momentum, st.albedo_surface,
            (0.1, 0.1, 1.0))
    out_q = soil.transport_debris(*args, pq)
    out_d = soil.transport_debris(*args, pd)
    for a, b in zip(out_q, out_d):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_transport_fluvial_colors_batched_equals_looped():
    """The full fluvial transport with a colored closure: the model's
    colour-by-colour scan == one solve of the batched colour-group
    state, forced by monkeypatching `_run_cohort_colored`."""
    import soillib_tpu.models.erosion as ero

    h = soil.noise((40, 40), soil.noise_t(seed=2.0, ext=(40, 40)))
    state = soil.ErosionState.zeros((40, 40), height=1.0 + 0.3 * h)
    p = soil.ErosionParams()
    p.transportIterations = 12
    p.closure = CohortClosure(colors=4, color_rule="dir")
    args = (state.layers, state.rainfall, state.discharge, state.mass,
            state.momentum, state.albedo_surface, (0.1, 0.1, 1.0), p)

    out_l = soil.transport_fluvial(*args)

    orig = ero._run_cohort_colored

    def batched(halo, w0, speed, carried0, aux, rules, iters, Llen,
                closure, tol=0.0):
        M = int(getattr(closure, "colors", 1) or 1)
        if M <= 1:
            return orig(halo, w0, speed, carried0, aux, rules, iters,
                        Llen, closure, tol)
        chans = ()
        for mk in ero._color_masks(M, closure.color_rule, speed, w0.shape,
                                   halo):
            chans += ero._build_cohort_state(w0 * mk, speed,
                                             [c * mk for c in carried0],
                                             closure)
        return halo.run_cohort(chans, aux, rules, iters, Llen, closure,
                               tol=tol)

    ero._run_cohort_colored = batched
    try:
        out_b = soil.transport_fluvial(*args)
    finally:
        ero._run_cohort_colored = orig

    for b, l, name in zip(out_b, out_l,
                          ("discharge", "mass", "momentum", "albedo")):
        np.testing.assert_allclose(np.asarray(b), np.asarray(l),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
