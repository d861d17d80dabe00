"""Convergence-adaptive transport depth (ops/cohort.py carried_live).

The reference runs its particle trajectory loop to the fixed `maxage`
bound (erosion.cu:101) — there dead particles are idle threads, but
here every dead ROUND of the cohort sweep is a full-cost pass over the
state.  The adaptive exit (tol > 0) stops once the remaining-deposit
bound (live carried mass x rounds remaining) falls below tol of the
accumulated deposits per channel, which must (a) reproduce the fixed
full-depth solve to f32 roundoff and (b) actually exit early on
configurations whose cohorts die long before the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_sweep import _cohort_problem

TOL = 1e-6


@pytest.fixture(scope="module")
def mesh():
    from soillib_tpu import parallel as par

    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    return par.make_mesh()  # (2, 4)


def _exit_round(st0, aux, rules, iters, Llen, tol):
    """First round at which the adaptive criterion fires (eager probe of
    the exact while_loop condition)."""
    from soillib_tpu.ops.cohort import (
        carried_live,
        cohort_round,
        deposit_gauge,
        n_deposits,
        shift_push,
        tail_converged,
    )

    C = n_deposits(st0.shape[0])
    contractive = bool(getattr(rules, "contractive", False))
    st, G = st0, jnp.zeros((C,) + st0.shape[1:], st0.dtype)
    for i in range(iters):
        if bool(tail_converged(carried_live(st), deposit_gauge(G),
                               iters - i, tol, contractive)):
            return i
        st, G = cohort_round(st, G, aux, rules, Llen, shift_push)
    return iters


def test_adaptive_reference_matches_fixed_depth():
    """tol=1e-6 full-depth solve == fixed full-depth solve (f32 roundoff)
    AND the criterion fires well before the Manhattan-style bound."""
    from soillib_tpu.ops.cohort import cohort_advance_reference

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(3), 3, 48, 40)
    iters = 88  # W + H: the faithful path.cu:200-style bound
    _, g_fix = cohort_advance_reference(st0, aux, rules, iters, 0.11)
    _, g_ad = cohort_advance_reference(st0, aux, rules, iters, 0.11,
                                       tol=TOL)
    np.testing.assert_allclose(np.asarray(g_ad), np.asarray(g_fix),
                               rtol=2e-6, atol=1e-6)

    exit_at = _exit_round(st0, aux, rules, iters, 0.11, TOL)
    assert exit_at < iters // 2, (
        f"adaptive exit at round {exit_at}/{iters} — criterion never "
        f"bit on a config whose cohorts decay at rate >= 0.1/round"
    )


def test_adaptive_never_exits_early_on_growing_rules():
    """Non-contractive rules (growth factors > 1, the debris suspension
    regime) must NOT use the live*remaining bound — it is invalid when
    carried mass grows between rounds (code-review finding, round 5).
    Without `rules.contractive` the exit requires live == 0 exactly, so
    a config whose carried mass GROWS keeps full fixed depth and stays
    equivalent."""
    from soillib_tpu.ops.cohort import cohort_advance_reference

    st0, aux, rules0 = _cohort_problem(jax.random.PRNGKey(9), 2, 32, 32)

    def rules(dL, inv, w, carried, unit2, aux_tail):
        w1 = 1.0 / (1.0 + 0.05 * dL)
        fac = jnp.full_like(dL, 1.15)  # sustained growth regime
        return w1, (fac,)

    rules.classes = (0, 0)
    # NO rules.contractive: defaults to the strict live == 0 criterion.
    iters = 40
    _, g_fix = cohort_advance_reference(st0, aux, rules, iters, 0.11)
    _, g_ad = cohort_advance_reference(st0, aux, rules, iters, 0.11,
                                       tol=TOL)
    np.testing.assert_allclose(np.asarray(g_ad), np.asarray(g_fix),
                               rtol=2e-6, atol=1e-6)

    # The eager probe confirms the strict criterion never fires while
    # carried mass is still alive and growing.
    exit_at = _exit_round(st0, aux, rules, iters, 0.11, TOL)
    from soillib_tpu.ops.cohort import carried_live
    # live goes exactly to zero only when every cohort has left the
    # domain; on a 32x32 grid with drifting velocities that can happen
    # before 40 rounds — equivalence above is the real assertion, and
    # any early exit must coincide with exact-zero live.
    if exit_at < iters:
        st, G = st0, None
        from soillib_tpu.ops.cohort import cohort_round, n_deposits, \
            shift_push
        C = n_deposits(st0.shape[0])
        G = jnp.zeros((C,) + st0.shape[1:], st0.dtype)
        from soillib_tpu.ops.cohort import NSTATE

        for _ in range(exit_at):
            st, G = cohort_round(st, G, aux, rules, 0.11, shift_push)
        assert float(jnp.sum(jnp.abs(st[NSTATE:]))) == 0.0


def test_adaptive_matches_fixed_510_rounds():
    """The literal reference-faithful depth: auto(tol) == fixed-510 to
    f32 roundoff (maxage 512 -> 510 deposit rounds, erosion.cu:101) on
    a test grid."""
    from soillib_tpu.ops.cohort import cohort_advance_reference

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(6), 2, 32, 32)
    _, g_fix = cohort_advance_reference(st0, aux, rules, 510, 0.11)
    _, g_ad = cohort_advance_reference(st0, aux, rules, 510, 0.11,
                                       tol=TOL)
    np.testing.assert_allclose(np.asarray(g_ad), np.asarray(g_fix),
                               rtol=2e-6, atol=1e-6)
    exit_at = _exit_round(st0, aux, rules, 510, 0.11, TOL)
    assert exit_at <= 160, f"adaptive ran {exit_at}/510 rounds"


def test_adaptive_kblocked_matches_fixed_depth(mesh):
    """The K-blocked solve's pass-granular while_loop (+ lax.cond tail
    skip) == the fixed-depth per-round reference, including a
    non-multiple-of-K remainder."""
    from soillib_tpu.ops.cohort import cohort_advance_reference

    from tests.test_sweep import sharded_cohort

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(4), 2, 72, 64)
    iters = 53  # 3 full K=16 passes + remainder 5
    _, g_fix = cohort_advance_reference(st0, aux, rules, iters, 0.11)
    g_ad = sharded_cohort(mesh, st0, aux, rules, iters, tol=TOL)
    np.testing.assert_allclose(np.asarray(g_ad), np.asarray(g_fix),
                               rtol=2e-5, atol=1e-5)


def test_adaptive_sharded_matches_fixed(mesh):
    """ShardHalo.run_cohort with tol (psum'd replicated exit decision)
    == the fixed-depth sharded solve on the 8-virtual-device mesh."""
    from jax import shard_map as smap
    from soillib_tpu.parallel.halo import ShardHalo
    from soillib_tpu.parallel.mesh import grid_spec

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(5), 2, 64, 64)
    iters = 40
    sh = ShardHalo(mesh.devices.shape, mesh.axis_names)
    spec = grid_spec(mesh)
    sspec = jax.sharding.PartitionSpec(None, *spec)

    def run(tol):
        def local(st, ax):
            return sh.run_cohort(st, ax, rules, iters, 0.11, tol=tol)

        return smap(local, mesh=mesh, in_specs=(sspec, sspec),
                    out_specs=sspec, check_vma=False)(st0, aux)

    g_fix = run(0.0)
    g_ad = run(TOL)
    np.testing.assert_allclose(np.asarray(g_ad), np.asarray(g_fix),
                               rtol=2e-5, atol=1e-5)


def test_adaptive_full_sharded_step_matches_single_device(mesh):
    """transportTol through make_sharded_erode_fn (the whole coupled
    step under shard_map, K-blocked exchange + psum'd exit decision) ==
    the single-device adaptive step."""
    from soillib_tpu import parallel as par
    from soillib_tpu.models.simulation import erode_step
    from soillib_tpu.ops.sweep import HALO_K

    px, py = mesh.devices.shape
    W, H = px * 2 * HALO_K, py * 2 * HALO_K
    import soillib_tpu as soil

    h = soil.noise((W, H), soil.noise_t(seed=3.0)) * 0.5 + 1.0
    state = soil.ErosionState.zeros((W, H), height=h)
    p = soil.ErosionParams()
    p.maxage = HALO_K * 2 + 6  # adaptive bound; K-blocked + remainder
    p.transportTol = 1e-6
    scale = (0.078, 0.078, 4.0)

    sharded = par.shard_state(state, mesh)
    step = par.make_sharded_erode_fn(mesh, scale, p, steps=1)
    out = step(sharded, jax.random.PRNGKey(0))
    ref = jax.jit(lambda s, k: erode_step(s, scale, p, k))(
        state, jax.random.PRNGKey(0)
    )
    for name in ("layers", "discharge", "momentum", "mass"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(ref, name)),
            rtol=1e-4, atol=1e-5, err_msg=name,
        )


def test_adaptive_erosion_step_matches_fixed():
    """transportTol through the full coupled model: a 2-step erode at
    faithful depth with tol == without, to f32 roundoff, on a terrain
    whose transport dies well before maxage-2."""
    import soillib_tpu as soil

    h = soil.noise((48, 48), soil.noise_t(seed=7.0, ext=(48, 48)))
    state = soil.ErosionState.zeros((48, 48), height=1.0 + 0.2 * h)
    scale = (0.1, 0.1, 1.0)

    def run(tol):
        p = soil.ErosionParams()
        p.maxage = 98  # faithful default depth = maxage-2 = 96 = W+H
        p.transportTol = tol
        return soil.erode(state, scale, p, steps=2)

    s_fix = run(0.0)
    s_ad = run(TOL)
    np.testing.assert_allclose(np.asarray(s_ad.height),
                               np.asarray(s_fix.height),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_ad.discharge),
                               np.asarray(s_fix.discharge),
                               rtol=1e-4, atol=1e-5)
