"""Transport sweeps: the K-blocked sharded solves vs the per-round oracle.

`ShardHalo.run_transport` / `run_cohort` advance K = HALO_K rounds
block-locally between K-wide halo exchanges (the trapezoid argument of
ops/sweep.py); they must reproduce the per-round single-device iteration
(`transport_sweep_reference` / `cohort_advance_reference`). Runs on the
conftest's 8 virtual CPU devices as a (2, 4) mesh; every grid here gives
blocks at least HALO_K wide, so the K-blocked path — not the per-round
fallback — is what executes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from soillib_tpu.ops.sweep import (
    HALO_K,
    transport_sweep_reference,
    upwind_push_cf,
)
from soillib_tpu.ops.transport import upwind_push


@pytest.fixture(scope="module")
def mesh():
    from soillib_tpu import parallel as par

    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    return par.make_mesh()  # (2, 4)


def _kblocked(mesh, shape):
    px, py = mesh.devices.shape
    W, H = shape
    assert W % px == 0 and H % py == 0
    assert W // px >= HALO_K and H // py >= HALO_K, "would take per-round path"


def sharded_transport(mesh, E, att, vx, vy, iters):
    from soillib_tpu.parallel.halo import ShardHalo

    _kblocked(mesh, E.shape[1:])
    sh = ShardHalo(mesh.devices.shape, mesh.axis_names)
    s2 = P(*mesh.axis_names)
    s3 = P(None, *mesh.axis_names)
    return jax.jit(shard_map(
        lambda e, a, x, y: sh.run_transport(e, a, x, y, iters),
        mesh=mesh, in_specs=(s3, s3, s2, s2), out_specs=s3, check_vma=False,
    ))(E, att, vx, vy)


def sharded_cohort(mesh, st0, aux, rules, iters, closure=None, tol=0.0):
    from soillib_tpu.parallel.halo import ShardHalo

    _kblocked(mesh, st0.shape[1:])
    sh = ShardHalo(mesh.devices.shape, mesh.axis_names)
    s3 = P(None, *mesh.axis_names)
    return jax.jit(shard_map(
        lambda st, ax: sh.run_cohort(st, ax, rules, iters, 0.11,
                                     closure=closure, tol=tol),
        mesh=mesh, in_specs=(s3, s3), out_specs=s3, check_vma=False,
    ))(st0, aux)


def _problem(key, C, W, H):
    k1, k2, k3 = jax.random.split(key, 3)
    E = jnp.abs(jax.random.normal(k1, (C, W, H)))
    att = jax.random.uniform(k2, (C, W, H), minval=0.3, maxval=0.99)
    d = jax.random.normal(k3, (2, W, H))
    n = jnp.maximum(jnp.sqrt(d[0] ** 2 + d[1] ** 2), 1e-30)
    return E, att, d[0] / n, d[1] / n


def test_push_cf_matches_channel_last():
    """upwind_push_cf (solver layout) == upwind_push (public layout)."""
    E, att, vx, vy = _problem(jax.random.PRNGKey(3), 4, 40, 56)
    payload = att * E
    dirs = jnp.stack([vx, vy], axis=-1)
    want = upwind_push(jnp.moveaxis(payload, 0, -1), dirs)
    got = jnp.moveaxis(upwind_push_cf(payload, vx, vy), 0, -1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("iters", [1, 8, 16, 23])
def test_sweep_matches_reference_small(mesh, iters):
    """Sub-K, exactly-K and K + remainder round counts."""
    E, att, vx, vy = _problem(jax.random.PRNGKey(0), 3, 64, 80)
    want = transport_sweep_reference(E, att, vx, vy, iters)
    got = sharded_transport(mesh, E, att, vx, vy, iters)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-6, atol=1e-5
    )


def test_sweep_matches_reference_multitile(mesh):
    """Large blocks in both dims + a remainder-rounds pass (iters=19)."""
    E, att, vx, vy = _problem(jax.random.PRNGKey(1), 2, 420, 300)
    want = transport_sweep_reference(E, att, vx, vy, 19)
    got = sharded_transport(mesh, E, att, vx, vy, 19)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-6, atol=1e-5
    )


def test_sweep_zero_flow_is_zero(mesh):
    """Dead cells (zero direction) neither emit nor receive."""
    W = H = 64
    E = jnp.ones((1, W, H))
    att = jnp.full((1, W, H), 0.9)
    z = jnp.zeros((W, H))
    got = sharded_transport(mesh, E, att, z, z, 8)
    np.testing.assert_array_equal(np.asarray(got), 0.0)


def test_sweep_outflow_lost_at_boundary(mesh):
    """Uniform +x flow: mass leaves the domain, never wraps around, and
    crosses block seams intact."""
    W = H = 64
    E = jnp.ones((1, W, H))
    att = jnp.ones((1, W, H))
    vx, vy = jnp.ones((W, H)), jnp.zeros((W, H))
    got = np.asarray(sharded_transport(mesh, E, att, vx, vy, 20))
    want = np.asarray(transport_sweep_reference(E, att, vx, vy, 20))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # Row x receives sum of E from rows x-20..x-1 -> row 0 gets nothing.
    assert got[0, 0].max() == 0.0
    np.testing.assert_allclose(got[0, -1], 20.0, rtol=1e-6)


def test_sweep_large_channel_count_matches_reference(mesh):
    """A wide channel stack (16) through the K-blocked exchange."""
    E, att, vx, vy = _problem(jax.random.PRNGKey(5), 16, 64, 64)
    got = sharded_transport(mesh, E, att, vx, vy, 9)
    want = transport_sweep_reference(E, att, vx, vy, 9)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-6, atol=1e-5)


def test_sharded_sweep_grad_matches_reference_grad(mesh):
    """Reverse mode through the K-blocked exchange (ppermute transposes
    to the opposite shift) == the plain gradient of the per-round fixed
    point, over two full passes and a remainder."""
    E, att, vx, vy = _problem(jax.random.PRNGKey(6), 3, 64, 64)
    g_sh = jax.grad(
        lambda e: sharded_transport(mesh, e, att, vx, vy, 37).sum()
    )(E)
    g_ref = jax.grad(
        lambda e: transport_sweep_reference(e, att, vx, vy, 37).sum()
    )(E)
    np.testing.assert_allclose(np.asarray(g_sh), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)


def _cohort_problem(key, C, W, H):
    """Random cohort state/aux with a debris-like rules callback."""
    ks = jax.random.split(key, 6)
    w0 = jnp.abs(jax.random.normal(ks[0], (W, H))) + 0.5
    speed0 = jax.random.normal(ks[1], (2, W, H)) * 3.0
    carried0 = jnp.abs(jax.random.normal(ks[2], (C, W, H)))
    accel = jax.random.normal(ks[3], (2, W, H))
    excess = jax.random.normal(ks[4], (W, H))
    mask = jnp.ones((1, W, H))
    aux = jnp.concatenate([accel, mask, excess[None]], axis=0)
    st0 = jnp.concatenate(
        [jnp.stack([w0, w0 * speed0[0], w0 * speed0[1],
                    w0 * speed0[0] ** 2, w0 * speed0[1] ** 2,
                    w0 * speed0[0] * speed0[1],
                    w0 * 0.5, w0 * 0.5,
                    w0 * (1.0 / 3.0), w0 * (1.0 / 3.0)], axis=0),
         carried0], axis=0)

    def rules(dL, inv, w, carried, unit2, aux_tail):
        from soillib_tpu.ops.transport import expected_exp_step

        ux, uy = unit2
        decay = 0.1 + jnp.abs(aux_tail[0])
        w1 = 1.0 / (1.0 + dL * decay)
        fac = expected_exp_step(ux, uy, -decay * inv)
        return w1, (fac,)

    rules.classes = (0,) * C
    rules.contractive = True  # decay >= 0.1 -> every factor <= 1
    return st0, aux, rules


def _node_split(st0, masks):
    return jnp.concatenate(
        [st0 * jnp.where(m, 1.0, 0.0)[None] for m in masks], axis=0
    )


def _sign_masks(st0):
    vx = st0[1] / st0[0]
    vy = st0[2] / st0[0]
    return [(vx >= 0) & (vy >= 0), (vx >= 0) & (vy < 0),
            (vx < 0) & (vy >= 0), (vx < 0) & (vy < 0)]


@pytest.mark.parametrize("iters", [1, 16, 21, 48])
def test_cohort_sharded_matches_reference(mesh, iters):
    """K-blocked sharded cohort solve == per-round reference on the
    DEPOSITS (the output contract), including multi-pass + remainder.
    Rounds-deep surviving cohorts are near-dead (w ~ 1e-5) and their
    state is chaotic under f32 reassociation without affecting any
    deposit above tolerance, so only deposits are compared."""
    from soillib_tpu.ops.cohort import cohort_advance_reference

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(0), 3, 72, 64)
    _, g_w = cohort_advance_reference(st0, aux, rules, iters, 0.11)
    g_s = sharded_cohort(mesh, st0, aux, rules, iters)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_w),
                               rtol=2e-5, atol=1e-5)


def test_cohort_sharded_multitile(mesh):
    """Large blocks in both dims."""
    from soillib_tpu.ops.cohort import cohort_advance_reference

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(1), 2, 420, 300)
    _, g_w = cohort_advance_reference(st0, aux, rules, 9, 0.11)
    g_s = sharded_cohort(mesh, st0, aux, rules, 9)
    # rtol 2e-5: the nonlinear round body (expm1/exp MGF chain) fuses in
    # a different order per compilation context; ~1e-5 rel noise on O(1)
    # deposits after 9 rounds is f32 reassociation, not structure.
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_w),
                               rtol=2e-5, atol=1e-5)


def test_cohort_sharded_cluster_nodes_matches_reference(mesh):
    """Similarity (cluster) node routing through the K-blocked exchange
    == the per-round reference (deposit contract, multi-pass)."""
    from soillib_tpu.ops.cohort import CohortClosure, cohort_advance_reference

    closure = CohortClosure(nodes=4, node_rule="cluster")
    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(4), 2, 72, 64)
    stn = _node_split(st0, _sign_masks(st0))
    _, g_w = cohort_advance_reference(stn, aux, rules, 21, 0.11,
                                      closure=closure)
    g_s = sharded_cohort(mesh, stn, aux, rules, 21, closure=closure)
    assert g_w.shape[0] == 2
    assert np.isfinite(np.asarray(g_w)).all()
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_w),
                               rtol=2e-5, atol=1e-5)


def test_cohort_sharded_speed_nodes_matches_reference(mesh):
    """Fast/slow speed-split routing (node_rule='speed', nodes=2) through
    the K-blocked exchange == the reference; the slow component
    accumulates weight from slow arrivals."""
    from soillib_tpu.ops.cohort import CohortClosure, cohort_advance_reference

    closure = CohortClosure(nodes=2, node_rule="speed")
    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(5), 2, 72, 64)
    stn = jnp.concatenate([st0, jnp.zeros_like(st0)], axis=0)
    st_w, g_w = cohort_advance_reference(stn, aux, rules, 21, 0.11,
                                         closure=closure)
    g_s = sharded_cohort(mesh, stn, aux, rules, 21, closure=closure)
    assert g_w.shape[0] == 2
    assert float(jnp.sum(st_w[st0.shape[0]])) > 0.0  # slow node seeded
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_w),
                               rtol=2e-5, atol=1e-5)


def test_cohort_sharded_sign_nodes_matches_reference(mesh):
    """Sign-quadrant node routing (node_rule='sign') through the
    K-blocked exchange == the reference."""
    from soillib_tpu.ops.cohort import CohortClosure, cohort_advance_reference

    closure = CohortClosure(nodes=4, node_rule="sign")
    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(3), 2, 72, 64)
    stn = _node_split(st0, _sign_masks(st0))
    _, g_w = cohort_advance_reference(stn, aux, rules, 21, 0.11,
                                      closure=closure)
    g_s = sharded_cohort(mesh, stn, aux, rules, 21, closure=closure)
    assert g_w.shape[0] == 2
    assert np.isfinite(np.asarray(g_w)).all()
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_w),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("nnodes", [2, 4])
def test_cohort_sharded_nodes_matches_reference(mesh, nnodes):
    """The face-routed N-node mixture (CohortClosure.nodes) through the
    K-blocked exchange == the reference, and the deposit stack keeps C
    channels (n_deposits) while the state carries nodes*(NSTATE+C)."""
    from soillib_tpu.ops.cohort import CohortClosure, cohort_advance_reference

    closure = CohortClosure(nodes=nnodes)
    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(2), 2, 72, 64)
    vx = st0[1] / st0[0]
    vy = st0[2] / st0[0]
    isx = jnp.abs(vx) >= jnp.abs(vy)
    if nnodes == 2:
        masks = [isx, ~isx]
    else:
        masks = [isx & (vx >= 0), isx & (vx < 0),
                 ~isx & (vy >= 0), ~isx & (vy < 0)]
    stn = _node_split(st0, masks)
    _, g_w = cohort_advance_reference(stn, aux, rules, 21, 0.11,
                                      closure=closure)
    g_s = sharded_cohort(mesh, stn, aux, rules, 21, closure=closure)
    assert g_w.shape[0] == 2 and g_s.shape == g_w.shape
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_w),
                               rtol=2e-5, atol=1e-5)


def test_run_cohort_is_the_reference_solve():
    """The single-device solve is the per-round loop on every backend."""
    from soillib_tpu.ops.cohort import cohort_advance_reference, run_cohort

    st0, aux, rules = _cohort_problem(jax.random.PRNGKey(7), 2, 24, 20)
    want = cohort_advance_reference(st0, aux, rules, 5, 0.11)[1]
    got = run_cohort(st0, aux, rules, 5, 0.11)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("module", [
    "soillib_tpu/ops/cohort.py", "soillib_tpu/ops/sweep.py",
    "soillib_tpu/ops/graph.py", "soillib_tpu/ops/graph_tiled.py",
    "soillib_tpu/models/erosion.py", "soillib_tpu/parallel/halo.py",
])
def test_no_dispatch_on_backend_name(module):
    """No solver picks its path by the backend's name or runs Pallas in
    interpret mode: what runs on the card is what the tests run."""
    import os
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(repo, module)).read()
    assert not re.search(
        r"default_backend\(\)|\.platform\s*[!=]=|interpret\s*=|pallas",
        src), module
