"""Sharded execution == single-device execution (SURVEY.md §4 item 3).

Runs on 8 virtual CPU devices (conftest.py). The sharded stencil/transport
ops must match the single-device ops *bitwise* (identical arithmetic after
halo pads); the global-graph ops run GSPMD-partitioned and must match too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import soillib_tpu as soil
from soillib_tpu import parallel as par

SCALE3 = (0.5, 0.7, 2.0)
SCALE2 = (0.5, 0.7)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    return par.make_mesh()  # (2, 4)


@pytest.fixture(scope="module")
def height():
    key = jax.random.PRNGKey(7)
    return jax.random.normal(key, (32, 48), jnp.float32) * 3.0


def _assert_same(a, b, bitwise=True):
    a, b = np.asarray(a), np.asarray(b)
    if bitwise:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_mesh_factorization():
    assert par.factor2(8) == (2, 4)
    assert par.factor2(16) == (4, 4)
    assert par.factor2(7) == (1, 7)


def test_halo_pad_matches_global_pad(mesh, height):
    """pad(fill) inside shard_map reproduces global jnp.pad semantics."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    halo = par.ShardHalo(mesh.devices.shape, mesh.axis_names)
    spec = par.grid_spec(mesh)

    def local(x):
        p = halo.pad(x, 0.0)
        return halo.crop(p)  # identity if pad/crop are consistent

    out = jax.jit(
        shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    )(height)
    _assert_same(out, height)


def test_halo_shift_parity(mesh, height):
    """A shifted read through the halo equals the global shifted read."""
    from jax import shard_map
    from soillib_tpu.ops.stencil import _shift

    halo = par.ShardHalo(mesh.devices.shape, mesh.axis_names)
    spec = par.grid_spec(mesh)

    for dx, dy in [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, 1)]:
        def local(x, dx=dx, dy=dy):
            return halo.crop(_shift(halo.pad(x, jnp.nan), dx, dy, jnp.nan))

        out = jax.jit(
            shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec,
                      check_vma=False)
        )(height)
        _assert_same(out, _shift(height, dx, dy, jnp.nan))


def test_sharded_gradient(mesh, height):
    _assert_same(
        par.ops.gradient(height, SCALE2, mesh), soil.gradient(height, SCALE2),
        bitwise=False,
    )


def test_sharded_negslope(mesh, height):
    _assert_same(
        par.ops.negslope(height, SCALE2, mesh), soil.negslope(height, SCALE2),
        bitwise=False,
    )


def test_sharded_laplacian(mesh, height):
    _assert_same(
        par.ops.laplacian(height, SCALE2, mesh), soil.laplacian(height, SCALE2),
        bitwise=False,
    )


def test_sharded_normal(mesh, height):
    _assert_same(par.ops.normal(height, SCALE3, mesh), soil.normal(height, SCALE3),
                 bitwise=False)


def test_sharded_blur(mesh):
    # blocks are 32x32 on the (2, 4) mesh -> >= the 16-cell window
    h = jax.random.normal(jax.random.PRNGKey(3), (64, 128), jnp.float32)
    _assert_same(
        par.ops.gaussian_blur(h, 4.0, mesh), soil.gaussian_blur(h, 4.0),
        bitwise=False,
    )


def test_sharded_steepest(mesh, height):
    _assert_same(par.ops.steepest(height, soil.d8, mesh=mesh),
                 soil.steepest(height, soil.d8))
    _assert_same(par.ops.steepest(height, soil.d4, mesh=mesh),
                 soil.steepest(height, soil.d4))


def test_sharded_direction(mesh, height):
    _assert_same(par.ops.direction(height, soil.d8, mesh=mesh),
                 soil.direction(height, soil.d8))


def test_sharded_random_weighted(mesh, height):
    """Same (seed, offset) -> same global draw -> identical graph."""
    got = par.ops.random_weighted(height, soil.d8, seed=5, offset=9, T=2.0,
                                  mesh=mesh)
    want = soil.random_weighted(height, soil.d8, seed=5, offset=9, T=2.0)
    _assert_same(got, want)


def test_sharded_solve_uniform(mesh):
    key = jax.random.PRNGKey(1)
    W, H = 32, 48
    flow = jax.random.normal(key, (W, H, 2), jnp.float32)
    source = jnp.abs(jax.random.normal(jax.random.fold_in(key, 1), (W, H)))
    decay = jnp.full((W, H), 0.05, jnp.float32)
    got = par.ops.solve_uniform(flow, source, decay, SCALE2, mesh=mesh,
                                iterations=40)
    want = soil.solve_uniform(flow, source, decay, SCALE2, method="field",
                              iterations=40)
    _assert_same(got, want, bitwise=False)


def test_accumulate_gspmd(mesh, height):
    """Global pointer-doubling accumulation on sharded inputs (GSPMD)."""
    flow = soil.steepest(height, soil.d8)
    rain = jnp.ones_like(height)
    want = soil.accumulate(flow, rain, soil.d8)
    flow_s = par.shard_field(flow, mesh)
    rain_s = par.shard_field(rain, mesh)
    got = jax.jit(lambda f, r: soil.accumulate(f, r, soil.d8))(flow_s, rain_s)
    _assert_same(got, want, bitwise=False)


def test_sharded_erosion_step_matches_single_device(mesh):
    """The north-star parity property: one coupled erosion step, sharded
    over 8 devices, equals the single-device step.

    Terrain slopes are kept in the physical range (~3 m/m): beyond the
    debris yield balance the cohort rheology is exponentially unstable
    (as is the reference's per-particle attenuation, erosion.cu:344-346),
    where 1-ulp reassociation differences amplify chaotically and no
    cross-schedule comparison is meaningful — that regime is covered by
    test_erosion_extreme_terrain_stays_finite instead.

    ONE step at tight tolerance: a structural halo/data-movement bug
    shows up macroscopically within the first step's transport rounds,
    while XLA's cross-program reassociation freedom only seeds ulp-level
    noise (measured 3e-7 after step 1).  Multi-step trajectories are NOT
    tightly comparable across schedules: the default offset-routed
    cohort closure has exit-face thresholds with slope ~1/width (the
    reference particle's exit face is exactly discontinuous in position,
    erosion.cu:117-135), so ulp seeds amplify ~1e4x per coupled step;
    test_sharded_erosion_multistep_integrals below guards that regime
    with schedule-robust integral metrics."""
    W, H = 32, 48
    key = jax.random.PRNGKey(0)
    hgt = 2.0 + 0.02 * jax.random.normal(key, (W, H), jnp.float32)
    state = soil.ErosionState.zeros((W, H), height=hgt)
    param = soil.ErosionParams()
    param.transportIterations = 12
    scale = (0.08, 0.08, 4.0)

    k = jax.random.PRNGKey(42)
    want = soil.erode(state, scale, param, steps=1, key=k)

    got = par.sharded_erode(state, mesh, scale, param, steps=1, key=k)

    for f in ("layers", "discharge", "mass", "momentum", "debris",
              "debris_momentum", "albedo_surface"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            rtol=1e-4, atol=1e-5, err_msg=f,
        )


def test_sharded_erosion_quality_closure_matches_single_device(mesh):
    """The quality-mode closure (face-routed mixture nodes + colored
    birth sub-ensembles, hash rule exercising halo.global_offsets under
    shard_map) keeps the single-step sharded-vs-single-device parity of
    the test above."""
    from soillib_tpu.ops.cohort import CohortClosure

    W, H = 32, 48
    key = jax.random.PRNGKey(0)
    hgt = 2.0 + 0.02 * jax.random.normal(key, (W, H), jnp.float32)
    state = soil.ErosionState.zeros((W, H), height=hgt)
    param = soil.ErosionParams()
    param.transportIterations = 12
    param.closure = CohortClosure(nodes=2, colors=2, color_rule="hash")
    scale = (0.08, 0.08, 4.0)

    k = jax.random.PRNGKey(42)
    want = soil.erode(state, scale, param, steps=1, key=k)
    got = par.sharded_erode(state, mesh, scale, param, steps=1, key=k)

    for f in ("layers", "discharge", "mass", "momentum", "debris",
              "debris_momentum", "albedo_surface"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            rtol=1e-4, atol=1e-5, err_msg=f,
        )


def test_sharded_erosion_multistep_integrals(mesh):
    """Multi-step sharded-vs-single-device guard: per-cell values diverge
    chaotically (see the docstring above), but integral/statistical
    properties of the trajectory must stay schedule-independent — total
    eroded volume, total discharge, and the field cross-correlation."""
    W, H = 32, 48
    key = jax.random.PRNGKey(0)
    hgt = 2.0 + 0.02 * jax.random.normal(key, (W, H), jnp.float32)
    state = soil.ErosionState.zeros((W, H), height=hgt)
    param = soil.ErosionParams()
    param.transportIterations = 12
    scale = (0.08, 0.08, 4.0)

    k = jax.random.PRNGKey(42)
    want = soil.erode(state, scale, param, steps=3, key=k)
    got = par.sharded_erode(state, mesh, scale, param, steps=3, key=k)

    for f in ("discharge", "mass", "momentum", "debris"):
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        assert abs(a.sum() - b.sum()) <= 1e-3 * max(abs(b.sum()), 1e-12), f
        sa, sb = a - a.mean(), b - b.mean()
        denom = np.sqrt((sa * sa).sum() * (sb * sb).sum())
        if denom > 0:
            corr = float((sa * sb).sum() / denom)
            assert corr >= 0.999, (f, corr)
    # Height change is the slowest (most contractive) field: per-cell.
    np.testing.assert_allclose(
        np.asarray(got.layers), np.asarray(want.layers),
        rtol=1e-3, atol=1e-6, err_msg="layers",
    )


def test_sharded_erosion_actually_sharded(mesh):
    """The output really is block-decomposed on the mesh (not replicated)."""
    W, H = 32, 48
    state = soil.ErosionState.zeros((W, H), height=jnp.ones((W, H)))
    param = soil.ErosionParams()
    param.transportIterations = 4
    got = par.sharded_erode(state, mesh, (0.1, 0.1, 1.0), param, steps=1)
    shard_shapes = {s.data.shape for s in got.discharge.addressable_shards}
    assert shard_shapes == {(W // 2, H // 4)}


def test_sharded_transport_kblocked(mesh):
    """Blocks wider than HALO_K take the temporally-blocked exchange path
    (one K-halo ppermute per K rounds) — must match single-device."""
    from soillib_tpu.ops.sweep import HALO_K
    W, H = 64, 96  # blocks (32, 24) on the (2, 4) mesh: >= HALO_K
    assert W // 2 >= HALO_K and H // 4 >= HALO_K
    key = jax.random.PRNGKey(2)
    flow = jax.random.normal(key, (W, H, 2), jnp.float32)
    source = jnp.abs(jax.random.normal(jax.random.fold_in(key, 1), (W, H)))
    decay = jnp.full((W, H), 0.05, jnp.float32)
    got = par.ops.solve_uniform(flow, source, decay, SCALE2, mesh=mesh,
                                iterations=40)
    want = soil.solve_uniform(flow, source, decay, SCALE2, method="field",
                              iterations=40)
    _assert_same(got, want, bitwise=False)


def test_sharded_erosion_kblocked(mesh):
    """Full erosion step through the K-blocked transport exchange (sane
    slopes — see test_sharded_erosion_step_matches_single_device)."""
    W, H = 64, 96
    key = jax.random.PRNGKey(0)
    hgt = 2.0 + 0.02 * jax.random.normal(key, (W, H), jnp.float32)
    state = soil.ErosionState.zeros((W, H), height=hgt)
    param = soil.ErosionParams()
    param.transportIterations = 20  # K + remainder path
    scale = (0.08, 0.08, 4.0)
    k = jax.random.PRNGKey(42)
    want = soil.erode(state, scale, param, steps=1, key=k)
    got = par.sharded_erode(state, mesh, scale, param, steps=1, key=k)
    for f in ("layers", "discharge", "mass", "momentum", "debris"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            rtol=1e-4, atol=1e-5, err_msg=f,
        )


def test_distributed_accumulate(mesh):
    """Block-local contraction + global boundary-graph combine ==
    single-device accumulation (with and without decay)."""
    key = jax.random.PRNGKey(13)
    W, H = 64, 96
    h = soil.fill_depressions(
        jax.random.normal(key, (W, H)) * 3.0 + jnp.linspace(0, 5, W)[:, None]
    )
    rain = jnp.abs(jax.random.normal(jax.random.fold_in(key, 1), (W, H))) + 0.1
    for edge in (soil.d4, soil.d8):
        flow = soil.steepest(h, edge)
        want = soil.accumulate(flow, rain, edge, method="doubling")
        got = par.graph.accumulate(flow, rain, edge, mesh=mesh)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-4, err_msg=f"edge={edge}")
        decay = jnp.full((W, H), 0.98)
        want = soil.accumulate_decay(flow, rain, decay, edge, method="doubling")
        got = par.graph.accumulate(flow, rain, edge, mesh=mesh, decay=decay)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-4,
                                   err_msg=f"decay edge={edge}")


def _particle_problem():
    W, H = 32, 48
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    yy, xx = jnp.meshgrid(jnp.arange(H), jnp.arange(W))
    flow = jnp.stack(
        [1.0 + 0.3 * jnp.sin(yy / 7.0), 0.4 * jnp.cos(xx / 9.0)], axis=-1
    ).astype(jnp.float32)
    source = jnp.abs(jax.random.normal(k1, (W, H))).astype(jnp.float32)
    decay = 0.05 + 0.02 * jax.random.uniform(k2, (W, H))
    return flow, source, decay, (0.5, 0.5), k3


def test_sharded_particles_bitwise_on_single_block():
    """Cross-block particle migration (parallel/particles.py): on a 1x1
    mesh the whole machinery — global birth draws, ownership take,
    non-wrapping edge kills — reduces BITWISE to the single-device MC
    estimator."""
    from soillib_tpu.ops.transport import _solve_particles
    from soillib_tpu.parallel.particles import solve_particles_sharded

    flow, source, decay, scale, key = _particle_problem()
    N = 8000
    ref = _solve_particles(flow, source, decay, scale, N, key,
                           maxstep=flow.shape[0] + flow.shape[1])
    mesh1 = par.make_mesh(
        (1, 1), devices=np.array(jax.devices()[:1]).reshape(1, 1)
    )
    got, dropped = solve_particles_sharded(
        flow, source, decay, scale, N, key, mesh1, slack=2.0
    )
    assert int(dropped) == 0
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_sharded_particles_migration_parity(mesh):
    """2x4-mesh particle estimator vs single-device: identical particle
    set, ppermute migration across block seams; agreement is statistical —
    corr >= 0.999, total mass to f32 roundoff, zero capacity drops —
    because the deposit cell floor(pos) is discontinuous and 1-ulp
    cross-program reassociation flips near-threshold crossings
    (measured corr 0.9998 / mass rel 6e-6 at 20k particles; the module
    docstring documents the chaos class)."""
    from soillib_tpu.ops.transport import _solve_particles
    from soillib_tpu.parallel.particles import solve_particles_sharded

    flow, source, decay, scale, key = _particle_problem()
    N = 20000
    ref = np.asarray(
        _solve_particles(flow, source, decay, scale, N, key,
                         maxstep=flow.shape[0] + flow.shape[1])
    )
    got, dropped = solve_particles_sharded(
        flow, source, decay, scale, N, key, mesh, slack=2.0
    )
    got = np.asarray(got)
    assert int(dropped) == 0
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.999
    np.testing.assert_allclose(got.sum(), ref.sum(), rtol=1e-4)
    assert np.abs(got - ref).mean() / np.abs(ref).mean() < 0.01


def test_sharded_fluvial_particles(mesh):
    """Distributional MC fluvial transport at mesh scale
    (parallel.fluvial_particles_sharded): bitwise == the single-device
    estimator on a 1x1 mesh; statistical parity with conserved positive
    channels on the 2x4 mesh (signed momentum channels shift a few %
    under the documented trajectory chaos)."""
    from soillib_tpu.models.erosion import _fluvial_particles
    from soillib_tpu.models.simulation import erode_step
    from soillib_tpu.parallel.particles import fluvial_particles_sharded

    W = H = 32
    h = 2.0 + 0.3 * jax.random.normal(jax.random.PRNGKey(0), (W, H))
    p = soil.ErosionParams()
    p.transportIterations = 8
    p.maxage = 40
    p.nSamples = 12000
    st = soil.ErosionState.zeros((W, H), height=h)
    sc = (0.078, 0.078, 4.0)
    for i in range(3):
        st = erode_step(st, sc, p, jax.random.PRNGKey(i))
    k = jax.random.PRNGKey(99)
    args = (st.layers, st.rainfall, st.discharge, st.momentum,
            st.albedo_surface, sc, p, k)
    ref = np.asarray(_fluvial_particles(*args))

    mesh1 = par.make_mesh(
        (1, 1), devices=np.array(jax.devices()[:1]).reshape(1, 1)
    )
    got1, d1 = fluvial_particles_sharded(*args, mesh1, slack=2.0)
    assert int(d1) == 0
    np.testing.assert_array_equal(np.asarray(got1), ref)

    got8, d8 = fluvial_particles_sharded(*args, mesh, slack=2.0)
    got8 = np.asarray(got8)
    assert int(d8) == 0
    for c in (0, 1, 2, 3):  # water, mass, momentum
        assert np.corrcoef(got8[..., c].ravel(),
                           ref[..., c].ravel())[0, 1] >= 0.99, c
    # Positive-channel conservation (water): total flux to ~1e-3.
    np.testing.assert_allclose(got8[..., 0].sum(), ref[..., 0].sum(),
                               rtol=5e-3)


def test_sharded_debris_particles(mesh):
    """Sharded debris MC (parallel.debris_particles_sharded): bitwise
    on 1x1; on 2x4 the short-range debris trajectories reproduce the
    single-device mass deposits near-exactly (physical-slope terrain —
    the rheology is exponentially unstable beyond the yield balance,
    like the reference, so steep random terrain is excluded here as in
    test_sharded_erosion_step_matches_single_device)."""
    from soillib_tpu.models.erosion import _debris_particles
    from soillib_tpu.models.simulation import erode_step
    from soillib_tpu.parallel.particles import debris_particles_sharded

    W = H = 32
    h = 2.0 + 0.04 * jax.random.normal(jax.random.PRNGKey(0), (W, H))
    p = soil.ErosionParams()
    p.transportIterations = 8
    p.maxage = 40
    p.nSamples = 12000
    st = soil.ErosionState.zeros((W, H), height=h)
    sc = (0.078, 0.078, 4.0)
    for i in range(3):
        st = erode_step(st, sc, p, jax.random.PRNGKey(i))
    k = jax.random.PRNGKey(99)
    args = (st.layers, st.mass, st.momentum, st.albedo_surface, sc, p, k)
    ref = np.asarray(_debris_particles(*args))
    assert np.isfinite(ref).all()

    mesh1 = par.make_mesh(
        (1, 1), devices=np.array(jax.devices()[:1]).reshape(1, 1)
    )
    got1, d1 = debris_particles_sharded(*args, mesh1, slack=2.0)
    assert int(d1) == 0
    np.testing.assert_array_equal(np.asarray(got1), ref)

    got8, d8 = debris_particles_sharded(*args, mesh, slack=2.0)
    got8 = np.asarray(got8)
    assert int(d8) == 0
    assert np.corrcoef(got8[..., 0].ravel(),
                       ref[..., 0].ravel())[0, 1] >= 0.999
    np.testing.assert_allclose(got8[..., 0].sum(), ref[..., 0].sum(),
                               rtol=1e-4)


def test_sharded_particles_overflow_is_graceful(mesh):
    """Slot-capacity overflow under adversarial flow (everything
    concentrating into one block with slack=1.0) must DEGRADE, not
    corrupt: overflowing particles are killed and counted in the
    returned drop counter, the flux stays finite and nonnegative."""
    from soillib_tpu.parallel.particles import solve_particles_sharded

    W, H = 32, 48
    yy, xx = jnp.meshgrid(jnp.arange(H), jnp.arange(W))
    flow = jnp.stack(
        [jnp.where(xx < 28, 1.0, 0.1), jnp.where(yy < 40, 1.0, 0.1)],
        axis=-1,
    ).astype(jnp.float32)
    got, dropped = solve_particles_sharded(
        flow, jnp.ones((W, H), jnp.float32), jnp.full((W, H), 0.01),
        (0.5, 0.5), 16000, jax.random.PRNGKey(1), mesh, slack=1.0,
    )
    got = np.asarray(got)
    assert int(dropped) > 0  # the overflow IS reported
    assert np.isfinite(got).all()
    assert (got >= 0).all()


def test_halo_overlap_schedule_equivalent(mesh, monkeypatch):
    """SOIL_HALO_OVERLAP=1 (interior/boundary-band split, exchange
    overlappable with interior compute) produces the same coupled step
    as the sequential exchange-then-advance schedule.  Both schedules
    run the same per-cell arithmetic on the same inputs — only the
    crops/pastes differ — so equality is bitwise.  Blocks must be
    >= 4K for the band split to engage (128x256 -> 64x64 blocks)."""
    W, H = 128, 256
    key = jax.random.PRNGKey(3)
    hgt = 2.0 + 0.02 * jax.random.normal(key, (W, H), jnp.float32)
    state = soil.ErosionState.zeros((W, H), height=hgt)
    param = soil.ErosionParams()
    param.transportIterations = 20  # n_full + remainder pass
    scale = (0.08, 0.08, 4.0)
    k = jax.random.PRNGKey(42)

    monkeypatch.delenv("SOIL_HALO_OVERLAP", raising=False)
    seq = par.sharded_erode(state, mesh, scale, param, steps=1, key=k)
    monkeypatch.setenv("SOIL_HALO_OVERLAP", "1")
    ovl = par.sharded_erode(state, mesh, scale, param, steps=1, key=k)

    for f in ("layers", "discharge", "mass", "momentum", "debris"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ovl, f)), np.asarray(getattr(seq, f)),
            err_msg=f,
        )


def test_halo_bytes_ledger(mesh):
    """The halo-traffic ledger measures the traced program's ppermute
    payloads — the communication inputs of a scaling model.

    Direct check: one pad_cf of a (C, bw, bh) block at radius K sends
    2*C*K*bh bytes*4 on the x axis and 2*C*(bw+2K)*K*4 on the y axis
    per device (two edge slabs each)."""
    from jax import shard_map as smap
    from soillib_tpu.parallel import halo as H
    from soillib_tpu.parallel.mesh import grid_spec

    C, W, Hh, K = 3, 64, 96, 8
    px, py = mesh.devices.shape
    bw, bh = W // px, Hh // py
    sh = H.ShardHalo(mesh.devices.shape, mesh.axis_names)

    def fn(a):
        return sh.pad_cf(a, 0.0, K)

    spec = grid_spec(mesh)
    sspec = jax.sharding.PartitionSpec(None, *spec)
    with H.halo_ledger() as entries:
        jax.eval_shape(
            lambda a: smap(fn, mesh=mesh, in_specs=(sspec,),
                           out_specs=sspec, check_vma=False)(a),
            jax.ShapeDtypeStruct((C, W, Hh), jnp.float32),
        )
        got = {}
        for name, nbytes in entries:
            got[name] = got.get(name, 0) + nbytes
    ax, ay = mesh.axis_names
    assert got[ax] == 2 * C * K * bh * 4
    assert got[ay] == 2 * C * (bw + 2 * K) * K * 4
