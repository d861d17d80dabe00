"""Cross-block particle migration: the MC estimators under shard_map.

The reference's Monte-Carlo solvers are single-GPU (SURVEY.md §2.10);
the field solve is this framework's scale-out formulation. This module
removes the remaining limitation — distributional MC studies were
single-device-only — by running the particle estimators block-
decomposed with ppermute particle migration:

* Births are drawn GLOBALLY: every block evaluates the identical
  threefry draws (the key is replicated), then keeps the particles that
  fall inside its rectangle via masked compaction.  The particle SET —
  positions, per-particle sources — is therefore bit-identical to the
  single-device estimator's for any mesh shape, and a 1×1 mesh
  reproduces `_solve_particles` BITWISE.  Multi-block runs agree
  statistically but not per-cell-bitwise: a particle's deposit cell is
  floor(pos), discontinuous in position, so the 1-ulp cross-program
  reassociation freedom XLA has (fma/fusion differ between the padded
  block program and the global one) occasionally flips a near-threshold
  crossing and displaces that particle's remaining trajectory — the
  same chaos class the multi-step sharded erosion tests guard with
  integral metrics (tests/test_parallel.py).  Measured at 20k
  particles, 2×4 mesh: corr 0.9998, total-mass rel 6e-6, rel_mean
  0.3% vs single-device; the MC seed-to-seed band is far wider.
* A particle moves at most sqrt(2) cells per round (DDA stepsize,
  path.cu:104-139), so migration only ever targets the 4 neighbors;
  corners resolve in two axis hops exactly like the halo exchange
  (parallel/halo.py). Per round and direction, migrating records are
  compacted into a fixed-capacity buffer, `lax.ppermute`d along the
  mesh axis, and merged into the receiver's free (dead) slots.
  Capacity/slot overflow kills the particle and counts it — the solver
  returns the psum'd drop count so callers can assert 0 (tests do) or
  re-run with more slack.
* Particles crossing the GLOBAL edge are sent to no one (non-wrapping
  permutation) — they die exactly where the single-device estimator's
  in-bounds check kills them, before depositing.

All buffers are static-shaped: local slot arrays hold
ceil(count/nblocks * slack) records; compaction is a stable argsort
(masked-first) — O(M log M) work per round, the price of
atomics-free, shape-static migration.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from soillib_tpu.parallel.halo import ShardHalo


def _take(rec, mask, cap):
    """Compact up to `cap` masked records into a (cap, ...) buffer.

    Returns (buffer, valid, n_overflow): stable masked-first ordering,
    `valid[i]` marks real records, overflow = masked records beyond
    capacity."""
    order = jnp.argsort(~mask)  # mask=True rows first (stable)
    take = order[:cap]
    buf = jax.tree.map(lambda a: a[take], rec)
    valid = mask[take]
    n_over = jnp.sum(mask) - jnp.sum(valid)
    return buf, valid, n_over


def _merge(rec, alive, buf, valid):
    """Scatter valid buffer records into dead slots of the local arrays.

    Returns (rec, alive, n_dropped) — dropped = arrivals with no free
    slot."""
    cap = valid.shape[0]
    order = jnp.argsort(alive)  # dead slots first (stable)
    slots = order[:cap]
    ok = valid & ~alive[slots]

    def put(a, b):
        okb = ok.reshape(ok.shape + (1,) * (b.ndim - 1))
        return a.at[slots].set(jnp.where(okb, b, a[slots]))

    rec = jax.tree.map(put, rec, buf)
    alive = alive.at[slots].set(ok | alive[slots])
    return rec, alive, jnp.sum(valid) - jnp.sum(ok)


def _migrate_axis(rec, alive, get_coord, lo, hi, axis_name, n_blocks, cap):
    """Move records whose coordinate left [lo, hi) to the -/+ neighbor
    along `axis_name`. Non-wrapping: global-edge leavers die (the
    single-device in-bounds kill). Returns (rec, alive, dropped).

    `get_coord` is re-evaluated on the CURRENT record each phase: the
    +1 phase's merge can seat an arrival in a slot whose previous
    occupant left toward -1 in an earlier round, and a mask computed
    against the entry-time coordinate array would re-migrate that
    arrival by the stale value."""
    dropped = jnp.zeros((), jnp.int32)
    for sign in (+1, -1):
        coord = get_coord(rec)
        m = alive & ((coord >= hi) if sign > 0 else (coord < lo))
        buf, valid, over = _take(rec, m, cap)
        alive = alive & ~m  # leavers (incl. overflow) vacate this block
        dropped = dropped + over.astype(jnp.int32)
        perm = [(i, i + sign) for i in range(n_blocks)
                if 0 <= i + sign < n_blocks]
        if perm:
            buf = jax.tree.map(
                lambda a: lax.ppermute(a, axis_name, perm), buf
            )
            valid = lax.ppermute(valid, axis_name, perm)
            rec, alive, d2 = _merge(rec, alive, buf, valid)
            dropped = dropped + d2.astype(jnp.int32)
    return rec, alive, dropped


def _bilinear_global(flow_pad, pos, x0, y0, W, H):
    """`ops.transport.bilinear_gather` semantics (global far-edge clamp,
    sample.hpp:155-186) evaluated on a 1-ring-padded LOCAL block.
    `pos` must lie inside the local block (post-migration)."""
    x, y = pos[:, 0], pos[:, 1]
    gx0 = jnp.floor(x).astype(jnp.int32)
    gy0 = jnp.floor(y).astype(jnp.int32)
    wx = x - gx0
    wy = y - gy0
    wx = jnp.where(x + 1.0 > W - 1.0, 0.0, wx)
    wy = jnp.where(y + 1.0 > H - 1.0, 0.0, wy)
    bw = flow_pad.shape[0] - 2
    bh = flow_pad.shape[1] - 2
    lx0 = jnp.clip(gx0 - x0 + 1, 0, bw + 1)
    ly0 = jnp.clip(gy0 - y0 + 1, 0, bh + 1)
    lx1 = jnp.clip(jnp.clip(gx0 + 1, 0, W - 1) - x0 + 1, 0, bw + 1)
    ly1 = jnp.clip(jnp.clip(gy0 + 1, 0, H - 1) - y0 + 1, 0, bh + 1)
    wxe, wye = wx[:, None], wy[:, None]
    v = (
        flow_pad[lx0, ly0] * (1 - wxe) * (1 - wye)
        + flow_pad[lx0, ly1] * (1 - wxe) * wye
        + flow_pad[lx1, ly0] * wxe * (1 - wye)
        + flow_pad[lx1, ly1] * wxe * wye
    )
    # The reference's valid domain is [0, dim-1] — the last PARTIAL cell
    # is out of bounds (bilinear_gather returns NaN there; the particle
    # solver maps that to velocity 0, killing the particle).
    oob = (x < 0) | (y < 0) | (x > W - 1.0) | (y > H - 1.0)
    return jnp.where(oob[:, None], 0.0, v)


def solve_particles_sharded(flow, source, decay, scale, count, key, mesh,
                            maxstep=None, slack=1.5):
    """Block-decomposed `solve_uniform(method="particles")` with
    ppermute particle migration — the faithful MC estimator of path.cu:52-139 at
    mesh scale. Returns ((W, H[, K]) flux, dropped count).

    The estimate equals the single-device `_solve_particles` with the
    same key — bitwise on a 1×1 mesh, statistically (corr ≥ 0.999,
    conserved total mass) on real meshes; see the module docstring for
    why per-cell bitwise multi-block parity is impossible.  `dropped` >
    0 means a capacity overflow somewhere — re-run with more `slack`
    (the parity test asserts 0)."""
    from soillib_tpu.core.grid import check_channel_last
    from soillib_tpu.ops.transport import stepsize

    check_channel_last("flow", flow, channels=(2,))
    W, H = flow.shape[0], flow.shape[1]
    if source.shape[:2] != (W, H):
        raise ValueError(
            f"source spatial shape {tuple(source.shape[:2])} does not match "
            f"flow's (W, H) = {(W, H)}; flow must be channel-LAST (W, H, 2)."
        )
    squeeze = source.ndim == 2
    src3 = source[..., None] if squeeze else source
    K = src3.shape[2]
    px, py = mesh.devices.shape
    ax, ay = mesh.axis_names
    n_blocks = px * py
    bw, bh = W // px, H // py
    assert bw * px == W and bh * py == H, "grid must divide the mesh"
    N = int(count)
    M = int(math.ceil(N / n_blocks * slack)) + 64
    cap = max(64, int(4 * M / min(bw, bh)) + 16)
    A = float(scale[0]) * float(scale[1])
    L = math.sqrt(float(scale[0]) ** 2 + float(scale[1]) ** 2)
    Pn = 1.0 / (A * W * H)
    eps = 1e-16
    steps = int(maxstep if maxstep is not None else W + H)
    halo = ShardHalo(mesh.devices.shape, mesh.axis_names)

    def local(flow_b, src_b, dec_b, key):
        x0, y0, _, _ = halo.global_offsets((bw, bh))
        # Identical global birth draws on every block (replicated key).
        kx, ky = jax.random.split(key)
        gpos = jnp.stack(
            [jax.random.uniform(kx, (N,), jnp.float32) * W,
             jax.random.uniform(ky, (N,), jnp.float32) * H], axis=-1)
        mine = ((gpos[:, 0] >= x0) & (gpos[:, 0] < x0 + bw)
                & (gpos[:, 1] >= y0) & (gpos[:, 1] < y0 + bh))
        (pos,), taken, over0 = _take((gpos,), mine, M)
        if pos.shape[0] < M:  # argsort take caps at N — pad dead slots
            padn = M - pos.shape[0]
            pos = jnp.pad(pos, ((0, padn), (0, 0)))
            taken = jnp.pad(taken, (0, padn))

        src_flat = src_b.reshape(bw * bh, K)
        dec_flat = dec_b.reshape(bw * bh)
        flow_pad = halo.pad(flow_b, 0.0, 1)

        def lind(p):
            pc = jnp.clip(p, jnp.array([x0, y0], jnp.float32),
                          jnp.array([x0 + bw - 1e-3, y0 + bh - 1e-3]))
            return ((pc[:, 0].astype(jnp.int32) - x0) * bh
                    + (pc[:, 1].astype(jnp.int32) - y0))

        ind = lind(pos)
        S = src_flat[ind] / Pn
        alive = taken & (jnp.linalg.norm(S, axis=-1) >= eps)
        # Global cell id survives migration; -1 forces the first
        # in-new-cell deposit after arrival exactly like nind != ind.
        gind = jnp.where(
            alive,
            pos[:, 0].astype(jnp.int32) * H + pos[:, 1].astype(jnp.int32),
            -1,
        )

        flux0 = jnp.zeros((bw * bh, K), jnp.float32)
        att0 = jnp.ones((M,), jnp.float32)

        def body(_, carry):
            flux, rec, alive, dropped = carry

            # -- migrate first: everything below is block-local.
            rec, alive, d1 = _migrate_axis(
                rec, alive, lambda r: r["pos"][:, 0], x0, x0 + bw, ax,
                px, cap)
            rec, alive, d2 = _migrate_axis(
                rec, alive, lambda r: r["pos"][:, 1], y0, y0 + bh, ay,
                py, cap)
            pos, att, S_, gind = rec["pos"], rec["att"], rec["S"], rec["g"]
            dropped = dropped + d1 + d2

            x, y = pos[:, 0], pos[:, 1]
            inb = (x >= 0) & (y >= 0) & (x < W) & (y < H)
            alive = alive & inb & (eps < jnp.abs(att))

            pc = jnp.clip(pos, 0.0, jnp.array([W - 1e-3, H - 1e-3]))
            ngind = (pc[:, 0].astype(jnp.int32) * H
                     + pc[:, 1].astype(jnp.int32))
            entered = alive & (ngind != gind)
            gind = jnp.where(entered, ngind, gind)
            li = lind(pos)
            dep = jnp.where(entered[:, None], S_ * att[:, None], 0.0)
            flux = flux.at[li].add(dep)

            v = _bilinear_global(flow_pad, pos, x0, y0, W, H)
            v = jnp.where(jnp.isnan(v), 0.0, v)
            v_len = jnp.linalg.norm(v, axis=-1)
            alive = alive & (v_len >= eps)
            v_n = v / jnp.maximum(v_len, 1e-30)[:, None]
            stp = stepsize(pos, v_n)
            new_pos = pos + stp[:, None] * v_n
            dlam = stp * L / jnp.maximum(v_len, 1e-30)
            new_att = att * jnp.exp(-dlam * dec_flat[li])

            rec = {
                "pos": jnp.where(alive[:, None], new_pos, pos),
                "att": jnp.where(alive, new_att, att),
                "S": S_,
                "g": gind,
            }
            return flux, rec, alive, dropped

        rec0 = {"pos": pos, "att": att0, "S": S, "g": gind}
        flux, _, _, dropped = lax.fori_loop(
            0, max(steps - 1, 0), body,
            (flux0, rec0, alive, over0.astype(jnp.int32)),
        )
        dropped = lax.psum(lax.psum(dropped, ax), ay)
        return flux.reshape(bw, bh, K), dropped

    spec3 = P(ax, ay, None)
    spec2 = P(ax, ay)
    flux, dropped = shard_map(
        local, mesh=mesh,
        in_specs=(spec3, spec3, spec2, P()),
        out_specs=(spec3, P()),
        check_vma=False,
    )(flow, src3, decay, key)
    G = flux / float(count)
    return (G[..., 0] if squeeze else G), dropped


def fluvial_particles_sharded(layers, rainfall, discharge, momentum,
                              albedo_surface, scale, p, key, mesh,
                              slack=1.5):
    """Block-decomposed `_fluvial_particles` (erosion.cu:29-141) with
    ppermute particle migration — distributional MC fluvial transport at mesh
    scale. Returns ((W, H, 7) flux, dropped); same parity contract as
    `solve_particles_sharded` (bitwise on 1×1, statistical on real
    meshes — module docstring)."""
    from soillib_tpu.models.erosion import (
        _EPS,
        _length,
        godunov_gradient,
        merged_height,
    )
    from soillib_tpu.core.grid import check_channel_first
    from soillib_tpu.ops.transport import stepsize

    check_channel_first("layers", layers, channels=(2,))
    check_channel_first("momentum", momentum, channels=(2,))
    check_channel_first("albedo_surface", albedo_surface, channels=(3,))
    W, H = discharge.shape
    sx, sy = float(scale[0]), float(scale[1])
    A = sx * sy
    Lvec = jnp.array([sx, sy], jnp.float32)
    Llen = math.sqrt(sx * sx + sy * sy)
    N = int(p.nSamples)
    Q = A * W * H / N  # erosion.cu:53-54

    g = p.gravity
    nu = p.viscosityWater
    tau = p.bedShearWater
    rho_w = p.densityWater
    ks = p.suspensionRateFluvial / 64.0
    kd = p.depositionRateFluvial * 1.33
    fD = p.frictionFactor / 8.0
    alpha = p.fluvialExponent
    R = p.rainfall
    evap = p.evapRate
    exit_slope = p.exitSlope
    maxage = int(p.maxage)
    force = jnp.array(p.force, jnp.float32)

    px, py = mesh.devices.shape
    ax, ay = mesh.axis_names
    bw, bh = W // px, H // py
    assert bw * px == W and bh * py == H, "grid must divide the mesh"
    n_blocks = px * py
    M = int(math.ceil(N / n_blocks * slack)) + 64
    cap = max(64, int(4 * M / min(bw, bh)) + 16)
    halo = ShardHalo(mesh.devices.shape, mesh.axis_names)
    rain_full = jnp.broadcast_to(jnp.asarray(rainfall, jnp.float32), (W, H))

    def local(layers_b, rain_b, dis_b, mom_b, alb_b, key):
        x0, y0, _, _ = halo.global_offsets((bw, bh))
        height = merged_height(layers_b)
        grad_b = godunov_gradient(height, scale, exit_slope, halo=halo)
        grad_flat = jnp.moveaxis(grad_b, 0, -1).reshape(-1, 2)
        mom_flat = jnp.moveaxis(mom_b, 0, -1).reshape(-1, 2)
        alb_flat = jnp.moveaxis(alb_b, 0, -1).reshape(-1, 3)
        rain_flat = rain_b.reshape(-1)
        dis_flat = dis_b.reshape(-1)

        # Identical global birth draws on every block (erosion.cu:47-52
        # inset births).
        ku, kv = jax.random.split(key)
        gpos = jnp.stack(
            [0.5 + jax.random.uniform(ku, (N,)) * (W - 1),
             0.5 + jax.random.uniform(kv, (N,)) * (H - 1)], axis=-1)
        mine = ((gpos[:, 0] >= x0) & (gpos[:, 0] < x0 + bw)
                & (gpos[:, 1] >= y0) & (gpos[:, 1] < y0 + bh))
        (pos,), taken, over0 = _take((gpos,), mine, M)
        if pos.shape[0] < M:
            padn = M - pos.shape[0]
            pos = jnp.pad(pos, ((0, padn), (0, 0)))
            taken = jnp.pad(taken, (0, padn))

        def lind(pp):
            pc = jnp.clip(pp, jnp.array([x0, y0], jnp.float32),
                          jnp.array([x0 + bw - 1e-3, y0 + bh - 1e-3]))
            return ((pc[:, 0].astype(jnp.int32) - x0) * bh
                    + (pc[:, 1].astype(jnp.int32) - y0))

        li0 = lind(pos)
        vel0 = mom_flat[li0]
        grad0 = grad_flat[li0]
        speed = -(g * grad0) + nu * vel0 + force
        speed = speed / jnp.sqrt(
            jnp.maximum(_length(Lvec[None, :] * speed), _EPS)
        )[:, None]
        alive = taken & (_length(speed) >= _EPS)

        v = _length(vel0)
        shear = 0.125 * fD * rho_w * v * v
        power = jnp.power(jnp.maximum(shear * _length(grad0), 0.0), alpha)
        src_m = Q * ks * power
        src_w = Q * R * rain_flat[li0]
        src_v = Q * (-(g * grad0) + nu * vel0)
        src_a = src_m[:, None] * alb_flat[li0]
        gind = jnp.where(
            alive,
            pos[:, 0].astype(jnp.int32) * H + pos[:, 1].astype(jnp.int32),
            -1,
        )

        flux0 = jnp.zeros((bw * bh, 7), jnp.float32)
        rec0 = {"pos": pos, "att": jnp.ones((M, 3), jnp.float32),
                "spd": speed, "sw": src_w, "sm": src_m, "sv": src_v,
                "sa": src_a, "g": gind}

        def body(_, carry):
            flux, rec, alive, dropped = carry
            rec, alive, d1 = _migrate_axis(
                rec, alive, lambda r: r["pos"][:, 0], x0, x0 + bw, ax,
                px, cap)
            rec, alive, d2 = _migrate_axis(
                rec, alive, lambda r: r["pos"][:, 1], y0, y0 + bh, ay,
                py, cap)
            dropped = dropped + d1 + d2
            pos, att, speed = rec["pos"], rec["att"], rec["spd"]
            gind = rec["g"]

            x, y = pos[:, 0], pos[:, 1]
            inb = (x >= 0) & (y >= 0) & (x < W) & (y < H)
            alive = alive & inb

            pc = jnp.clip(pos, 0.0, jnp.array([W - 1e-3, H - 1e-3]))
            ngind = (pc[:, 0].astype(jnp.int32) * H
                     + pc[:, 1].astype(jnp.int32))
            entered = alive & (ngind != gind)
            gind = jnp.where(entered, ngind, gind)
            li = lind(pos)
            dep = jnp.concatenate(
                [(att[:, 0] * rec["sw"])[:, None],
                 (att[:, 1] * rec["sm"])[:, None],
                 att[:, 2:3] * rec["sv"],
                 att[:, 1:2] * rec["sa"]], axis=-1)
            flux = flux.at[li].add(jnp.where(entered[:, None], dep, 0.0))

            v_norm = _length(speed)
            ok = v_norm >= _EPS
            alive = alive & ok
            v_unit = speed / jnp.maximum(v_norm, _EPS)[:, None]
            stp = stepsize(pos, v_unit)
            dL = stp * Llen
            ds = dL / jnp.maximum(v_norm, _EPS)

            gradp = grad_flat[li]
            accel = -(g * gradp) + nu * mom_flat[li] + force
            w1 = 1.0 / (1.0 + dL * (tau + nu))
            new_speed = w1[:, None] * speed + (dL * w1)[:, None] * accel

            decay_v = 0.125 * fD / (_EPS + dis_flat[li])
            new_att = jnp.stack(
                [att[:, 0] * jnp.exp(-ds * evap),
                 att[:, 1] * jnp.exp(-ds * kd),
                 att[:, 2] * jnp.exp(-dL * decay_v)], axis=-1)
            new_pos = pos + stp[:, None] * v_unit

            rec = {
                "pos": jnp.where(alive[:, None], new_pos, pos),
                "att": jnp.where(alive[:, None], new_att, att),
                "spd": jnp.where(alive[:, None], new_speed, speed),
                "sw": rec["sw"], "sm": rec["sm"], "sv": rec["sv"],
                "sa": rec["sa"], "g": gind,
            }
            return flux, rec, alive, dropped

        flux, _, _, dropped = lax.fori_loop(
            0, max(maxage - 1, 0), body,
            (flux0, rec0, taken & alive, over0.astype(jnp.int32)),
        )
        dropped = lax.psum(lax.psum(dropped, ax), ay)
        return flux.reshape(bw, bh, 7), dropped

    cf = P(None, ax, ay)
    s2 = P(ax, ay)
    flux, dropped = shard_map(
        local, mesh=mesh,
        in_specs=(cf, s2, s2, cf, cf, P()),
        out_specs=(P(ax, ay, None), P()),
        check_vma=False,
    )(layers, rain_full, discharge, momentum, albedo_surface, key)
    return flux, dropped


def debris_particles_sharded(layers, mass, momentum, albedo_surface,
                             scale, p, key, mesh, slack=1.5):
    """Block-decomposed `_debris_particles` (erosion.cu:245-351) with
    ppermute particle migration. Returns ((W, H, 6) flux, dropped); parity
    contract as `solve_particles_sharded`."""
    from soillib_tpu.models.erosion import (
        _EPS,
        _length,
        godunov_gradient,
        merged_height,
    )
    from soillib_tpu.core.grid import check_channel_first
    from soillib_tpu.ops.transport import stepsize

    check_channel_first("layers", layers, channels=(2,))
    check_channel_first("momentum", momentum, channels=(2,))
    check_channel_first("albedo_surface", albedo_surface, channels=(3,))
    W, H = mass.shape
    sx, sy = float(scale[0]), float(scale[1])
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
    exit_slope = p.exitSlope
    maxage = int(p.maxage)

    px, py = mesh.devices.shape
    ax, ay = mesh.axis_names
    bw, bh = W // px, H // py
    assert bw * px == W and bh * py == H, "grid must divide the mesh"
    n_blocks = px * py
    M = int(math.ceil(N / n_blocks * slack)) + 64
    cap = max(64, int(4 * M / min(bw, bh)) + 16)
    halo = ShardHalo(mesh.devices.shape, mesh.axis_names)

    def local(layers_b, mom_b, alb_b, key):
        x0, y0, _, _ = halo.global_offsets((bw, bh))
        grad_b = godunov_gradient(merged_height(layers_b), scale,
                                  exit_slope, halo=halo)
        grad_flat = jnp.moveaxis(grad_b, 0, -1).reshape(-1, 2)
        mom_flat = jnp.moveaxis(mom_b, 0, -1).reshape(-1, 2)
        alb_flat = jnp.moveaxis(alb_b, 0, -1).reshape(-1, 3)

        ku, kv = jax.random.split(key)
        gpos = jnp.stack(
            [0.5 + jax.random.uniform(ku, (N,)) * (W - 1),
             0.5 + jax.random.uniform(kv, (N,)) * (H - 1)], axis=-1)
        mine = ((gpos[:, 0] >= x0) & (gpos[:, 0] < x0 + bw)
                & (gpos[:, 1] >= y0) & (gpos[:, 1] < y0 + bh))
        (pos,), taken, over0 = _take((gpos,), mine, M)
        if pos.shape[0] < M:
            padn = M - pos.shape[0]
            pos = jnp.pad(pos, ((0, padn), (0, 0)))
            taken = jnp.pad(taken, (0, padn))

        def lind(pp):
            pc = jnp.clip(pp, jnp.array([x0, y0], jnp.float32),
                          jnp.array([x0 + bw - 1e-3, y0 + bh - 1e-3]))
            return ((pc[:, 0].astype(jnp.int32) - x0) * bh
                    + (pc[:, 1].astype(jnp.int32) - y0))

        li0 = lind(pos)
        vel0 = mom_flat[li0]
        grad0 = grad_flat[li0]
        speed = -(g * grad0) + nu * vel0
        speed = speed / jnp.sqrt(
            jnp.maximum(_length(Lvec[None, :] * speed), _EPS)
        )[:, None]
        alive = taken & (_length(speed) >= _EPS)

        excess0 = _length(grad0) - theta
        src_d = Q * jnp.maximum(0.0, kl * excess0)
        src_v = Q * (-(g * grad0) + nu * vel0)
        src_a = src_d[:, None] * alb_flat[li0]
        gind = jnp.where(
            alive,
            pos[:, 0].astype(jnp.int32) * H + pos[:, 1].astype(jnp.int32),
            -1,
        )

        flux0 = jnp.zeros((bw * bh, 6), jnp.float32)
        rec0 = {"pos": pos, "att": jnp.ones((M, 2), jnp.float32),
                "spd": speed, "sd": src_d, "sv": src_v, "sa": src_a,
                "g": gind}

        def body(_, carry):
            flux, rec, alive, dropped = carry
            rec, alive, d1 = _migrate_axis(
                rec, alive, lambda r: r["pos"][:, 0], x0, x0 + bw, ax,
                px, cap)
            rec, alive, d2 = _migrate_axis(
                rec, alive, lambda r: r["pos"][:, 1], y0, y0 + bh, ay,
                py, cap)
            dropped = dropped + d1 + d2
            pos, att, speed = rec["pos"], rec["att"], rec["spd"]
            gind = rec["g"]

            x, y = pos[:, 0], pos[:, 1]
            inb = (x >= 0) & (y >= 0) & (x < W) & (y < H)
            alive = alive & inb

            pc = jnp.clip(pos, 0.0, jnp.array([W - 1e-3, H - 1e-3]))
            ngind = (pc[:, 0].astype(jnp.int32) * H
                     + pc[:, 1].astype(jnp.int32))
            entered = alive & (ngind != gind)
            gind = jnp.where(entered, ngind, gind)
            li = lind(pos)
            dep = jnp.concatenate(
                [(att[:, 0] * rec["sd"])[:, None],
                 att[:, 1:2] * rec["sv"],
                 att[:, 0:1] * rec["sa"]], axis=-1)
            flux = flux.at[li].add(jnp.where(entered[:, None], dep, 0.0))

            v_norm = _length(speed)
            ok = v_norm >= _EPS
            alive = alive & ok
            v_unit = speed / jnp.maximum(v_norm, _EPS)[:, None]
            stp = stepsize(pos, v_unit)
            dL = stp * Llen
            ds = dL / jnp.maximum(v_norm, _EPS)

            gradp = grad_flat[li]
            debrisHeight = _EPS + att[:, 0] * rec["sd"]
            accel = -(g * gradp) + nu * mom_flat[li]
            decay = nu + tau / debrisHeight
            w1 = 1.0 / (1.0 + dL * decay)
            new_speed = w1[:, None] * speed + (w1 * dL)[:, None] * accel

            excess = _length(gradp) - theta
            excessStress = g * (excess - tau_y / debrisHeight)
            shearRate = jnp.where(excessStress < 0.0, kdd, kds)
            decay_d = (ds * shearRate * excessStress
                       / jnp.maximum(v_norm, _EPS))
            new_att = jnp.stack(
                [att[:, 0] * jnp.exp(decay_d),
                 att[:, 1] * jnp.exp(-dL * decay)], axis=-1)
            new_pos = pos + stp[:, None] * v_unit

            rec = {
                "pos": jnp.where(alive[:, None], new_pos, pos),
                "att": jnp.where(alive[:, None], new_att, att),
                "spd": jnp.where(alive[:, None], new_speed, speed),
                "sd": rec["sd"], "sv": rec["sv"], "sa": rec["sa"],
                "g": gind,
            }
            return flux, rec, alive, dropped

        flux, _, _, dropped = lax.fori_loop(
            0, max(maxage - 1, 0), body,
            (flux0, rec0, alive, over0.astype(jnp.int32)),
        )
        dropped = lax.psum(lax.psum(dropped, ax), ay)
        return flux.reshape(bw, bh, 6), dropped

    cf = P(None, ax, ay)
    flux, dropped = shard_map(
        local, mesh=mesh,
        in_specs=(cf, cf, cf, P()),
        out_specs=(P(ax, ay, None), P()),
        check_vma=False,
    )(layers, momentum, albedo_surface, key)
    return flux, dropped
