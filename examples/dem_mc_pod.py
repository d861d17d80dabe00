"""Distributional Monte-Carlo transport at mesh scale.

No reference analog — the reference's MC solvers are single-GPU
(path.cu / erosion.cu); this example runs the faithful particle
estimators block-decomposed with cross-block particle migration
(parallel/particles.py): a DEM's steady-state water distribution is
estimated from millions of trajectories whose particles hop between
device blocks as they cross seams, and the fluvial MC transport is
sampled the same way.  Compare against the deterministic field solve —
on a mesh the two formulations bracket each other (the field solve is
the fast path; the MC path gives seed-resolved distributions).

Single host:     python examples/dem_mc_pod.py --res 256
Virtual devices: python examples/dem_mc_pod.py --virtual 8 --res 64
"""

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--count", type=int, default=0,
                    help="particles (default 16x cells)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="CPU rehearsal: run on N virtual CPU devices "
                         "instead of the GPUs")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax
    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.virtual)
    import jax.numpy as jnp
    import numpy as np

    import soillib_tpu as soil
    from soillib_tpu.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    from soillib_tpu import parallel as par

    mesh = par.make_mesh()
    px, py = mesh.devices.shape
    print(f"mesh: {px}x{py} ({jax.device_count()} devices)")

    res = (args.res, args.res)
    par.check_divisible(res, mesh)
    N = args.count or 16 * res[0] * res[1]

    # Terrain -> a smooth downslope flow field with structure.
    height = soil.noise(res, soil.noise_t(seed=3.0, ext=res))
    grad = soil.gradient(height, (0.5, 0.5))  # already channel-LAST (W, H, 2)
    flow = -grad + 0.02
    source = jnp.ones(res, jnp.float32)
    decay = jnp.full(res, 0.02, jnp.float32)

    t0 = time.time()
    G, dropped = par.solve_particles_sharded(
        flow, source, decay, (0.5, 0.5), N, jax.random.PRNGKey(0), mesh
    )
    G = np.asarray(G)
    print(f"uniform MC: {N} particles in {time.time() - t0:.1f}s, "
          f"dropped {int(dropped)}, mean flux {G.mean():.4f}")
    assert np.isfinite(G).all()

    # Fluvial MC through the coupled-model physics on the same mesh.
    p = soil.ErosionParams()
    p.maxage = 64
    p.nSamples = N
    state = soil.ErosionState.zeros(res, height=1.0 + 0.2 * height)
    t0 = time.time()
    F, dropped = par.fluvial_particles_sharded(
        state.layers, state.rainfall, state.discharge, state.momentum,
        state.albedo_surface, (0.5, 0.5, 2.0), p, jax.random.PRNGKey(1),
        mesh,
    )
    F = np.asarray(F)
    print(f"fluvial MC: {time.time() - t0:.1f}s, dropped {int(dropped)}, "
          f"water flux mean {F[..., 0].mean():.4f}")
    assert np.isfinite(F).all()

    if args.out:
        np.savez(args.out, uniform=G, fluvial=F)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
