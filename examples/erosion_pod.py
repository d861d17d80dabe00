"""Multi-device erosion: 2-D block decomposition over a device mesh.

No reference analog — the reference is single-GPU (SURVEY.md §2.10); this
is the scale-out path (BASELINE.md north star): every field is
block-sharded over a ("X", "Y") mesh of all visible GPUs, radius-1
stencils and each transport pass exchange halos (NCCL over NVLink)
inside shard_map.

One host, all GPUs: python examples/erosion_pod.py --res 1024 --steps 64
CPU rehearsal:      python examples/erosion_pod.py --virtual 8 --res 256
                    (N virtual CPU devices instead of the GPUs; numbers
                    are not device numbers)
Multi-host:         call jax.distributed.initialize() first (same script,
                    launched per host).
"""

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--virtual", type=int, default=0,
                    help="CPU rehearsal: run on N virtual CPU devices "
                         "instead of the GPUs")
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
    from examples.erosion_gpu import make_param

    mesh = par.make_mesh()
    px, py = mesh.devices.shape
    print(f"mesh: {px}x{py} ({jax.device_count()} devices, "
          f"{jax.process_count()} processes)")

    res = (args.res, args.res)
    par.check_divisible(res, mesh)
    wscale = (20.0, 20.0, 4.0)
    pscale = (wscale[0] / res[0], wscale[1] / res[1], wscale[2])

    param = make_param()
    param.transportIterations = 32
    height = soil.noise(res, soil.noise_t(seed=3.0, ext=res))
    state = par.shard_state(soil.ErosionState.zeros(res, height=height), mesh)

    step = par.make_sharded_erode_fn(mesh, pscale, param, steps=args.steps)
    key = jax.random.PRNGKey(0)

    state = step(state, key)                       # compile
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state = step(state, key)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0

    cells = res[0] * res[1]
    print(f"{args.steps} steps at {res[0]}x{res[1]}: "
          f"{dt / args.steps * 1e3:.2f} ms/step, "
          f"{cells * args.steps / dt / 1e6:.1f} M cell-steps/s "
          f"across {jax.device_count()} devices")
    assert bool(jnp.isfinite(state.layers).all())


if __name__ == "__main__":
    main()
