"""DEM processing kernels: flow direction, decayed accumulation, and the
steady-state transport solve.

Reference workload: example/dem_process.py — direction + accumulate_decay
on a 1024² DEM (the "fastflow" pipeline, timed in µs) and the
Monte-Carlo path-integral solve `solve_uniform` seeded per iteration
(dem_process.py:72-90). Both run here: the deterministic field solve is
the default; `--particles` runs the faithful threefry MC estimator.

    python examples/dem_process.py [dem.tiff] [--particles]
"""

import argparse
import time

import jax
import jax.numpy as jnp

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dem", nargs="?", default=None)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--particles", action="store_true")
    ap.add_argument("--out", default="/tmp/dem_process.png")
    args = ap.parse_args()
    enable_compile_cache()

    if args.dem:
        img = soil.geotiff(args.dem)
        height = jnp.asarray(img.numpy())
        scale = img.meta.scale or (1.0, 1.0, 1.0)
    else:
        height = soil.noise((args.res, args.res), soil.noise_t(seed=2.0)) * 400.0
        scale = (90.0, 90.0, 1.0)

    height = soil.fill_depressions(height)

    # Fastflow pipeline: steepest graph + unit-rain accumulation w. decay.
    rain = jnp.ones_like(height)
    decay = jnp.full_like(height, 0.9999)

    @jax.jit
    def fastflow(h):
        flow = soil.steepest(h, soil.d8)
        area = soil.accumulate(flow, rain, soil.d8)
        decayed = soil.accumulate_decay(flow, rain, decay, soil.d8)
        return flow, area, decayed

    flow, area, decayed = fastflow(height)
    jax.block_until_ready(area)
    with soil.timer(soil.us) as t:
        flow, area, decayed = fastflow(height)
        jax.block_until_ready(area)
    print(f"direction + accumulate(+decay) on {height.shape}: {t.count} us")

    # Steady-state discharge via the transport solver along -grad h.
    grad = soil.gradient(height, scale[:2])
    velocity = -grad / jnp.maximum(
        jnp.linalg.norm(grad, axis=-1, keepdims=True), 1e-6)
    evap = jnp.full_like(height, 0.001)
    method = "particles" if args.particles else "field"
    with soil.timer(soil.ms) as t:
        discharge = soil.solve_uniform(
            velocity, rain, evap, scale[:2], method=method, seed=0)
        jax.block_until_ready(discharge)
    print(f"solve_uniform[{method}]: {t.count} ms")

    soil.util.plot_images([jnp.log1p(area), jnp.log1p(discharge)],
                          show=False, save=args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
