"""Multiple-flow-direction contributing area by Gibbs ensemble.

Reference workload: example/dem_multiflow.py — 1024² DEM, K=512 stochastic
receiver graphs (`random_weighted`, temperature T), each accumulated and
averaged on the host. Here the ensemble members are
*vmapped* over threefry keys and mean-reduced on-device — one compiled
program instead of 512 launches + 512 device→host copies.

    python examples/dem_multiflow.py [dem.tiff] [--K 512] [--T 10]
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def load_or_synthesize(path, res=1024):
    if path:
        img = soil.geotiff(path)
        h = jnp.asarray(img.numpy())
        scale = img.meta.scale if img.meta.scale else (1.0, 1.0, 1.0)
        return h, scale
    h = soil.noise((res, res), soil.noise_t(seed=7.0)) * 400.0
    return h, (90.0, 90.0, 1.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dem", nargs="?", default=None)
    ap.add_argument("--K", type=int, default=512)
    ap.add_argument("--T", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default="/tmp/dem_multiflow.png")
    args = ap.parse_args()
    enable_compile_cache()

    height, scale = load_or_synthesize(args.dem)
    rain = jnp.ones_like(height)

    @jax.jit
    def member_mean(keys):
        def one(key):
            flow = soil.random_weighted(height, soil.d8, T=args.T, key=key)
            return soil.accumulate(flow, rain, soil.d8)

        return jax.vmap(one)(keys).mean(axis=0)

    base = jax.random.PRNGKey(0)
    total = jnp.zeros_like(height)
    n = 0
    t0 = time.perf_counter()
    for b in range(0, args.K, args.batch):
        k = min(args.batch, args.K - b)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            base, jnp.arange(b, b + k)
        )
        total = total + member_mean(keys) * k
        n += k
    multiflow = total / n
    jax.block_until_ready(multiflow)
    dt = time.perf_counter() - t0
    print(f"{args.K} ensemble members on {height.shape} in {dt:.2f}s "
          f"({dt / args.K * 1e3:.1f} ms/member)")

    soil.util.plot_area(multiflow, show=False, save=args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
