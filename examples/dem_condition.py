"""Hydrological DEM conditioning, natively.

Reference workload: example/dem_condition.py — fills pits/depressions and
resolves flats with the external pysheds package before flow routing
(dem_condition.py:32-49, including the float64 caveat). Here the
conditioning is the framework's own Planchon–Darboux stencil fill
(ops/condition.py) running on the accelerator, and drainage is verified by
checking every interior cell has a receiver.

    python examples/dem_condition.py [dem.tiff]
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dem", nargs="?", default=None)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--out", default="/tmp/dem_condition.png")
    args = ap.parse_args()
    enable_compile_cache()

    if args.dem:
        img = soil.geotiff(args.dem)
        height = jnp.asarray(img.numpy())
    else:
        height = soil.noise((args.res, args.res), soil.noise_t(seed=11.0)) * 400.0

    with soil.timer(soil.ms) as t:
        filled = soil.condition(height, soil.d8)
        jax.block_until_ready(filled)
    print(f"conditioned {height.shape} in {t.count} ms")

    flow = soil.steepest(filled, soil.d8)
    area = soil.accumulate(flow, jnp.ones_like(filled), soil.d8)

    interior = np.zeros(height.shape, bool)
    interior[1:-1, 1:-1] = True
    pits_before = int((np.asarray(soil.steepest(height, soil.d8)) < 0)[interior].sum())
    pits_after = int((np.asarray(flow) < 0)[interior].sum())
    print(f"interior pits: {pits_before} -> {pits_after}")
    print(f"fill volume: {float((filled - height).sum()):.1f}")

    soil.util.plot_area(area, show=False, save=args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
