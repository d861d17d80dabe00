"""Multiscale erosion cascade.

Reference workload: example/erosion_gpu_multiscale.py — advance geological
time on a coarse grid, upsample every field, refine at finer levels;
pixel scale recomputed from the fixed world extent each level
(ksteps = [(128², 2048), (256², 4), (1000², 4)], :142-148). Final state
checkpointed as GeoTIFFs in a zip (:166-170).

    python examples/erosion_gpu_multiscale.py [--quick]
"""

import argparse
import os

import numpy as np

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache
from examples.erosion_gpu import make_param


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small levels for a fast smoke run")
    ap.add_argument("--levels", default="",
                    help="cascade override as res:steps,res:steps,...")
    ap.add_argument("--out", default="/tmp/erosion_multiscale")
    args = ap.parse_args()
    enable_compile_cache()

    if args.levels:
        levels = [((int(r), int(r)), int(s))
                  for r, s in (lv.split(":") for lv in args.levels.split(","))]
    elif args.quick:
        levels = [((128, 128), 64), ((256, 256), 4), ((512, 512), 2)]
    else:
        levels = [((128, 128), 2048), ((256, 256), 4), ((1000, 1000), 4)]

    world = (20.0, 20.0)   # [km]
    zscale = 4.0
    param = make_param()

    res0 = levels[0][0]
    height = soil.noise(res0, soil.noise_t(seed=3.0, ext=res0))
    state = soil.ErosionState.zeros(res0, height=height)

    def report(i, res, st):
        print(f"level {i}: {res[0]}x{res[1]} done, "
              f"mean height {float(st.height.mean()):.4f}")

    with soil.timer(soil.s) as t:
        state = soil.run_cascade(state, levels, world, zscale, param,
                                 on_level=report)
    print(f"cascade total: {t.count} s")

    os.makedirs(args.out, exist_ok=True)
    res = state.rainfall.shape
    pscale = soil.level_scale(world, zscale, res)
    soil.util.zip_save(
        os.path.join(args.out, "multiscale.zip"),
        {
            "height": np.asarray(state.height),
            "sediment": np.asarray(state.sediment),
            "discharge": np.asarray(state.discharge),
        },
        pscale,
    )
    print(f"wrote {args.out}/multiscale.zip")


if __name__ == "__main__":
    main()
