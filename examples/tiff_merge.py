"""Merge a directory of GeoTIFF tiles into one world-extent raster.

Reference workload: example/tiff_merge.py — compute the union world
extent from every tile's geo metadata, allocate the merged raster at a
chosen pixel scale, and blit each tile in world space (`soil.copy`,
tiff_merge.py:67), then save with merged metadata.

    python examples/tiff_merge.py <dir> [--pscale 0.1] [--out merged.tiff]
"""

import argparse

import jax.numpy as jnp
import numpy as np

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("--pscale", type=float, default=0.1)
    ap.add_argument("--out", default="/tmp/merged.tiff")
    args = ap.parse_args()
    enable_compile_cache()

    # Pass 1: union world extent.
    wmin = np.array([np.inf, np.inf])
    wmax = np.array([-np.inf, -np.inf])
    wscale = None
    tiles = []
    for file, path in soil.util.iter_tiff(args.input):
        img = soil.geotiff(path)
        mmin, mmax = np.asarray(img.min), np.asarray(img.max)
        wmin = np.minimum(wmin, mmin)
        wmax = np.maximum(wmax, mmax)
        wscale = np.asarray(img.scale)
        tiles.append((file, path))
        print(f"tile {file}: extent {mmin} .. {mmax}")
    if not tiles:
        raise SystemExit("no tiles found")

    shape = ((wmax - wmin) / wscale * args.pscale).astype(int)
    print(f"merged raster: {shape[0]}x{shape[1]} at pscale {args.pscale}")
    merged = jnp.full((int(shape[0]), int(shape[1])), jnp.nan)

    # Pass 2: world-space blit of each tile.
    for file, path in tiles:
        img = soil.geotiff(path)
        merged = soil.copy(
            merged, jnp.asarray(img.numpy()),
            gmin=np.asarray(img.min), gmax=np.asarray(img.max),
            gscale=np.asarray(img.scale),
            wmin=wmin, wmax=wmax, wscale=wscale, pscale=args.pscale,
        )

    out = soil.geotiff(np.asarray(merged, np.float32))
    out.meta.scale = [float(wscale[0] / args.pscale),
                      float(wscale[1] / args.pscale), 1.0]
    out.write(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
