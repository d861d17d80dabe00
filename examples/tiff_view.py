"""View TIFF/GeoTIFF DEMs (reference: example/tiff_view.py).

    python examples/tiff_view.py <file-or-dir> [--out DIR]
"""

import argparse
import os

import numpy as np

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("--out", default=None, help="save PNGs here (headless)")
    args = ap.parse_args()
    enable_compile_cache()

    for file, path in soil.util.iter_tiff(args.input):
        image = soil.geotiff(path)
        data = image.numpy()
        print(f"File: {file}, {data.dtype}, {data.shape}")
        save = os.path.join(args.out, file + ".png") if args.out else None
        if save:
            os.makedirs(args.out, exist_ok=True)
        soil.util.show_height(data, show=not save, save=save)


if __name__ == "__main__":
    main()
