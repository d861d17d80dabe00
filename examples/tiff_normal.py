"""Surface normal maps from DEMs (reference: example/tiff_normal.py).

    python examples/tiff_normal.py <file-or-dir> [--out DIR]
"""

import argparse
import os

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    enable_compile_cache()

    for file, path in soil.util.iter_tiff(args.input):
        image = soil.geotiff(path)
        scale = image.meta.scale or (1.0, 1.0, 1.0)
        print(f"File: {file}, scale {scale}")
        save = os.path.join(args.out, file + ".normal.png") if args.out else None
        if save:
            os.makedirs(args.out, exist_ok=True)
        soil.util.show_normal(image.numpy(), scale, show=not save, save=save)


if __name__ == "__main__":
    main()
