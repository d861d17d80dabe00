"""Terrain triangulation -> PLY export (reference: example/tiff_mesh.py).

    python examples/tiff_mesh.py <file-or-dir> [out.ply]
"""

import argparse

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default="/tmp/out.ply")
    args = ap.parse_args()
    enable_compile_cache()

    for file, path in soil.util.iter_tiff(args.input):
        image = soil.geotiff(path)
        scale = image.meta.scale or (1.0, 1.0, 1.0)
        print(f"File: {file}")
        m = soil.mesh(image.numpy(), [scale[0], scale[1], 1.0])
        m.center()
        m.write_binary(args.output)
        print(f"wrote {args.output}: {len(m.vertices)} vertices, "
              f"{len(m.faces)} faces")


if __name__ == "__main__":
    main()
