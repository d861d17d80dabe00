"""Checkpointing.

* `zip_save` / `zip_load`: the reference's de-facto checkpoint format — each
  field written as a GeoTIFF (with pixel scale) into a zip
  (python/soillib/util.py:187-195).
* `save_checkpoint` / `load_checkpoint`: orbax-backed pytree step
  checkpoints for multi-device runs (extension over the reference; SURVEY.md §5).
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from soillib_tpu.io.geotiff import geotiff


def zip_save(output: str, fields: dict, pscale=(1.0, 1.0, 1.0)):
    """Write each (name -> 2-D array) field as a GeoTIFF into a zip.
    Ref: util.py:187-195 (the tempfile dance is replaced by writestr)."""
    with zipfile.ZipFile(output, "w") as z:
        for name, field in fields.items():
            tmp = f"{output}.{name}.tmp.tiff"
            g = geotiff(np.asarray(field, np.float32))
            g.meta.scale = [float(pscale[0]), float(pscale[1]), float(pscale[2])]
            g.write(tmp)
            z.write(tmp, arcname=f"{name}.tiff")
            os.remove(tmp)


def zip_load(path: str) -> dict:
    """Inverse of zip_save: name -> (array, meta)."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            if not info.filename.endswith(".tiff"):
                continue
            tmp = f"{path}.{os.path.basename(info.filename)}.tmp"
            with open(tmp, "wb") as f:
                f.write(z.read(info.filename))
            g = geotiff(tmp)
            out[info.filename[: -len(".tiff")]] = (g.numpy(), g.meta)
            os.remove(tmp)
    return out


def save_checkpoint(directory: str, state, step: int):
    """Orbax pytree checkpoint (multi-host safe)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(path, state, force=True)
    ckpt.wait_until_finished()
    return path


def load_checkpoint(directory: str, abstract_state, step: int):
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    ckpt = ocp.StandardCheckpointer()
    return ckpt.restore(path, abstract_state)
