"""soillib_tpu — a geomorphology simulation framework in JAX.

A from-scratch JAX / XLA re-design with the capabilities of
erosiv/soillib (reference: /root/reference, v1.1.2): kernelized erosion
models (fluvial + debris-flow transport, mass transfer, thermal creep),
DEM flow-graph operations (flow direction, flow accumulation, slope),
differential/filter operators, procedural noise, GeoTIFF / PLY I/O and
numpy interop — all expressed as functional array programs over a 2-D
grid, sharded across device meshes with `shard_map`.

Conventions (matching the reference's silt layer, see SURVEY.md §2.9):
  * fields are `jnp` arrays of shape (W, H) or (W, H, C); axis 0 is x.
  * flat index = x * H + y  ("x-major", ref: example/dem_condition.py:57)
  * world scale is a (sx, sy, sz) triple: cell width x/y [m or km] and
    value (height) scale z.

Typical use mirrors the reference Python package (``import soillib as soil``):

    import soillib_tpu as soil
    flow = soil.steepest(height, soil.d8)
    area = soil.accumulate(flow, rain, soil.d8)
"""

from soillib_tpu.core.grid import (
    D4,
    D8,
    D4_SHIFTS,
    D8_SHIFTS,
    Shape,
    flatten,
    unflatten,
    oob,
)
from soillib_tpu.core.timer import timer, profile, us, ms, s, ns
from soillib_tpu.core.yieldgen import yield_t, make_yield, prefetch
from soillib_tpu.core import metrics, morton
from soillib_tpu.ops.stencil import gradient, negslope, laplacian, normal
from soillib_tpu.ops.filter import gaussian_blur
from soillib_tpu.ops.graph import (
    accumulate,
    accumulate_decay,
    direction,
    random_weighted,
    slope,
    steepest,
    upstream_mask,
    upstream_distance,
)
from soillib_tpu.ops.noise import noise, noise_t
from soillib_tpu.ops.condition import condition, fill_depressions
from soillib_tpu.ops.resize import resize, copy
from soillib_tpu.ops.transport import solve_uniform
from soillib_tpu.ops.cohort import CohortClosure
from soillib_tpu.models.params import ErosionParams, param_t
from soillib_tpu.models.erosion import (
    albedo_discharge,
    albedo_layer,
    albedo_stratum,
    layer_merge,
    mass_creep,
    mass_transfer,
    transport_debris,
    transport_fluvial,
)
from soillib_tpu.models.simulation import ErosionState, ErosionSim, erode, make_erode_fn
from soillib_tpu.models.multiscale import level_scale, resize_state, run_cascade
from soillib_tpu.io.tiff import tiff
from soillib_tpu.io.geotiff import geotiff, geotiff_meta
from soillib_tpu.io.mesh import mesh
from soillib_tpu import util
from soillib_tpu import silt
from soillib_tpu import parallel

# Reference-compatible edge-connectivity enumerators (graph.hpp:11-14).
d4 = D4
d8 = D8

__version__ = "0.2.0"

__all__ = [
    "D4", "D8", "d4", "d8", "D4_SHIFTS", "D8_SHIFTS",
    "Shape", "flatten", "unflatten", "oob",
    "timer", "profile", "ns", "us", "ms", "s",
    "yield_t", "make_yield", "prefetch",
    "metrics", "morton", "silt", "parallel",
    "gradient", "negslope", "laplacian", "normal",
    "gaussian_blur",
    "steepest", "direction", "random_weighted", "slope",
    "accumulate", "accumulate_decay", "upstream_mask", "upstream_distance",
    "noise", "noise_t",
    "condition", "fill_depressions",
    "resize", "copy",
    "solve_uniform",
    "ErosionParams", "param_t",
    "transport_fluvial", "transport_debris",
    "mass_transfer", "mass_creep", "layer_merge",
    "albedo_stratum", "albedo_layer", "albedo_discharge",
    "ErosionState", "ErosionSim", "erode", "make_erode_fn",
    "level_scale", "resize_state", "run_cascade",
    "tiff", "geotiff", "geotiff_meta", "mesh",
    "util",
]
