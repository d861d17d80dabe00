"""AOT-compile the sharded coupled erosion step at 16384^2 on a
virtual 2x4 CPU mesh and report XLA's per-device memory analysis.

The BASELINE.md large-run target (bit-stable 16384^2 braid-class
terrain on N>=2 hosts) needs more than one device; this script proves
the sharded program BUILDS at that scale and prints XLA's per-device
memory analysis of it - run it after any state-layout change. It runs
on CPU devices only (a CPU rehearsal; nothing here touches a GPU).

Usage: PYTHONPATH=. python benchmarks/compile_16k.py
"""
import os, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.sharding import NamedSharding
import soillib_tpu as soil
from soillib_tpu.parallel.mesh import make_mesh, state_specs
from soillib_tpu.parallel.erosion import make_sharded_erode_fn

mesh = make_mesh((2, 4))
N = 16384
param = soil.ErosionParams()
param.transportIterations = 32
param.trackAlbedo = False
scale = (0.078, 0.078, 4.0)
tmpl = soil.ErosionState.zeros((8, 8), rainfall=1.0, uplift=0.0)
specs = state_specs(tmpl, mesh)

def leaf_abs(t, spec):
    shp = t.shape
    if shp[-2:] == (8, 8):
        shp = shp[:-2] + (N, N)
    return jax.ShapeDtypeStruct(shp, t.dtype,
                                sharding=NamedSharding(mesh, spec))

abstract = jax.tree_util.tree_map(leaf_abs, tmpl, specs)
fn = make_sharded_erode_fn(mesh, scale, param, 1, state_template=tmpl)
key = jax.ShapeDtypeStruct((2,), jnp.uint32)
t0 = time.time()
lowered = fn.lower(abstract, key)
print("lowered in", round(time.time()-t0, 1), "s", flush=True)
compiled = lowered.compile()
print("compiled in", round(time.time()-t0, 1), "s", flush=True)
ma = compiled.memory_analysis()
try:
    print("output bytes:", ma.output_size_in_bytes / 2**30, "GiB")
    print("temp bytes:", ma.temp_size_in_bytes / 2**30, "GiB")
    print("argument bytes:", ma.argument_size_in_bytes / 2**30, "GiB")
    tot = (ma.output_size_in_bytes + ma.temp_size_in_bytes
           + ma.argument_size_in_bytes)
    print("TOTAL per-device GiB:", tot / 2**30 / 8)
except Exception as e:
    print("memory_analysis:", ma)
print("16K SHARDED COMPILE OK", flush=True)
