"""Multiscale erosion cascade (reference: example/erosion_gpu_multiscale.py).

The reference advances geological time cheaply on a coarse grid, then
bilinearly upsamples every prognostic field and refines detail at finer
resolutions, recomputing the physical cell size from the fixed world
extent at each level (erosion_gpu_multiscale.py:102-148: ksteps =
[(128², 2048), (256², 4), (1000², 4)], pscale = wscale/res at :107-109).

JAX form: each level is its own jitted `erode` program (static
shapes per level, XLA-compiled once per resolution); with a device mesh,
each level runs 2-D block-decomposed and the upsample is a resharding
resize. The "script is the config" — levels are plain (resolution, steps)
tuples.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from soillib_tpu.models.params import ErosionParams
from soillib_tpu.models.simulation import ErosionState, make_erode_fn
from soillib_tpu.ops.resize import resize


def resize_state(state: ErosionState, newres) -> ErosionState:
    """Bilinearly rescale every prognostic field to (newres[0], newres[1]).

    The scaleup() of the reference resizes height, sediment, discharge,
    momentum, rainfall, uplift, and the track fields one by one
    (erosion_gpu_multiscale.py:110-137); here the whole pytree maps through
    one resize. Channel-first (C, W, H) leaves resize per channel.
    """
    nW, nH = int(newres[0]), int(newres[1])

    def leaf(a):
        if a.ndim == 2:
            return resize(a, (nW, nH))
        return jnp.stack([resize(a[c], (nW, nH)) for c in range(a.shape[0])],
                         axis=0)

    return jax.tree_util.tree_map(leaf, state)


def level_scale(world_extent, zscale, res):
    """Physical (sx, sy, sz) of a level: world extent / resolution
    (erosion_gpu_multiscale.py:107-109)."""
    return (
        float(world_extent[0]) / int(res[0]),
        float(world_extent[1]) / int(res[1]),
        float(zscale),
    )


def run_cascade(
    state: ErosionState,
    levels,
    world_extent,
    zscale,
    param: ErosionParams,
    key=None,
    mesh=None,
    on_level=None,
):
    """Run the multiscale cascade.

    Args:
      state: initial state at any resolution.
      levels: sequence of ((W, H), steps) per level, coarse to fine.
      world_extent: fixed world size (wx, wy) [km or m] shared by all levels.
      zscale: height dimensionalization (scale.z).
      param: erosion parameters (shared; the per-level pscale is what makes
        coarse levels advance more geological time per cell).
      key: PRNG key (split per level).
      mesh: optional jax.sharding.Mesh — levels then run block-decomposed
        (soillib_tpu.parallel), with the resize acting as reshard.
      on_level: optional callback(level_index, resolution, state) after
        each level, for checkpointing/plotting.

    Returns the final state.
    """
    if key is None:
        key = jax.random.PRNGKey(0)

    for idx, (res, steps) in enumerate(levels):
        res = (int(res[0]), int(res[1]))
        if (state.rainfall.shape[0], state.rainfall.shape[1]) != res:
            state = resize_state(state, res)
        scale = level_scale(world_extent, zscale, res)
        key, sub = jax.random.split(key)
        if mesh is not None:
            from soillib_tpu import parallel as par

            par.check_divisible(res, mesh)
            state = par.shard_state(state, mesh)
            fn = par.make_sharded_erode_fn(mesh, scale, param, steps=int(steps))
            state = fn(state, sub)
        else:
            state = make_erode_fn(param, scale, steps=int(steps))(state, sub)
        if on_level is not None:
            on_level(idx, res, state)
    return state
