"""Block-decomposed coupled erosion (the multi-device north-star workload).

`make_sharded_erode_fn` wraps the exact same `erode_step` physics in
`shard_map` over a 2-D mesh: every field is block-decomposed P("X", "Y"),
and a `ShardHalo` threads neighbor exchanges through each radius-1
stencil and each upwind transport round (see core/halo.py for why the
result is numerically equivalent — bitwise for the pad/crop stencil ops,
float32-roundoff-close for the composed step — to the single-device run).

Communication cost per step with the default config: 2 gradient exchanges +
2 transport-loop exchange sequences (iters rounds each) + 1 creep exchange,
all radius-1 edge slabs — O(block-edge) bytes per round over NVLink while the
stencil does O(block-area) FLOPs, so halo time vanishes for blocks ≳ 512².

Ref analog: none — the reference is single-GPU (SURVEY.md §2.10); this is
the scale-out the north star demands (BASELINE.json).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from soillib_tpu.models.params import ErosionParams
from soillib_tpu.models.simulation import ErosionState, erode_step
from soillib_tpu.parallel.halo import ShardHalo
from soillib_tpu.parallel.mesh import check_divisible, grid_spec, shard_state


def make_sharded_erode_fn(mesh, scale, param: ErosionParams, steps: int = 1,
                          state_template: ErosionState = None):
    """Jitted fn(state, key) -> state after `steps` coupled erosion steps,
    2-D block-decomposed over `mesh`.

    `state` leaves must be (W, H[, C]) with W, H divisible by the mesh
    shape; use `parallel.shard_state` to place an existing state. The
    transport method must be "field" (the particle estimator does not
    shard; SURVEY.md §7 "hard parts").

    `state_template`: pass the state (or one with the same leaf shapes)
    when it holds broadcastable (1, 1) constant fields (ErosionState.zeros
    scalar args) — those leaves are replicated instead of block-sharded.
    """
    if param.transportMethod != "field":
        raise ValueError("sharded erosion requires param.transportMethod='field'")
    halo = ShardHalo(mesh.devices.shape, mesh.axis_names)
    # Per-field specs: (W, H) leaves shard both dims; channel-first
    # (C, W, H) leaves replicate the channel dim.
    spec2 = P(*mesh.axis_names)
    spec3 = P(None, *mesh.axis_names)
    if state_template is not None:
        from soillib_tpu.parallel.mesh import state_specs

        state_spec = state_specs(state_template, mesh)
    else:
        state_spec = ErosionState(
            layers=spec3, rainfall=spec2, uplift=spec2, discharge=spec2,
            mass=spec2, momentum=spec3, debris=spec2, debris_momentum=spec3,
            albedo_bedrock=spec3, albedo_surface=spec3, albedo_fluvial=spec3,
            albedo_debris=spec3,
        )
    scale = tuple(float(s) for s in scale)
    frozen = param.freeze()

    def local_steps(state, key):
        p = ErosionParams()
        for name, value in frozen:
            setattr(p, name, value)

        def body(i, carry):
            st, k = carry
            k, sub = jax.random.split(k)
            return erode_step(st, scale, p, sub, halo=halo), k

        state, _ = jax.lax.fori_loop(0, steps, body, (state, key))
        return state

    sharded = shard_map(
        local_steps,
        mesh=mesh,
        in_specs=(state_spec, P()),
        out_specs=state_spec,
        check_vma=False,
    )

    @jax.jit
    def fn(state, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)
        return sharded(state, key)

    return fn


def sharded_erode(state: ErosionState, mesh, scale, param: ErosionParams,
                  steps: int = 1, key=None) -> ErosionState:
    """Convenience one-shot: place `state` on the mesh and run `steps`."""
    W, H = state.rainfall.shape
    check_divisible((W, H), mesh)
    state = shard_state(state, mesh)
    return make_sharded_erode_fn(mesh, scale, param, steps)(state, key)
