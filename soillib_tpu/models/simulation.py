"""Coupled erosion simulation driver.

The reference composes a step in Python (legacy `soil.erode(model, data,
track, param, 1)`, decomposed into the kernels bound at model.cpp:237-351;
call stack in SURVEY.md §3.1):

    transport_fluvial -> transport_debris -> mass_transfer -> mass_creep
    -> apply delta to layers

Here the whole step is ONE jitted pure function over an `ErosionState`
pytree — XLA fuses the stencil chain; under `shard_map` the same function
runs 2-D block-decomposed on a device mesh (soillib_tpu.parallel).

The map_t/data_t/track split of the reference collapses into a single
state: `track` (flux accumulators) are internal to the transport kernels,
and the `lrate` learning-rate blend of the legacy driver is applied to the
transported fields: new = (1 - lrate) * old + lrate * estimate.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from soillib_tpu.core.halo import NO_HALO
from soillib_tpu.models.erosion import (
    mass_creep,
    mass_transfer,
    transport_debris,
    transport_fluvial,
)
from soillib_tpu.models.params import ErosionParams


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ErosionState:
    """Full prognostic state of the coupled erosion model.

    Mirrors the reference's model (map_t: height/sediment/rainfall/uplift)
    + data (data_t: discharge/momentum/mass/debris/debris_momentum) + the
    albedo instrumentation fields, as one pytree.
    """

    layers: jax.Array            # (2, W, H) bedrock, sediment (dimensionless)
    rainfall: jax.Array          # (W, H)
    uplift: jax.Array            # (W, H)
    discharge: jax.Array         # (W, H) water height
    mass: jax.Array              # (W, H) suspended fluvial sediment
    momentum: jax.Array          # (2, W, H)
    debris: jax.Array            # (W, H)
    debris_momentum: jax.Array   # (2, W, H)
    albedo_bedrock: jax.Array    # (3, W, H)
    albedo_surface: jax.Array    # (3, W, H)
    albedo_fluvial: jax.Array    # (3, W, H)
    albedo_debris: jax.Array     # (3, W, H)

    # Multichannel fields are channel-FIRST so the minor (contiguous)
    # dimension is always spatial.

    @property
    def height(self):
        """Merged height (layer_merge, erosion.cu:733-757)."""
        return self.layers[0] + self.layers[1]

    @property
    def bedrock(self):
        return self.layers[0]

    @property
    def sediment(self):
        return self.layers[1]

    def replace(self, **kw) -> "ErosionState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def zeros(shape, height=None, rainfall=None, uplift=None, sediment=None,
              albedo_bedrock=None, albedo_surface=None):
        """Fresh state on a (W, H) grid; `height` initializes bedrock.

        `rainfall`/`uplift` given as Python scalars (and the albedos as
        3-colors) are stored as broadcastable (1, 1)/(3, 1, 1) constant
        fields: a constant that only enters elementwise arithmetic needs
        4 bytes of device memory instead of a full grid (rainfall/uplift/
        albedo_bedrock pass through every step unchanged — 5 full-grid
        fields of arguments plus as many pass-through output copies;
        with `param.trackAlbedo = False` the other three albedo fields
        stay constant too). Arrays are kept as given. Note
        `soillib_tpu.models.multiscale` resamples states by field shape
        and needs full-size fields."""
        W, H = int(shape[0]), int(shape[1])
        f = lambda *c: jnp.zeros((*c, W, H), jnp.float32)

        def const2(v, default):
            if v is None:
                return default()
            a = jnp.asarray(v, jnp.float32)
            if a.size == 1 and a.ndim != 2:
                # Normalize scalar-like inputs (0-d, shape-(1,), (1,1,1)...)
                # to the compact (1, 1) form parallel/mesh.leaf_spec detects;
                # a stray shape-(1,) leaf otherwise gets a 3-axis PartitionSpec
                # and fails opaquely at shard time.
                return a.reshape(1, 1)
            if a.ndim != 2:
                raise ValueError(
                    f"scalar field must be a scalar or a (W, H) array, got "
                    f"shape {a.shape}"
                )
            return a

        def const3(v, default):
            if v is None:
                return default
            a = jnp.asarray(v, jnp.float32)
            return a.reshape(3, 1, 1) if a.shape == (3,) else a

        bed = jnp.asarray(height, jnp.float32) if height is not None else f()
        sed = jnp.asarray(sediment, jnp.float32) if sediment is not None else f()
        white = jnp.ones((3, W, H), jnp.float32)
        alb_bed = const3(albedo_bedrock, white)
        alb_surf = const3(albedo_surface, white)
        return ErosionState(
            layers=jnp.stack([bed, sed], axis=0),
            rainfall=const2(rainfall,
                            lambda: jnp.ones((W, H), jnp.float32)),
            uplift=const2(uplift, f),
            discharge=f(),
            mass=f(),
            momentum=f(2),
            debris=f(),
            debris_momentum=f(2),
            albedo_bedrock=alb_bed,
            albedo_surface=alb_surf,
            albedo_fluvial=alb_surf,
            albedo_debris=alb_surf,
        )


def erode_step(
    state: ErosionState, scale, param: ErosionParams, key=None, halo=NO_HALO
) -> ErosionState:
    """One coupled erosion step (traceable; see module docstring).

    `halo` selects execution mode: the default runs single-device; a
    `parallel.ShardHalo` (inside shard_map) runs the identical arithmetic
    2-D block-decomposed with halo exchanges (see core/halo.py).
    """
    p = param
    lr = p.lrate

    if key is None:
        key = jax.random.PRNGKey(0)
    kf, kd = jax.random.split(key)

    dis, mas, mom, alb_f = transport_fluvial(
        state.layers, state.rainfall, state.discharge, state.mass,
        state.momentum, state.albedo_surface, scale, p, key=kf, halo=halo,
    )
    # Sequence the two transport solves: they are data-independent, and
    # XLA's scheduler may otherwise interleave both cohort loops,
    # keeping BOTH solves' working sets live at once. The barrier is an
    # identity; each solve already fills the device, so running them in
    # turn costs nothing.
    dis, mas, mom, alb_f, d_layers, d_deb, d_dmom, d_alb = \
        jax.lax.optimization_barrier(
            (dis, mas, mom, alb_f, state.layers, state.debris,
             state.debris_momentum, state.albedo_surface)
        )
    deb, dmom, alb_d = transport_debris(
        d_layers, d_deb, d_dmom, d_alb, scale, p, key=kd, halo=halo,
    )

    blend = lambda old, new: (1.0 - lr) * old + lr * new
    dis = blend(state.discharge, dis)
    mas = blend(state.mass, mas)
    mom = blend(state.momentum, mom)
    deb = blend(state.debris, deb)
    dmom = blend(state.debris_momentum, dmom)

    delta = jnp.zeros_like(state.layers)
    delta, alb_s = mass_transfer(
        delta, state.layers, state.uplift, dis, mas, mom, deb, dmom,
        state.albedo_bedrock, alb_f, alb_d, state.albedo_surface, scale, p,
        halo=halo,
    )
    delta = mass_creep(delta, state.layers, scale, p, halo=halo)
    layers = state.layers + delta

    return state.replace(
        layers=layers,
        discharge=dis,
        mass=mas,
        momentum=mom,
        debris=deb,
        debris_momentum=dmom,
        albedo_surface=alb_s,
        albedo_fluvial=alb_f,
        albedo_debris=alb_d,
    )


def _canonicalize(state: ErosionState, param: ErosionParams) -> ErosionState:
    """Broadcast compact (3, 1, 1) albedo fields to full size when albedo
    IS tracked (they evolve, so outputs are full-size; materializing them
    up front keeps step output shapes — and fori_loop carries — stable).
    With trackAlbedo=False they pass through untouched and stay 4 bytes."""
    if not param.trackAlbedo:
        return state
    W, H = state.layers.shape[-2:]
    kw = {}
    for f in ("albedo_surface", "albedo_fluvial", "albedo_debris"):
        a = getattr(state, f)
        if a.shape[-2:] == (1, 1):
            kw[f] = jnp.broadcast_to(a, (3, W, H))
    return state.replace(**kw) if kw else state


@functools.lru_cache(maxsize=32)
def _compiled_step(frozen_params, scale, steps, donate=False):
    param = ErosionParams()
    for name, value in frozen_params:
        setattr(param, name, value)

    def fn(state, key):
        state = _canonicalize(state, param)
        if steps == 1:
            # No fori_loop wrapper for a single step: the while-loop level
            # pins the full state carry alongside the body's temps and
            # blocks XLA from aliasing the step output onto the input.
            key, sub = jax.random.split(key)
            return erode_step(state, scale, param, sub)

        def body(i, carry):
            st, k = carry
            k, sub = jax.random.split(k)
            return erode_step(st, scale, param, sub), k

        state, _ = jax.lax.fori_loop(0, steps, body, (state, key))
        return state

    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_erode_fn(param: ErosionParams, scale, steps: int = 1,
                  donate: bool = False):
    """Jit-compiled erosion driver: fn(state, key=None) -> state after
    `steps` coupled steps. Compilation is cached on (params, scale, steps).

    `donate=True` donates the input state's buffers to XLA (halves the
    state's device-memory footprint — the in-place behavior the reference gets from
    mutating tensors); the caller's old state becomes invalid, so only use
    it in step-loop patterns like ErosionSim."""
    compiled = _compiled_step(
        param.freeze(), tuple(float(s) for s in scale), int(steps), donate
    )

    def fn(state, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)
        return compiled(state, key)

    # Ahead-of-time view of the same program: fn.lower(state, key)
    # .compile() exposes compile time, memory_analysis() and the HLO.
    fn.lower = compiled.lower
    return fn


def erode(state: ErosionState, scale, param: ErosionParams, steps: int = 1, key=None):
    """Reference-style convenience driver (`soil.erode(...)`,
    erosion_gpu.py:105): runs `steps` coupled steps, jitted + cached."""
    return make_erode_fn(param, scale, steps)(state, key)


class ErosionSim:
    """Stateful convenience wrapper (holds state + scale + params).

    Mirrors the reference's "script is the config" usage:

        sim = ErosionSim(shape=(256, 256), scale=(0.078, 0.078, 4.0), param=p)
        sim.state = sim.state.replace(...)
        for _ in range(512):
            sim.step()
    """

    def __init__(self, shape, scale, param: ErosionParams = None, state: ErosionState = None, seed: int = 0, donate: bool = False):
        self.scale = tuple(float(s) for s in scale)
        self.param = param or ErosionParams()
        self.state = state if state is not None else ErosionState.zeros(shape)
        self.key = jax.random.PRNGKey(seed)
        # Buffer donation halves the state's resident device memory (the
        # old state is replaced each step, so donating is safe), but it
        # invalidates every outside reference to the previous state —
        # hence opt-in.
        self.donate = donate

    def step(self, n: int = 1):
        self.key, sub = jax.random.split(self.key)
        self.state = make_erode_fn(self.param, self.scale, steps=n,
                                   donate=self.donate)(self.state, sub)
        return self.state
