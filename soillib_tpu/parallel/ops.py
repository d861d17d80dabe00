"""Sharded (block-decomposed) versions of the kernelized ops.

Two execution families:

1. **Stencil ops** (gradient/negslope/laplacian/normal/blur/solve_uniform/
   steepest/direction/random_weighted): wrapped in `shard_map` with a
   `ShardHalo` supplying ghost cells by ppermute. Results are bitwise equal to
   the single-device ops (the halo fills replicate each op's boundary
   condition; see core/halo.py).

2. **Global-graph ops** (`accumulate`, `accumulate_decay`, `slope`,
   `upstream_*`): their pointer-doubling rounds gather/scatter along
   arbitrary global flat indices — long-range, data-dependent communication.
   These run as plain jitted programs on *sharded arrays* (GSPMD): XLA
   partitions each gather/scatter round and inserts the all-to-all
   collectives itself. Call the core ops from soillib_tpu.ops.graph on
   arrays placed with `parallel.shard_field`; no wrapper is needed. (A
   block-local-contraction + boundary-graph refinement is the planned
   optimization; SURVEY.md §7 "hard parts".)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from soillib_tpu.core.grid import D8
from soillib_tpu.ops import filter as _filter
from soillib_tpu.ops import graph as _graph
from soillib_tpu.ops import stencil as _stencil
from soillib_tpu.ops import transport as _transport
from soillib_tpu.parallel.halo import ShardHalo
from soillib_tpu.parallel.mesh import grid_spec

_KW = _filter._KWINDOW


def _halo_of(mesh) -> ShardHalo:
    return ShardHalo(mesh.devices.shape, mesh.axis_names)


@functools.lru_cache(maxsize=256)
def _make_padded_op(op, mesh, fill, radius, static_args):
    """shard_map-wrap `op(field, *static_args)` with an r-ring halo pad.

    Valid when `op` is a local radius-`radius` stencil whose out-of-domain
    reads match `fill` (constant or "edge") — the pad ring then carries
    either neighbor data or the op's own boundary values, and the cropped
    result equals the unsharded op everywhere.
    """
    halo = _halo_of(mesh)
    spec = grid_spec(mesh)

    def local(x):
        return halo.crop(op(halo.pad(x, fill, radius), *static_args), radius)

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    )


def gradient(tensor, scale, mesh):
    """Sharded ops.stencil.gradient (NaN boundary, radius 1)."""
    return _make_padded_op(
        _stencil.gradient, mesh, jnp.nan, 1, (tuple(map(float, scale)),)
    )(tensor)


def negslope(tensor, scale, mesh):
    return _make_padded_op(
        _stencil.negslope, mesh, jnp.nan, 1, (tuple(map(float, scale)),)
    )(tensor)


def laplacian(tensor, scale, mesh):
    """Sharded ops.stencil.laplacian (clamp-to-edge boundary, radius 1)."""
    return _make_padded_op(
        _stencil.laplacian, mesh, "edge", 1, (tuple(map(float, scale)),)
    )(tensor)


def normal(tensor, scale, mesh):
    return _make_padded_op(
        _stencil.normal, mesh, "edge", 1, (tuple(map(float, scale)),)
    )(tensor)


def gaussian_blur(tensor, sigma, mesh):
    """Sharded separable blur: one radius-16 edge-fill exchange covers both
    passes (the ±16-tap window, filter.cu:34); blocks must be ≥ 16 wide."""
    return _make_padded_op(
        _filter.gaussian_blur, mesh, "edge", _KW, (float(sigma),)
    )(tensor)


@functools.lru_cache(maxsize=64)
def _make_graph_op(name, mesh, edge):
    halo = _halo_of(mesh)
    spec = grid_spec(mesh)
    op = getattr(_graph, name)

    def local(h):
        return op(h, edge, halo=halo)

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    )


def steepest(height, edge=D8, *, mesh):
    """Sharded steepest-descent receiver graph (global flat indices)."""
    return _make_graph_op("steepest", mesh, edge)(height)


def direction(height, edge=D8, *, mesh):
    return _make_graph_op("direction", mesh, edge)(height)


def random_weighted(height, edge=D8, seed=0, offset=0, T=1.0, *, mesh, key=None):
    """Sharded stochastic multiple-flow-direction graph. The per-cell
    uniforms are one global threefry draw sliced per block, so the result
    is identical to the single-device op for the same (seed, offset)."""
    if key is None:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), offset)
    h = jnp.asarray(height)
    u = jax.random.uniform(key, h.shape, dtype=h.dtype)
    return _make_rw_op(mesh, edge, float(T))(h, u)


@functools.lru_cache(maxsize=64)
def _make_rw_op(mesh, edge, T):
    halo = _halo_of(mesh)
    spec = grid_spec(mesh)

    def local(h, u):
        return _graph.random_weighted(h, edge, T=T, u=u, halo=halo)

    return jax.jit(
        shard_map(
            local, mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False
        )
    )


def solve_uniform(flow, source, decay, scale=(1.0, 1.0), *, mesh, iterations=None):
    """Sharded deterministic transport solve (ops.transport.solve_uniform,
    method='field'): each upwind round exchanges a 1-ring payload halo."""
    flow = jnp.asarray(flow, jnp.float32)
    W, H = flow.shape[0], flow.shape[1]
    iters = int(iterations) if iterations is not None else (W + H)
    halo = _halo_of(mesh)
    spec = grid_spec(mesh)
    sc = tuple(map(float, scale))

    def local(f, s, d):
        return _transport.solve_uniform(
            f, s, d, sc, method="field", iterations=iters, halo=halo
        )

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=spec,
            check_vma=False,
        )
    )(flow, jnp.asarray(source, jnp.float32), jnp.asarray(decay, jnp.float32))
