"""Device-mesh construction and field sharding for 2-D domain decomposition.

The scaling axis of this framework is the 2-D grid itself (the reference is
single-GPU; SURVEY.md §2.10): a (W, H) field is block-decomposed over a 2-D
`jax.sharding.Mesh` with axis names ("X", "Y"), axis 0 of every field
sharded over "X" and axis 1 over "Y". Channel dims stay replicated.

Multi-host: call `jax.distributed.initialize()` before `make_mesh()`;
`jax.devices()` then spans every process's cards and the same code runs
unchanged — halo exchanges go through NCCL (NVLink within a host),
checkpoint I/O and host work stay local. Every card reaches every other
at the same rate, so the mesh shape follows the grid alone.
"""

from __future__ import annotations

import math

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("X", "Y")


def factor2(n: int) -> tuple:
    """Most-square (px, py) factorization of n, px * py == n, px <= py."""
    px = int(math.isqrt(n))
    while n % px != 0:
        px -= 1
    return (px, n // px)


def make_mesh(shape=None, devices=None, axis_names=AXES) -> Mesh:
    """2-D device mesh. `shape=None` picks the most-square factorization of
    the device count (a 1-device mesh is (1, 1) — the code path is then
    identical, with all halo fills hitting the global boundary case)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if shape is None:
        shape = factor2(devices.size)
    if shape[0] * shape[1] != devices.size:
        raise ValueError(f"mesh shape {shape} != {devices.size} devices")
    return Mesh(devices.reshape(shape), axis_names)


def grid_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding the two spatial dims of a (W, H) field."""
    return P(*mesh.axis_names)


def leaf_spec(arr, mesh: Mesh) -> P:
    """Spec for a field: (W, H) shards both dims; channel-first (C, W, H)
    replicates the channel dim and shards the spatial ones. Broadcastable
    (…, 1, 1) constant fields (see ErosionState.zeros) are replicated."""
    if arr.shape[-2:] == (1, 1):
        return P()
    if arr.ndim == 2:
        return P(*mesh.axis_names)
    return P(None, *mesh.axis_names)


def state_specs(state, mesh: Mesh):
    """Pytree of PartitionSpecs matching a state pytree's leaves."""
    return jax.tree_util.tree_map(lambda a: leaf_spec(a, mesh), state)


def grid_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, grid_spec(mesh))


def shard_field(arr, mesh: Mesh):
    """Place a (W, H) or channel-first (C, W, H) field block-decomposed."""
    return jax.device_put(arr, NamedSharding(mesh, leaf_spec(arr, mesh)))


def shard_state(state, mesh: Mesh):
    """Place every leaf of a pytree (e.g. ErosionState) block-decomposed
    over the spatial dims (channel dims replicated)."""
    return jax.tree_util.tree_map(lambda a: shard_field(a, mesh), state)


def shard_field_global(arr, mesh: Mesh):
    """Multi-process-safe placement of a host-replicated field: each
    process contributes only its addressable shards of the global array
    (`jax.make_array_from_callback`). Single-process this is equivalent
    to `shard_field`; across processes it is the required form, since
    `device_put` cannot target non-addressable devices."""
    a = np.asarray(arr)
    sharding = NamedSharding(mesh, leaf_spec(a, mesh))
    return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])


def shard_state_global(state, mesh: Mesh):
    """Pytree version of `shard_field_global` (multi-process launch path)."""
    return jax.tree_util.tree_map(lambda a: shard_field_global(a, mesh), state)


def check_divisible(shape, mesh: Mesh, radius: int = 1):
    """Validate that (W, H) splits evenly and blocks are at least `radius`
    wide (a halo exchange only reaches the adjacent block)."""
    px, py = mesh.devices.shape
    W, H = int(shape[0]), int(shape[1])
    if W % px or H % py:
        raise ValueError(f"grid {W}x{H} not divisible by mesh {px}x{py}")
    if W // px < radius or H // py < radius:
        raise ValueError(
            f"blocks {W // px}x{H // py} smaller than halo radius {radius}"
        )
