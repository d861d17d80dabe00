"""`silt` compatibility surface — the reference's tensor core, in JAX.

The reference's buffer layer is the separate `silt` package (SURVEY.md
§2.9 reconstructs its API from usage sites: `silt.tensor`, `silt.shape`,
dtypes, hosts, elementwise ops, RNG seeding). In this framework
`jax.Array` IS the tensor core; this module exists so reference-style
scripts (`import silt` / `silt.tensor(...)`, e.g. example/erosion_gpu.py:18,
dem_process.py:72-82) port with minimal edits:

    from soillib_tpu import silt
    t = silt.tensor(silt.float32, silt.shape(512, 512), silt.gpu)
    t = silt.set(t, 1.0)            # functional: returns the new tensor
    arr = t.numpy()

Deviations, on purpose (JAX semantics):
  * ops are FUNCTIONAL — they return new tensors instead of mutating
    (silt.set(t, v) -> t2). Under jit, XLA donation recovers in-place
    memory behavior.
  * `rng` tensors are threefry key arrays, not curandState grids; `seed`
    derives a fresh key array from (seed, offset) like the reference's
    curand_init streams (graph.cu:97-101).
  * host transfer (.gpu()/.cpu()) maps to jax.device_put.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from soillib_tpu.core.grid import Shape as shape  # noqa: F401  (silt.shape)
from soillib_tpu.ops.resize import copy, resize  # noqa: F401

# dtype enumerators (io/tiff.hpp:33-37; op/noise.hpp usage)
float32 = jnp.float32
float64 = jnp.float64
int32 = jnp.int32


class _RngDtype:
    """Marker for RNG-state tensors (`silt.rng`, erosion.hpp:81)."""

    def __repr__(self):
        return "silt.rng"


rng = _RngDtype()


class _Host:
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"silt.{self.name}"


cpu = _Host("cpu")
gpu = _Host("gpu")   # "the accelerator"


class tensor:
    """Thin wrapper matching the silt python tensor surface."""

    def __init__(self, dtype=float32, shp=None, host=None):
        if shp is None:
            raise ValueError("tensor(dtype, shape, host)")
        dims = tuple(shp)
        if isinstance(dtype, _RngDtype):
            # one key per element, derived from seed 0 (reseed with seed())
            n = int(np.prod(dims))
            keys = jax.vmap(jax.random.fold_in, (None, 0))(
                jax.random.PRNGKey(0), jnp.arange(n)
            )
            self.array = keys.reshape(dims + keys.shape[1:])
            self.dtype = rng
        else:
            self.array = jnp.zeros(dims, dtype)
            self.dtype = dtype
        self._place(host)

    @staticmethod
    def from_numpy(arr):
        t = tensor.__new__(tensor)
        t.array = jnp.asarray(arr)
        t.dtype = t.array.dtype
        return t

    @staticmethod
    def _wrap(arr, dtype=None):
        t = tensor.__new__(tensor)
        t.array = arr
        t.dtype = dtype if dtype is not None else arr.dtype
        return t

    def _place(self, host):
        if host is cpu:
            self.array = jax.device_put(
                self.array, jax.devices("cpu")[0]
            )
        elif host is gpu:
            self.array = jax.device_put(self.array, jax.devices()[0])
        return self

    def gpu(self):
        return tensor._wrap(
            jax.device_put(self.array, jax.devices()[0]), self.dtype
        )

    def cpu(self):
        return tensor._wrap(
            jax.device_put(self.array, jax.devices("cpu")[0]), self.dtype
        )

    def numpy(self):
        return np.asarray(self.array)

    def elem(self):
        return int(np.prod(self.array.shape))

    @property
    def shape(self):
        return shape(*self.array.shape)

    def __repr__(self):
        return f"silt.tensor{tuple(self.array.shape)}[{self.dtype}]"


def _arr(t):
    return t.array if isinstance(t, tensor) else jnp.asarray(t)


def _like(t, arr):
    return tensor._wrap(arr, getattr(t, "dtype", None)) if isinstance(t, tensor) else arr


def set(t, value):
    """silt::set (graph.cu:552-553) — functional."""
    a = _arr(t)
    v = _arr(value) if isinstance(value, tensor) else value
    return _like(t, jnp.broadcast_to(jnp.asarray(v, a.dtype), a.shape))


def multiply(t, value):
    return _like(t, _arr(t) * value)


def add(t, value):
    return _like(t, _arr(t) + value)


def clamp(t, lo, hi):
    return _like(t, jnp.clip(_arr(t), lo, hi))


def clone(t):
    return _like(t, jnp.array(_arr(t)))


def seed(t, seed_value: int, offset: int = 0):
    """Re-seed an rng tensor: fresh threefry keys per element, deterministic
    in (seed, offset) like curand_init(seed, n, offset) (graph.cu:97-101)."""
    a = _arr(t)
    dims = a.shape[:-1] if a.ndim and a.shape[-1] == 2 else a.shape
    n = int(np.prod(dims))
    base = jax.random.fold_in(jax.random.PRNGKey(seed_value), offset)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(base, jnp.arange(n))
    out = keys.reshape(tuple(dims) + keys.shape[1:])
    return tensor._wrap(out, rng) if isinstance(t, tensor) else out
