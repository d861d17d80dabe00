"""Generator utilities: the `soil::yield` equivalent, Python-native.

The reference ships a C++20 coroutine generator, `soil::yield_t`
(util/yield.hpp:24-247): a strict-typed, move-only, single-pass value
generator with cached peeking (`operator bool` / `operator()`,
yield.hpp:160-189), exception propagation out of the coroutine body
(yield.hpp:119-121, 184-186), an iterator adapter (yield.hpp:191-241),
and a `make_yield(...)` helper that packs multiple yielded values into
a tuple (yield.hpp:55-64). Its Python binding is commented out in the
reference (python/source/util.cpp:79-81) because Python generators
already ARE coroutine value generators — so here the equivalent is a
thin wrapper that adds exactly the semantics `yield_t` has and bare
generators lack:

- **peek-without-consume**: ``bool(y)`` advances-and-caches so "is
  there a next value" can be asked before committing to take it, and
  ``y()`` then returns the cached value (one coroutine call per value,
  like retrieve_value/operator() in the reference);
- **strict typing** (optional): the C++ type is fixed by template
  parameter; pass ``value_type=`` to get the same guarantee;
- **single-pass, single-owner**: a C++ handle is destroyed on move and
  a finished coroutine cannot restart; iterating a consumed `yield_t`
  here raises instead of silently yielding nothing.

`prefetch` is the accelerator-side reason to have this layer at all: a
generator of host arrays (e.g. `soil.util.iter_tiff` tiles) becomes a
generator of *device* arrays with the next `depth` transfers already
in flight — JAX dispatch is asynchronous, so `jax.device_put` on the
lookahead items overlaps the host→device copy of tile i+1..i+depth with
the compute consuming tile i. This is the streaming-IO overlap the
reference gets for free from CUDA's async H2D in its import pipeline.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

__all__ = ["yield_t", "make_yield", "prefetch"]

_SENTINEL = object()


def make_yield(*args):
    """Pack yielded values like the reference's `make_yield` helper
    (util/yield.hpp:55-64): one argument passes through unchanged,
    several pack into a tuple (for ``for a, b in y:`` unpacking)."""
    if len(args) == 1:
        return args[0]
    return tuple(args)


class yield_t:
    """Single-pass strict generator handle (util/yield.hpp:24-247).

    Wraps any iterable/generator. Usage mirrors the reference:

        y = soil.yield_t(gen(), value_type=tuple)
        while y:            # operator bool: peek, cache
            a, b = y()      # operator(): take cached value
        # or, equivalently, single-pass iteration:
        for a, b in soil.yield_t(gen()):
            ...

    Exceptions raised inside the generator propagate to the caller at
    the peek/take site, matching the cached-exception rethrow in
    retrieve_value (yield.hpp:181-187).
    """

    __slots__ = ("_it", "_value", "_has_value", "_done", "_consumed",
                 "value_type")

    def __init__(self, iterable: Iterable, value_type: Optional[type] = None):
        self._it: Optional[Iterator] = iter(iterable)
        self._value: Any = _SENTINEL
        self._has_value = False
        self._done = False
        self._consumed = False
        self.value_type = value_type

    # -- handle state -------------------------------------------------
    def _require_live(self):
        if self._it is None:
            raise RuntimeError(
                "yield_t handle was moved or destroyed; a coroutine "
                "handle is single-owner (util/yield.hpp:141-158)")
        if self._consumed:
            raise RuntimeError(
                "yield_t is single-pass and already ran to completion; "
                "construct a new one to iterate again")

    def _retrieve(self):
        """Advance the underlying generator once and cache the value
        (retrieve_value, yield.hpp:178-188)."""
        if self._has_value or self._done:
            return
        self._require_live()
        try:
            v = next(self._it)           # actual coroutine call here
        except StopIteration:
            self._done = True
            self._consumed = True
            return
        if self.value_type is not None and not isinstance(v, self.value_type):
            raise TypeError(
                f"yield_t is strict-typed: expected "
                f"{self.value_type.__name__}, generator yielded "
                f"{type(v).__name__}")
        self._value = v
        self._has_value = True

    # -- operator bool / operator() ----------------------------------
    def __bool__(self) -> bool:
        self._retrieve()
        return not self._done

    def __call__(self):
        self._retrieve()
        if self._done:
            raise StopIteration("yield_t coroutine has completed")
        self._has_value = False
        v, self._value = self._value, _SENTINEL
        return v

    # -- iterator adapter (yield.hpp:191-241) ------------------------
    def __iter__(self):
        # Querying a finished handle is legal (operator bool just reads
        # h_.done()), but STARTING a fresh iteration over a consumed
        # handle is the silent-empty-loop footgun bare generators have —
        # raise instead.
        if self._consumed:
            raise RuntimeError(
                "yield_t is single-pass and already ran to completion; "
                "construct a new one to iterate again")
        while self:
            yield self()

    # -- move semantics (yield.hpp:141-158) --------------------------
    def move(self) -> "yield_t":
        """Transfer ownership to a new handle; this one becomes empty,
        like the reference's move constructor (yield.hpp:143)."""
        self._require_live()
        out = yield_t.__new__(yield_t)
        out._it, self._it = self._it, None
        out._value, out._has_value = self._value, self._has_value
        out._done, out._consumed = self._done, self._consumed
        out.value_type = self.value_type
        return out

    def close(self):
        """Destroy the handle early (~yield_t, yield.hpp:145-148)."""
        it, self._it = self._it, None
        if it is not None and hasattr(it, "close"):
            it.close()


def prefetch(iterable: Iterable, depth: int = 2,
             put: Optional[Callable[[Any], Any]] = None) -> Iterator:
    """Device-prefetching iterator: yield items with the next `depth`
    host→device transfers already dispatched.

    JAX dispatch is asynchronous, so calling `jax.device_put` on the
    lookahead window overlaps the PCIe transfer of upcoming items
    with the compute consuming the current one — double-buffered
    streaming for tile pipelines (`soil.util.iter_tiff` →
    `soil.geotiff`). Leaves of nested structures (tuples of arrays,
    (name, array) pairs) are transferred; non-array leaves pass
    through untouched.

    `put` overrides the transfer (e.g. a `jax.device_put` bound to a
    specific sharding for multi-chip streaming ingest).
    """
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    if put is None:
        import jax
        import numpy as np

        def put(item):
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(x)
                if isinstance(x, (np.ndarray, jax.Array)) else x, item)

    it = iter(iterable)
    window: collections.deque = collections.deque()
    try:
        for item in it:
            window.append(put(item))
            if len(window) >= depth:
                yield window.popleft()
        while window:
            yield window.popleft()
    finally:
        if hasattr(it, "close"):
            it.close()
