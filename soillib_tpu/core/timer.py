"""Wall-clock timer, API-compatible with the reference's `soil.timer`
(util/timer.hpp:15-69; python/source/util.cpp:47-73):

    with soil.timer(soil.ms) as t:
        ...
    print(t.count)

On an asynchronous backend a naive stopwatch only measures dispatch, so the
context exit calls ``jax.block_until_ready`` on any arrays registered via
``t.wait(x)`` — and, when none were registered, synchronizes the backend via
``jax.effects_barrier()`` so the timing covers device execution.
"""

from __future__ import annotations

import time

import jax

# Duration enumerators (mirror soil.ns/us/ms/s binding, util.cpp:41-45).
ns = 0
us = 1
ms = 2
s = 3

_SCALE = {ns: 1e9, us: 1e6, ms: 1e3, s: 1.0}


class timer:
    def __init__(self, unit: int = ms):
        self._unit = unit
        self._start = None
        self._elapsed = 0.0
        self._pending = []

    def wait(self, *arrays):
        """Register arrays to block on at context exit (async-safe timing)."""
        self._pending.extend(arrays)
        return arrays[0] if len(arrays) == 1 else arrays

    def __enter__(self):
        self._pending = []
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._pending:
            jax.block_until_ready(self._pending)
        else:
            jax.effects_barrier()
        self._elapsed = time.perf_counter() - self._start
        return False

    @property
    def count(self) -> int:
        """Elapsed time in the configured unit (integer, like the reference)."""
        return int(self._elapsed * _SCALE[self._unit])

    @property
    def elapsed(self) -> float:
        """Elapsed time in seconds (float; extension over the reference)."""
        return self._elapsed


class profile:
    """XLA-level profiling (SURVEY.md §5: the reference has only the
    stopwatch; here `jax.profiler` traces give per-kernel HBM/FLOP
    timelines viewable in TensorBoard/Perfetto):

        with soil.profile("/tmp/trace"):
            state = step(state, key)
            jax.block_until_ready(state)
    """

    def __init__(self, logdir: str):
        self.logdir = logdir

    def __enter__(self):
        jax.profiler.start_trace(self.logdir)
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        jax.profiler.stop_trace()
        return False
