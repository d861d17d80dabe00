"""Halo (ghost-cell) protocol — the seam between single-device and
block-decomposed execution.

Every radius-r stencil in the framework is written against this protocol:

    padded = halo.pad(field, fill)     # add an r-wide ring of neighbor data
    ...radius-r stencil arithmetic on `padded`...
    result = halo.crop(stencil_out)    # drop the ring

On a single device `NO_HALO` makes both calls the identity, so the ops run
exactly as plain jnp stencils (their internal `_shift` fills supply the
boundary conditions). Inside `shard_map` on a 2-D device mesh,
`soillib_tpu.parallel.ShardHalo` implements `pad` with `jax.lax.ppermute`
neighbor exchanges (NCCL between cards), filling the ring with the neighboring block's
edge data — and with the *global* boundary condition (`fill`) only at true
domain edges. Because the fills match, a sharded run is numerically
equivalent to the single-device run: bitwise for the pad/crop stencil ops
themselves (elementwise after the pad), and to float32 roundoff for the
composed steps, whose surrounding arithmetic XLA may schedule differently
per backend (asserted at rtol=1e-4 in tests/test_parallel.py).

The reference needs none of this: CUDA kernels read any cell of global
memory directly (SURVEY.md §2.10). Across devices the halo exchange is the
explicit analog of that implicit global visibility.

Fill modes:
  * a float (0.0, nan, ...): constant ring at the domain boundary
    (matches `ops.stencil._shift`'s constant fill);
  * "edge": clamp-to-edge replication (matches `_shift_edge` and the creep
    kernel's clamp-to-self substitution, erosion.cu:655-658).
"""

from __future__ import annotations


class Halo:
    """Base protocol. Radius-1 by default; ops needing wider rings (the
    ±16-tap blur) request their radius explicitly via `pad(..., radius=)`."""

    def pad(self, arr, fill, radius: int = 1):
        raise NotImplementedError

    def crop(self, arr, radius: int = 1):
        raise NotImplementedError

    def global_offsets(self, block_shape):
        """(x0, y0, W_global, H_global) of this block in the global grid —
        for ops that emit global flat indices (the receiver graphs)."""
        raise NotImplementedError

    def run_transport(self, E, att, vx, vy, iters: int):
        """`iters` rounds of the upwind transport fixed point
        G <- PUSH(att * (E + G)) with channel-FIRST E, att (C, W, H) and
        (W, H) direction components. Single-device: one fused push per
        round (ops/sweep.py). Sharded: K-blocked ppermute halo exchange."""
        raise NotImplementedError

    def run_cohort(self, st0, aux, rules, iters: int, Llen, closure=None,
                   tol: float = 0.0):
        """`iters` rounds of the age-structured cohort sweep (nonlinear
        per-particle state transport, ops/cohort.py) -> (C, W, H)
        deposits. Single-device: the per-round loop of ops/cohort.py.
        Sharded: K-blocked ppermute exchange of the
        cohort state. `closure` is an ops.cohort.CohortClosure (None ->
        the SOIL_COHORT_* env defaults). `tol` > 0 enables the
        convergence-adaptive depth exit (ops/cohort.py carried_live):
        `iters` becomes an upper bound and rounds run only while
        cohorts still carry deposit mass above tol."""
        raise NotImplementedError


class NoHalo(Halo):
    """Single-device: identity pad/crop; push is the plain upwind operator."""

    def pad(self, arr, fill, radius: int = 1):
        return arr

    def crop(self, arr, radius: int = 1):
        return arr

    def pad_cf(self, arr, fill, radius: int = 1):
        return arr

    def crop_cf(self, arr, radius: int = 1):
        return arr

    def global_offsets(self, block_shape):
        return 0, 0, int(block_shape[0]), int(block_shape[1])

    def run_transport(self, E, att, vx, vy, iters: int):
        from soillib_tpu.ops import sweep

        return sweep.run_transport(E, att, vx, vy, iters)

    def run_cohort(self, st0, aux, rules, iters: int, Llen, closure=None,
                   tol: float = 0.0):
        from soillib_tpu.ops import cohort

        return cohort.run_cohort(st0, aux, rules, iters, Llen, closure,
                                 tol=tol)


NO_HALO = NoHalo()
