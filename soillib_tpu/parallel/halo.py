"""Halo exchange over the device mesh (`jax.lax.ppermute` inside shard_map).

Implements the `core.halo.Halo` protocol for 2-D block decomposition: `pad`
grows each block by an r-wide ring holding the neighboring blocks' edge
slabs, exchanged as two sequential non-periodic shifts (x first, then y on
the already-x-padded block, so corner cells pick up the diagonal neighbor's
data in the second hop — no separate corner messages, the standard 2-hop
corner trick). Each shift is a neighbor ppermute that XLA lowers to a
collective-permute (NCCL over NVLink between the cards of one host); the
payload per step is one edge slab (r × block-edge cells), a few KB–MB.

Global-boundary blocks fill their outward-facing ring with the op's own
boundary condition (`fill`), which is what makes sharded execution
numerically equivalent to single-device execution — bitwise for the
pad/crop stencil ops, float32-roundoff-close for composed steps (see
core/halo.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import lax

from soillib_tpu.core.halo import Halo

# Trace-time halo-traffic ledger: while enabled (the `halo_ledger`
# context manager), every exchange_axis call with a real neighbor
# (n_blocks > 1) adds its per-device ppermute payload here, so the
# scaling model's communication inputs are MEASURED from the traced
# program, not assumed (tests/test_parallel.py asserts them).  OPT-IN:
# appending on every trace of every sharded program would grow a
# module global without bound in a long-lived multi-config process.
# Entries are (axis_name, bytes_per_device).
HALO_BYTES = []
_LEDGER_ON = False


class halo_ledger:
    """`with halo_ledger() as entries:` — clear HALO_BYTES, record the
    traffic of every halo exchange traced inside the block."""

    def __enter__(self):
        global _LEDGER_ON
        HALO_BYTES.clear()
        _LEDGER_ON = True
        return HALO_BYTES

    def __exit__(self, *exc):
        global _LEDGER_ON
        _LEDGER_ON = False
        return False

def _overlap_enabled() -> bool:
    """Opt-in interior/boundary-band overlap schedule for the K-blocked
    paths (see run_cohort).  OFF by default: the four 3K-wide boundary
    bands are advanced a second time, which costs ~12K/B of a full pass
    for a B-wide block, while the exchange it hides is one K-wide slab
    per side (traffic recorded via HALO_BYTES); whether the overlap pays
    on a given mesh is a measurement, not an argument.  Read at trace
    time so tests can toggle it per-call."""
    return os.environ.get("SOIL_HALO_OVERLAP", "0") == "1"


def _fill_slab(slab_like, arr, fill, axis: int, lo: bool, radius: int):
    """Boundary-ring values: constant, or clamp-to-edge replication."""
    if isinstance(fill, str):
        if fill != "edge":
            raise ValueError(f"unknown fill mode: {fill!r}")
        n = arr.shape[axis]
        edge = lax.slice_in_dim(arr, 0, 1, axis=axis) if lo else lax.slice_in_dim(
            arr, n - 1, n, axis=axis
        )
        reps = [1] * arr.ndim
        reps[axis] = radius
        return jnp.tile(edge, reps)
    return jnp.full_like(slab_like, fill)


def exchange_axis(arr, axis_name: str, n_blocks: int, axis: int, fill, radius: int):
    """Pad `arr` along `axis` with the neighboring blocks' edge slabs.

    `n_blocks` is the static mesh extent along `axis_name`; the shift is
    non-periodic (ppermute drops the wrap-around pair), and the two domain-
    boundary blocks overwrite their undelivered ring with `fill`.
    """
    n = arr.shape[axis]
    if radius > n:
        raise ValueError(f"halo radius {radius} exceeds block extent {n}")
    hi_slab = lax.slice_in_dim(arr, n - radius, n, axis=axis)  # → right nbr
    lo_slab = lax.slice_in_dim(arr, 0, radius, axis=axis)      # → left nbr

    if n_blocks > 1:
        fwd = [(i, i + 1) for i in range(n_blocks - 1)]
        bwd = [(i + 1, i) for i in range(n_blocks - 1)]
        if _LEDGER_ON:
            HALO_BYTES.append(
                (axis_name,
                 (hi_slab.size + lo_slab.size) * hi_slab.dtype.itemsize)
            )
        from_left = lax.ppermute(hi_slab, axis_name, fwd)
        from_right = lax.ppermute(lo_slab, axis_name, bwd)
        idx = lax.axis_index(axis_name)
        from_left = jnp.where(
            idx == 0, _fill_slab(from_left, arr, fill, axis, True, radius), from_left
        )
        from_right = jnp.where(
            idx == n_blocks - 1,
            _fill_slab(from_right, arr, fill, axis, False, radius),
            from_right,
        )
    else:
        from_left = _fill_slab(hi_slab, arr, fill, axis, True, radius)
        from_right = _fill_slab(lo_slab, arr, fill, axis, False, radius)

    return jnp.concatenate([from_left, arr, from_right], axis=axis)


class ShardHalo(Halo):
    """Halo provider bound to a 2-D mesh; use inside `shard_map` only.

    Args:
      mesh_shape: static (px, py) block counts (mesh.devices.shape).
      axis_names: the mesh axis names, default ("X", "Y").
    """

    def __init__(self, mesh_shape, axis_names=("X", "Y")):
        self.px, self.py = int(mesh_shape[0]), int(mesh_shape[1])
        self.ax_name, self.ay_name = axis_names

    def pad(self, arr, fill, radius: int = 1):
        arr = exchange_axis(arr, self.ax_name, self.px, 0, fill, radius)
        return exchange_axis(arr, self.ay_name, self.py, 1, fill, radius)

    def crop(self, arr, radius: int = 1):
        r = radius
        return arr[r:-r, r:-r, ...]

    def global_offsets(self, block_shape):
        bw, bh = int(block_shape[0]), int(block_shape[1])
        x0 = lax.axis_index(self.ax_name) * bw
        y0 = lax.axis_index(self.ay_name) * bh
        return x0, y0, bw * self.px, bh * self.py

    def pad_cf(self, arr, fill, radius: int = 1):
        """Pad the LAST two (spatial) dims — channel-first layout."""
        arr = exchange_axis(
            arr, self.ax_name, self.px, arr.ndim - 2, fill, radius
        )
        return exchange_axis(
            arr, self.ay_name, self.py, arr.ndim - 1, fill, radius
        )

    def crop_cf(self, arr, radius: int = 1):
        r = radius
        return arr[..., r:-r, r:-r]

    def run_transport(self, E, att, vx, vy, iters: int):
        """Temporally-blocked distributed transport: one K-wide halo
        exchange per K rounds, with the K rounds advanced entirely
        block-locally — the trapezoid correctness argument of
        ops/sweep.py, applied at the block boundary.

        Falls back to a per-round 1-cell exchange when blocks are
        narrower than K."""
        from soillib_tpu.ops import sweep as S

        K = S.HALO_K
        bw, bh = E.shape[-2], E.shape[-1]
        if bw < K or bh < K:
            return self._run_transport_per_round(E, att, vx, vy, iters)

        Ep = self.pad_cf(E, 0.0, K)
        attp = self.pad_cf(att, 0.0, K)
        vxp = self.pad_cf(vx, 0.0, K)
        vyp = self.pad_cf(vy, 0.0, K)

        advance = S.transport_advance_reference

        G = jnp.zeros_like(E)
        n_full, rem = divmod(int(iters), K)
        if n_full:
            # lax.scan bounds buffer liveness to one pass.
            def body(G, _):
                Gp = self.pad_cf(G, 0.0, K)
                return self.crop_cf(advance(Gp, Ep, attp, vxp, vyp, K), K), None

            G, _ = jax.lax.scan(body, G, None, length=n_full)
        if rem:
            Gp = self.pad_cf(G, 0.0, K)
            G = self.crop_cf(advance(Gp, Ep, attp, vxp, vyp, rem), K)
        return G

    def run_cohort(self, st0, aux, rules, iters: int, Llen, closure=None,
                   tol: float = 0.0):
        """K-blocked distributed cohort sweep: exchange a K-wide ring of
        the cohort state per K rounds, advance the K rounds block-locally,
        keep the block interior of state and deposits. Same trapezoid argument
        as `run_transport`, applied to the nonlinear round.

        `tol` > 0 enables the convergence-adaptive depth exit between
        passes; the live/gauge channel sums are psum'd over the mesh so
        every block takes the identical (replicated) exit decision.

        Falls back to a per-round 1-cell exchange for blocks narrower
        than K."""
        from soillib_tpu.ops import cohort as CO
        from soillib_tpu.ops.sweep import HALO_K as K

        st0 = CO.as_stack(st0)  # blocks are small; ppermute pads need
        aux = CO.as_stack(aux)  # the stacked form
        bw, bh = st0.shape[-2], st0.shape[-1]
        if bw < K or bh < K:
            return self._run_cohort_per_round(
                st0, aux, rules, iters, Llen, closure, tol
            )

        auxp = self.pad_cf(aux, 0.0, K)

        def advance(stp, axp, rules, r, Llen):
            return CO.cohort_advance_reference(stp, axp, rules, r, Llen,
                                               closure=closure)

        ST = st0
        C = CO.n_deposits(st0.shape[0], closure)
        G = jnp.zeros((C,) + st0.shape[1:], st0.dtype)
        n_full, rem = divmod(int(iters), K)
        overlap = _overlap_enabled() and bw >= 4 * K and bh >= 4 * K

        def pass_seq(ST, r):
            """Sequential schedule: exchange, then one padded advance."""
            STp = self.pad_cf(ST, 0.0, K)
            stn, gp = advance(STp, auxp, rules, r, Llen)
            return self.crop_cf(stn, K), self.crop_cf(gp, K)

        def pass_overlap(ST, r):
            """Interior/boundary-band split (see _OVERLAP).

            The K-round advance of the block INTERIOR needs no fresh
            halo (the trapezoid argument inset by K), so it carries no
            data dependency on the ppermute ring — XLA's async
            collectives can run the exchange under it.  The four
            boundary bands (3K-wide input strips: K fresh ring + 2K own
            edge) then advance with the arrived ring and their valid
            K-wide output frames replace the interior pass's (garbage)
            frame.  x-bands span all columns and y-bands all rows, so
            the corner outputs are computed twice from identical inputs
            (bitwise-equal; either copy may win the paste)."""
            STp = self.pad_cf(ST, 0.0, K)
            sti, gi = advance(ST, aux, rules, r, Llen)

            def band(sl_rows, sl_cols, vr, vc):
                stb, gb = advance(
                    STp[:, sl_rows, sl_cols], auxp[:, sl_rows, sl_cols],
                    rules, r, Llen,
                )
                return stb[:, vr, vc], gb[:, vr, vc]

            full = slice(K, K + bh)
            st_xl, g_xl = band(slice(0, 3 * K), slice(None),
                               slice(K, 2 * K), full)
            st_xh, g_xh = band(slice(bw - K, bw + 2 * K), slice(None),
                               slice(K, 2 * K), full)
            fullr = slice(K, K + bw)
            st_yl, g_yl = band(slice(None), slice(0, 3 * K),
                               fullr, slice(K, 2 * K))
            st_yh, g_yh = band(slice(None), slice(bh - K, bh + 2 * K),
                               fullr, slice(K, 2 * K))

            def paste(interior, xl, xh, yl, yh):
                mid = jnp.concatenate(
                    [yl[:, K:bw - K], interior[:, K:bw - K, K:bh - K],
                     yh[:, K:bw - K]], axis=2)
                return jnp.concatenate([xl, mid, xh], axis=1)

            return (paste(sti, st_xl, st_xh, st_yl, st_yh),
                    paste(gi, g_xl, g_xh, g_yl, g_yh))

        one_pass = pass_overlap if overlap else pass_seq

        def live_gauge(ST, G):
            """Mesh-global (psum'd, replicated) convergence metrics."""
            names = (self.ax_name, self.ay_name)
            live = jax.lax.psum(CO.carried_live(ST, closure), names)
            gauge = jax.lax.psum(CO.deposit_gauge(G), names)
            return live, gauge

        if tol and tol > 0.0 and n_full:
            contractive = bool(getattr(rules, "contractive", False))

            def cond(carry):
                i, ST, G = carry
                live, gauge = live_gauge(ST, G)
                remaining = jnp.float32(iters) - jnp.float32(K) * i
                return (i < n_full) & ~CO.tail_converged(
                    live, gauge, remaining, tol, contractive
                )

            def body(carry):
                i, ST, G = carry
                stn, gp = one_pass(ST, K)
                return i + 1.0, stn, G + gp

            _, ST, G = jax.lax.while_loop(
                cond, body, (jnp.float32(0.0), ST, G)
            )
            if rem:
                live, gauge = live_gauge(ST, G)
                done = CO.tail_converged(live, gauge, rem, tol,
                                         contractive)

                def tail(st, g):
                    _, gp = one_pass(st, rem)
                    return g + gp

                G = jax.lax.cond(done, lambda st, g: g, tail, ST, G)
            return G
        if n_full:
            # lax.scan bounds buffer liveness to one pass.
            def body(carry, _):
                ST, G = carry
                stn, gp = one_pass(ST, K)
                return (stn, G + gp), None

            (ST, G), _ = jax.lax.scan(body, (ST, G), None, length=n_full)
        if rem:
            _, gp = one_pass(ST, rem)
            G = G + gp
        return G

    def _run_cohort_per_round(self, st0, aux, rules, iters: int, Llen,
                              closure=None, tol: float = 0.0):
        """Per-round cohort-state halo exchange (1-cell ppermute/round)."""
        from soillib_tpu.ops import cohort as CO
        from soillib_tpu.ops.cohort import cohort_round, n_deposits, shift_push

        def push(payloads):
            return self.crop_cf(
                shift_push(tuple(
                    None if p is None else self.pad_cf(p, 0.0)
                    for p in payloads
                ))
            )

        C = n_deposits(st0.shape[0], closure)
        G0 = jnp.zeros((C,) + st0.shape[1:], st0.dtype)

        if tol and tol > 0.0:
            names = (self.ax_name, self.ay_name)
            contractive = bool(getattr(rules, "contractive", False))

            def cond(carry):
                i, st, G = carry
                live = jax.lax.psum(CO.carried_live(st, closure), names)
                gauge = jax.lax.psum(CO.deposit_gauge(G), names)
                return (i < iters) & ~CO.tail_converged(
                    live, gauge, jnp.float32(iters) - i, tol, contractive
                )

            def body(carry):
                i, st, G = carry
                st, G = cohort_round(st, G, aux, rules, Llen, push, closure)
                return i + 1.0, st, G

            _, _, G = jax.lax.while_loop(
                cond, body, (jnp.float32(0.0), st0, G0)
            )
            return G

        def body(_, carry):
            st, G = carry
            return cohort_round(st, G, aux, rules, Llen, push, closure)

        _, G = jax.lax.fori_loop(0, int(iters), body, (st0, G0))
        return G

    def _run_transport_per_round(self, E, att, vx, vy, iters: int):
        """Per-round payload halo exchange (1-cell ppermute per round)."""
        from soillib_tpu.ops.sweep import upwind_push_cf

        vxp = self.pad_cf(vx, 0.0)
        vyp = self.pad_cf(vy, 0.0)

        def body(_, G):
            payload = self.pad_cf(att * (E + G), 0.0)
            return self.crop_cf(upwind_push_cf(payload, vxp, vyp))

        return jax.lax.fori_loop(0, iters, body, jnp.zeros_like(E))
