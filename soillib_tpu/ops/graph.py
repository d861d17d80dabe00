"""DEM flow-graph operations (reference: model/graph/graph.cu).

Re-designs for XLA:

* `steepest` / `direction`: the per-cell neighbor loop becomes a vectorized
  argmax over K statically-shifted copies of the height field — one fused
  elementwise pass, no gather (ref kernels: graph.cu:28-91, 202-264).

* `random_weighted`: the per-cell Gibbs CDF + inverse-transform sample
  (graph.cu:104-173) becomes a masked softmax-style cumulative sum over the
  K shifted slope fields plus a threefry uniform draw — deterministic in
  (seed, offset), replacing curand state grids (graph.cu:97-101).

* `accumulate` / `accumulate_decay`: the reference contracts the donor
  forest with an O(log N) rake-compress ping-pong (graph.cu:430-576).
  Here an equivalent O(log N) *pointer-doubling* contraction: with
  M the (nilpotent) weighted receiver matrix — M[j, i] = w_i iff cell i
  drains to j — upstream accumulation is

      A = (sum_k M^k) v = ... (I + M^4)(I + M^2)(I + M) v,

  evaluated in ceil(log2(N)) rounds of

      A    += scatter_add(P, W * A)     # A <- (I + M^(2^j)) A
      W     = W * W[P]; P = P[P]        # square the operator

  where P is the 2^j-step receiver pointer and W the decay product along
  that path. Roots (pits / boundary exits, graph value -1 or self) get
  P = self, W = 0, so their contributions vanish and the recursion is
  total. Each round is two gathers + one scatter-add — fully data-parallel,
  no per-cell lists, no ping-pong buffers.

Edge-decay semantics match my_decay (graph.cu:383-420): the decay value is
taken *at the donor cell*, and diagonal edges (D8 slots 4-7) use
decay^1.414.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from soillib_tpu.core.grid import D4, D8, shifts_for, shift_lengths
from soillib_tpu.core.halo import NO_HALO
from soillib_tpu.ops.stencil import _shift


def _neighbor_stack(h, edge: int, halo=NO_HALO):
    """(K, W, H) stack of neighbor heights (NaN out of the *global* domain;
    under a ShardHalo, block-boundary neighbors come from the exchanged
    ring) and metadata."""
    shifts = shifts_for(edge)
    nan = jnp.float32(jnp.nan)
    hp = halo.pad(h, jnp.nan)
    stack = jnp.stack(
        [halo.crop(_shift(hp, int(dx), int(dy), nan)) for dx, dy in shifts],
        axis=0,
    )
    return stack, shifts, shift_lengths(edge)


def _neighbor_flat_index(shape, edge: int, halo=NO_HALO):
    """(K, W, H) *global* flat index of each neighbor (unclamped -> garbage
    if oob; pair with the NaN mask from `_neighbor_stack`)."""
    W, H = int(shape[0]), int(shape[1])
    x0, y0, Wg, Hg = halo.global_offsets(shape)
    shifts = shifts_for(edge)
    x = x0 + jnp.arange(W, dtype=jnp.int32)[:, None]
    y = y0 + jnp.arange(H, dtype=jnp.int32)[None, :]
    return jnp.stack(
        [(x + int(dx)) * Hg + (y + int(dy)) for dx, dy in shifts], axis=0
    )


def steepest(height, edge: int = D8, halo=NO_HALO):
    """Steepest-descent receiver graph: flat index of the neighbor with the
    steepest positive downhill slope (slope = Δh / ‖shift‖); -1 at local
    minima. Ref: graph.cu:28-91.

    Returns (W, H) int32 (global flat indices under a ShardHalo).
    """
    h = jnp.asarray(height)
    nbrs, shifts, lens = _neighbor_stack(h, edge, halo)
    nind = _neighbor_flat_index(h.shape, edge, halo)

    slopes = (h[None] - nbrs) / jnp.asarray(lens)[:, None, None]
    # NaN (oob) compares false -> treated as not-steeper, like the ref skip.
    slopes = jnp.where(jnp.isnan(slopes), -jnp.inf, slopes)

    # Reference keeps the FIRST k with strictly greater slope; argmax over a
    # running strict max. jnp.argmax returns the first occurrence of the
    # maximum, which matches strict-greater update order.
    best_k = jnp.argmax(slopes, axis=0)
    best_s = jnp.max(slopes, axis=0)
    best_i = jnp.take_along_axis(nind, best_k[None], axis=0)[0]
    return jnp.where(best_s > 0.0, best_i, -1).astype(jnp.int32)


def direction(height, edge: int = D8, halo=NO_HALO):
    """Like `steepest` but stores the neighbor slot k (0..K-1) instead of the
    flat index; -1 at local minima. Ref: graph.cu:202-264."""
    h = jnp.asarray(height)
    nbrs, shifts, lens = _neighbor_stack(h, edge, halo)
    slopes = (h[None] - nbrs) / jnp.asarray(lens)[:, None, None]
    slopes = jnp.where(jnp.isnan(slopes), -jnp.inf, slopes)
    best_k = jnp.argmax(slopes, axis=0)
    best_s = jnp.max(slopes, axis=0)
    return jnp.where(best_s > 0.0, best_k, -1).astype(jnp.int32)


def random_weighted(height, edge: int = D8, seed: int = 0, offset: int = 0, T: float = 1.0, *, key=None, u=None, halo=NO_HALO):
    """Stochastic multiple-flow-direction receiver graph.

    Per cell, a Gibbs distribution over downhill neighbors with
    P_k ∝ exp(ΔE_k / T), ΔE_k = (h - h_k)/‖shift_k‖ (only ΔE > 0
    contributes), sampled by inverse-transform. Cells with no downhill
    neighbor get -1. Ref: graph.cu:104-195.

    Determinism: a threefry key derived from (seed, offset) replaces the
    reference's curand_init(seed, n, offset) state grid. Pass `key` to
    supply a key directly, or `u` to supply the per-cell uniforms (the
    sharded path passes each block its slice of one global draw so the
    ensemble is partition-invariant).
    """
    h = jnp.asarray(height)
    if key is None:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), offset)
    nbrs, shifts, lens = _neighbor_stack(h, edge, halo)
    nind = _neighbor_flat_index(h.shape, edge, halo)
    valid = ~jnp.isnan(nbrs)

    dE = (h[None] - nbrs) / jnp.asarray(lens)[:, None, None]
    P = jnp.where(valid & (dE > 0.0), jnp.exp(dE / T), 0.0)
    CDF = jnp.cumsum(P, axis=0)
    Z = CDF[-1]

    if u is None:
        u = jax.random.uniform(key, h.shape, dtype=h.dtype)
    # First valid slot with u < CDF_k / Z; Z == 0 -> no hit -> -1 (the
    # reference's 0/0 = NaN comparison is always false, graph.cu:160).
    hit = valid & (u[None] * Z < CDF) & (Z[None] > 0.0)
    any_hit = jnp.any(hit, axis=0)
    first_k = jnp.argmax(hit, axis=0)
    chosen = jnp.take_along_axis(nind, first_k[None], axis=0)[0]
    return jnp.where(any_hit, chosen, -1).astype(jnp.int32)


def slope(tensor, flow, scale):
    """Directional slope along the receiver graph:
    (val[next] - val[n]) / ‖scale * (pos_next - pos)‖; 0 at pits/self.
    Ref: graph.cu:270-311."""
    v = jnp.asarray(tensor)
    f = jnp.asarray(flow)
    W, H = v.shape
    n = jnp.arange(W * H, dtype=jnp.int32).reshape(W, H)
    nxt = jnp.where(f < 0, n, f)

    flat = v.reshape(-1)
    vn = flat[nxt]
    dx = (nxt // H - n // H).astype(v.dtype) * scale[0]
    dy = (nxt % H - n % H).astype(v.dtype) * scale[1]
    dist = jnp.sqrt(dx * dx + dy * dy)
    out = jnp.where((f < 0) | (f == n), 0.0, (vn - v) / jnp.where(dist == 0, 1.0, dist))
    return out.astype(v.dtype)


def _edge_weights(graph, decay, edge: int):
    """Per-cell edge weight w_i for the edge i -> recv[i].

    decay: None (weight 1), scalar, or (W, H) tensor, evaluated at the
    donor cell. The decay^1.414 exponent follows the reference FAITHFULLY:
    my_decay (graph.cu:383-420) runs AFTER __count compacts each cell's
    donor list (graph.cu:351-380), so the exponent applies to donors in
    COMPACTED slots >= 4 — i.e. the 5th+ donor of the receiving cell in
    direction-slot order — NOT to geometrically-diagonal edges (a cell
    with <= 4 donors never gets the exponent). This is a quirk of the
    reference's compaction and is reproduced on purpose.
    """
    W, H = graph.shape
    if decay is None:
        return jnp.ones((W, H), dtype=jnp.float32)
    d = jnp.asarray(decay, dtype=jnp.float32)
    if d.ndim == 0:
        d = jnp.full((W, H), d)
    if edge == D4:
        # my_decay<D4>: all compacted slots < 4 -> never the exponent.
        return d

    slot = graph_to_slots(graph, edge)
    shifts = shifts_for(edge)
    # P_d[j] = 1 if j has a donor via direction d (the donor sits at
    # j - shift_d and its slot is d).
    P = [
        jnp.roll((slot == dd).astype(jnp.int32), (int(dx), int(dy)),
                 axis=(0, 1))
        for dd, (dx, dy) in enumerate(shifts)
    ]
    # prefix_d[j] = number of donors of j with slot < d.
    prefix = []
    acc = jnp.zeros((W, H), jnp.int32)
    for dd in range(len(shifts)):
        prefix.append(acc)
        acc = acc + P[dd]
    # Donor i's compacted position = prefix_{slot(i)}[recv(i)] — pull the
    # receiver's prefix along the donor's own direction.
    pos = jnp.zeros((W, H), jnp.int32)
    for dd, (dx, dy) in enumerate(shifts):
        pulled = jnp.roll(prefix[dd], (-int(dx), -int(dy)), axis=(0, 1))
        pos = jnp.where(slot == dd, pulled, pos)
    return jnp.where((slot >= 0) & (pos >= 4), jnp.power(d, 1.414), d)


def operator_doubling(F, P, W, rounds):
    """Solve F <- F + C F for nilpotent C encoded by per-node pointer P and
    weight W (C[P[i], i] = W[i]; roots self-point with W = 0), by operator
    squaring: up to `rounds` = ceil(log2(#nodes)) rounds of

        F += scatter_add(P, W * F);  W *= W[P];  P = P[P].

    Rounds where W is identically zero short-circuit: C^(2^r) = 0 from
    then on and every further round is an exact no-op, so the body is a
    lax.cond between the real round and identity. The worst-case bound
    is log2(#nodes), but real flow graphs are vastly shallower (a 4096²
    noise-DEM boundary system is nilpotent after 3 squarings vs the
    19-round bound — the short-circuit is a 4-5× on the solve). A
    fori_loop of conds, NOT a while_loop: the loop must stay
    reverse-differentiable (accumulate/accumulate_decay advertise
    jax.grad for calibration workflows), and each round is
    gather/scatter-bound so the skipped branch's any() reduce is cheap.

    Shared by the pointer-doubling accumulator and the coarse boundary
    solves of the tiled/distributed schemes."""
    def round_(c):
        F, P_, W_ = c
        F = F + jnp.zeros_like(F).at[P_].add(W_ * F)
        W_ = W_ * W_[P_]
        P_ = P_[P_]
        return F, P_, W_

    def body(_, c):
        return jax.lax.cond(jnp.any(c[2] != 0.0), round_, lambda c: c, c)

    F, _, _ = jax.lax.fori_loop(0, rounds, body, (F, P, W))
    return F


def compact_index(ids, queries, fallback):
    """Map global ids -> compact positions without a grid-sized lookup
    table: sort + searchsorted (ids are unique). Queries < 0 (or absent)
    map to `fallback` per-element."""
    order = jnp.argsort(ids)
    sorted_ids = ids[order]
    q = jnp.where(queries >= 0, queries, 0)
    pos = jnp.clip(jnp.searchsorted(sorted_ids, q), 0, ids.shape[0] - 1)
    hit = (queries >= 0) & (sorted_ids[pos] == q)
    return jnp.where(hit, order[pos], fallback)


def _accumulate_doubling(graph, value, weight):
    """Upstream accumulation by pointer-doubling (see module docstring)."""
    W, H = graph.shape
    N = W * H
    n = jnp.arange(N, dtype=jnp.int32)
    g = jnp.asarray(graph).reshape(-1)
    root = (g < 0) | (g == n)
    P = jnp.where(root, n, g)
    Wt = jnp.where(root, 0.0, weight.reshape(-1)).astype(jnp.float32)
    A = jnp.asarray(value, dtype=jnp.float32).reshape(-1)

    rounds = max(1, int(math.ceil(math.log2(max(N, 2)))))
    return operator_doubling(A, P, Wt, rounds).reshape(W, H)


def graph_to_slots(graph, edge: int = D8):
    """Flat-index receiver graph -> neighbor-slot graph ((W, H) int32 of
    slot indices 0..K-1, -1 at roots). Receivers are always one of the K
    neighbors, so the conversion is a dense offset match."""
    g = jnp.asarray(graph)
    W, H = g.shape
    n = jnp.arange(W * H, dtype=jnp.int32).reshape(W, H)
    recv = jnp.where(g < 0, n, g)
    dx = recv // H - n // H
    dy = recv % H - n % H
    slot = jnp.full((W, H), -1, jnp.int32)
    for d, (sx, sy) in enumerate(shifts_for(edge)):
        slot = jnp.where((dx == int(sx)) & (dy == int(sy)) & (g >= 0), d, slot)
    return slot


# The method `accumulate` uses when none is named: the fastest of the
# three on the GPU at 4096² (chip_smoke.py's dem phase times all three).
DEFAULT_METHOD = "doubling"


def _accumulate_dispatch(g, value, w, edge, method, max_iters):
    shifts_for(edge)  # validate up front: the doubling path never reads it
    # Scalar value == uniform rain; broadcast so every method sees (W, H).
    value = jnp.broadcast_to(jnp.asarray(value, jnp.float32), g.shape)
    method = method or DEFAULT_METHOD
    if method == "tiled":
        from soillib_tpu.ops.graph_tiled import accumulate_tiled

        return accumulate_tiled(graph_to_slots(g, edge), value, w, edge,
                                max_iters)
    if method == "stencil":
        from soillib_tpu.ops.graph_sweep import accumulate_stencil

        return accumulate_stencil(graph_to_slots(g, edge), value, w, edge,
                                  max_iters)
    if method == "doubling":
        if w is None:
            w = _edge_weights(g, None, edge)
        return _accumulate_doubling(g, value, w)
    raise ValueError(f"unknown accumulation method: {method!r}")


def accumulate(graph, value, edge: int = D8, *, method: str = None,
               max_iters: int = None):
    """Upstream accumulation: out[j] = value[j] + Σ_{i upstream of j} value[i].
    Ref: graph.cu:527-584 (rake-compress). Methods: "doubling" (O(log N)
    gathers; the default), "stencil" (dense one-hot fixed point), "tiled"
    (two-level local/boundary split)."""
    g = jnp.asarray(graph)
    return _accumulate_dispatch(g, value, None, edge, method, max_iters)


def accumulate_decay(graph, source, decay, edge: int = D8, *,
                     method: str = None, max_iters: int = None):
    """Upstream accumulation with per-edge decay: each hop i -> recv[i]
    multiplies by decay[i] (donor cell), diagonals by decay[i]^1.414.
    Ref: graph.cu:586-593."""
    g = jnp.asarray(graph)
    w = _edge_weights(g, decay, edge)
    return _accumulate_dispatch(g, source, w, edge, method, max_iters)


def upstream_mask(graph, targets):
    """Boolean mask of cells draining into any target cell (including the
    targets). `targets` is a boolean (W, H) mask. Pointer-doubling descent —
    legacy `soil.upstream` surface (model.cpp:436-444, commented out in the
    reference bindings but used by older examples)."""
    g = jnp.asarray(graph)
    W, H = g.shape
    N = W * H
    n = jnp.arange(N, dtype=jnp.int32)
    gf = g.reshape(-1)
    P = jnp.where((gf < 0) | (gf == n), n, gf)
    hit = jnp.asarray(targets).reshape(-1)

    rounds = max(1, int(math.ceil(math.log2(max(N, 2)))))

    def body(_, carry):
        hit, P = carry
        hit = hit | hit[P]
        P = P[P]
        return hit, P

    hit, _ = jax.lax.fori_loop(0, rounds, body, (hit, P))
    return hit.reshape(W, H)


def upstream_distance(graph):
    """Hop distance along the receiver chain to the terminal root of each
    cell (0 for roots). Legacy `soil.distance` surface (model.cpp:446-455)."""
    g = jnp.asarray(graph)
    W, H = g.shape
    N = W * H
    n = jnp.arange(N, dtype=jnp.int32)
    gf = g.reshape(-1)
    root = (gf < 0) | (gf == n)
    P = jnp.where(root, n, gf)
    D = jnp.where(root, 0, 1).astype(jnp.int32)

    rounds = max(1, int(math.ceil(math.log2(max(N, 2)))))

    def body(_, carry):
        D, P = carry
        D = D + D[P]
        P = P[P]
        return D, P

    D, _ = jax.lax.fori_loop(0, rounds, body, (D, P))
    return D.reshape(W, H)
