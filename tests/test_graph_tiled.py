"""Two-level (tiled) accumulation vs pointer doubling.

The tiled scheme (ops/graph_tiled.py) cuts cross-tile edges, solves each
tile's local fixed point, closes the boundary system by operator
doubling and re-injects — its result must equal the single-level
pointer-doubling accumulation across tile seams, for D4 and D8, with and
without per-edge decay.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import soillib_tpu as soil
from soillib_tpu.core.grid import D4, D8
from soillib_tpu.ops.graph_tiled import TILE, accumulate_tiled
from soillib_tpu.ops.graph import graph_to_slots


def _random_dem_graph(W, H, edge, seed):
    key = jax.random.PRNGKey(seed)
    height = soil.noise((W, H), soil.noise_t(seed=float(seed)))
    height = jnp.asarray(height) + 0.002 * jax.random.normal(key, (W, H))
    g = soil.steepest(height, edge)
    return g, height


@pytest.mark.parametrize("edge", [D4, D8])
@pytest.mark.parametrize("shape", [(2 * TILE, 2 * TILE), (TILE + 40, 3 * TILE - 24)])
def test_tiled_matches_doubling(edge, shape):
    """Unit rain: every accumulated value is an integer below 2^24, so
    all summation orders are exact and the methods agree bitwise."""
    W, H = shape
    g, _ = _random_dem_graph(W, H, edge, seed=7)
    slots = graph_to_slots(g, edge)
    rain = jnp.ones((W, H), jnp.float32)

    want = soil.accumulate(g, rain, edge, method="doubling")
    got = accumulate_tiled(slots, rain, edge=edge)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_tiled_decay_matches_doubling():
    W, H = 2 * TILE, TILE + 56
    g, _ = _random_dem_graph(W, H, D8, seed=11)
    rain = jnp.ones((W, H), jnp.float32)

    want = soil.accumulate_decay(g, rain, 0.9, D8, method="doubling")
    from soillib_tpu.ops.graph import _edge_weights

    # _edge_weights takes the flat-index receiver graph (it derives the
    # compacted-slot quirk from it), NOT the slot array.
    w = _edge_weights(g, 0.9, D8)
    slots = graph_to_slots(g, D8)
    got = accumulate_tiled(slots, rain, w, D8)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("shape", [(2 * TILE, TILE + 56), (TILE + 1, 3 * TILE),
                                   (300, 200)])
def test_boundary_rank_closed_form_matches_sort(shape):
    """_boundary_rank (arithmetic) == compact_index (sort + searchsorted)
    on every boundary cell and on -1 fallbacks."""
    from soillib_tpu.ops.graph import compact_index
    from soillib_tpu.ops.graph_tiled import _boundary_indices, _boundary_rank

    W, H = shape
    bidx = jnp.asarray(_boundary_indices(W, H))
    K = bidx.shape[0]
    rng = np.random.default_rng(3)
    # queries: all boundary cells (shuffled) + some -1s
    q = np.asarray(bidx)[rng.permutation(K)]
    q[:: 7] = -1
    q = jnp.asarray(q)
    fb = jnp.arange(K, dtype=jnp.int32)[: q.shape[0]]
    want = compact_index(bidx, q, fb)
    got = _boundary_rank(W, H, q, fb)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
