"""Flow-graph op tests vs pure-numpy oracles (SURVEY.md §4 item 1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import soillib_tpu as soil
from tests import oracles


@pytest.fixture(scope="module")
def height():
    rng = np.random.default_rng(42)
    h = rng.random((24, 17), dtype=np.float32)
    # a smooth ramp + noise => mixture of pits and channels
    x = np.linspace(0, 1, 24)[:, None]
    return (h * 0.3 + x).astype(np.float32)


@pytest.mark.parametrize("edge", [soil.d4, soil.d8])
def test_steepest_matches_oracle(height, edge):
    got = np.asarray(soil.steepest(height, edge))
    want = oracles.steepest_oracle(height, edge)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("edge", [soil.d4, soil.d8])
def test_direction_matches_oracle(height, edge):
    got = np.asarray(soil.direction(height, edge))
    want = oracles.direction_oracle(height, edge)
    np.testing.assert_array_equal(got, want)


def test_steepest_flat_is_pit():
    h = np.zeros((8, 8), np.float32)
    got = np.asarray(soil.steepest(h, soil.d8))
    assert (got == -1).all()


@pytest.mark.parametrize("edge", [soil.d4, soil.d8])
def test_accumulate_matches_oracle(height, edge):
    graph = np.asarray(soil.steepest(height, edge))
    value = np.random.default_rng(0).random(height.shape).astype(np.float32)
    got = np.asarray(soil.accumulate(graph, value, edge))
    want = oracles.accumulate_oracle(graph, value, None, edge)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_accumulate_counts_upstream_cells(height):
    """accumulate(ones) = upstream contributing area incl. self."""
    graph = np.asarray(soil.steepest(height, soil.d8))
    area = np.asarray(soil.accumulate(graph, np.ones_like(height), soil.d8))
    assert area.min() >= 1.0
    assert area.max() <= height.size
    # total area conservation: every cell contributes once per downstream hop;
    # at least the sum of all cells must appear.
    assert area.sum() >= height.size


@pytest.mark.parametrize("edge", [soil.d4, soil.d8])
def test_accumulate_decay_matches_oracle(height, edge):
    graph = np.asarray(soil.steepest(height, edge))
    rng = np.random.default_rng(1)
    value = rng.random(height.shape).astype(np.float32)
    decay = (0.5 + 0.5 * rng.random(height.shape)).astype(np.float32)
    got = np.asarray(soil.accumulate_decay(graph, value, decay, edge))
    want = oracles.accumulate_oracle(graph, value, decay, edge)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-5)


def test_accumulate_chain_exact():
    """Hand-built chain: a->b->c with unit values."""
    # 1x3 grid: heights descending so steepest D4 gives the chain.
    h = np.array([[3.0, 2.0, 1.0]], np.float32).T  # (3,1)
    graph = np.asarray(soil.steepest(h, soil.d4))
    assert graph[0, 0] == 1 and graph[1, 0] == 2 and graph[2, 0] == -1
    acc = np.asarray(soil.accumulate(graph, np.ones((3, 1), np.float32), soil.d4))
    np.testing.assert_allclose(acc[:, 0], [1.0, 2.0, 3.0])


def test_random_weighted_deterministic(height):
    a = np.asarray(soil.random_weighted(height, soil.d8, 0, 7, 10.0))
    b = np.asarray(soil.random_weighted(height, soil.d8, 0, 7, 10.0))
    c = np.asarray(soil.random_weighted(height, soil.d8, 0, 8, 10.0))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_random_weighted_only_downhill(height):
    W, H = height.shape
    flow = np.asarray(soil.random_weighted(height, soil.d8, 0, 0, 10.0))
    flat = height.reshape(-1)
    for x in range(W):
        for y in range(H):
            nxt = flow[x, y]
            if nxt >= 0:
                assert flat[nxt] < height[x, y]


def test_random_weighted_low_temperature_is_steepest(height):
    """Small T concentrates the Gibbs distribution on the steepest slope."""
    flow = np.asarray(soil.random_weighted(height, soil.d8, 0, 0, 0.01))
    steep = np.asarray(soil.steepest(height, soil.d8))
    agree = (flow == steep).mean()
    assert agree > 0.9


def test_random_weighted_tiny_temperature_overflows_to_pit(height):
    """T -> 0 overflows exp() to inf; the CDF ratio becomes NaN and every
    cell degrades to -1 — the reference's behavior too (graph.cu:139,160:
    inf/inf comparison is false for every k)."""
    flow = np.asarray(soil.random_weighted(height, soil.d8, 0, 0, 1e-6))
    assert (flow == -1).all()


def test_slope(height):
    graph = np.asarray(soil.steepest(height, soil.d8))
    s = np.asarray(soil.slope(height, graph, (2.0, 3.0)))
    W, H = height.shape
    flat = height.reshape(-1)
    for x in range(0, W, 3):
        for y in range(0, H, 2):
            nxt = graph[x, y]
            if nxt < 0:
                assert s[x, y] == 0.0
            else:
                dx = (nxt // H - x) * 2.0
                dy = (nxt % H - y) * 3.0
                want = (flat[nxt] - height[x, y]) / np.hypot(dx, dy)
                np.testing.assert_allclose(s[x, y], want, rtol=1e-5)


def test_upstream_mask_and_distance():
    # Two opposing basins draining to pits at cells 2 and 3.
    h = np.array([[3.0, 2.0, 1.0, 1.0, 2.0, 3.0]], np.float32).T
    graph = np.asarray(soil.steepest(h, soil.d4))
    targets = np.zeros((6, 1), bool)
    targets[2, 0] = True
    mask = np.asarray(soil.upstream_mask(graph, targets))
    np.testing.assert_array_equal(mask[:, 0], [True, True, True, False, False, False])
    dist = np.asarray(soil.upstream_distance(graph))
    np.testing.assert_array_equal(dist[:, 0], [2, 1, 0, 0, 1, 2])


def test_accumulate_stencil_matches_doubling():
    """The gather-free stencil formulation == pointer-doubling == oracle."""
    import jax
    import jax.numpy as jnp
    import soillib_tpu as soil
    key = jax.random.PRNGKey(9)
    h = jax.random.normal(key, (24, 32)) * 5.0
    rain = jnp.abs(jax.random.normal(jax.random.fold_in(key, 1), (24, 32)))
    for edge in (soil.d4, soil.d8):
        flow = soil.steepest(h, edge)
        want = soil.accumulate(flow, rain, edge, method="doubling")
        got = soil.accumulate(flow, rain, edge, method="stencil")
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        decay = 0.95 + 0.04 * jax.random.uniform(key, (24, 32))
        want = soil.accumulate_decay(flow, rain, decay, edge, method="doubling")
        got = soil.accumulate_decay(flow, rain, decay, edge, method="stencil")
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_accumulate_tiled_matches_doubling():
    """Two-level (Barnes-style) accumulation == pointer-doubling, across
    tile boundaries and with decay."""
    import jax
    import jax.numpy as jnp
    import soillib_tpu as soil
    key = jax.random.PRNGKey(11)
    W, H = 200, 150  # > TILE in one dim once TILE=128
    h = soil.fill_depressions(
        jax.random.normal(key, (W, H)) * 3.0
        + jnp.linspace(0, 5, W)[:, None]
    )
    rain = jnp.abs(jax.random.normal(jax.random.fold_in(key, 1), (W, H))) + 0.1
    for edge in (soil.d4, soil.d8):
        flow = soil.steepest(h, edge)
        want = soil.accumulate(flow, rain, edge, method="doubling")
        got = soil.accumulate(flow, rain, edge, method="tiled")
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)
        decay = jnp.full((W, H), 0.98)
        want = soil.accumulate_decay(flow, rain, decay, edge, method="doubling")
        got = soil.accumulate_decay(flow, rain, decay, edge, method="tiled")
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


def test_accumulate_global_conservation():
    """With unit weights, every cell's value reaches exactly one terminal
    root, so the accumulated values at roots sum to the total input mass —
    for every accumulation method."""
    import jax
    import jax.numpy as jnp
    import soillib_tpu as soil

    key = jax.random.PRNGKey(21)
    W, H = 160, 140
    h = soil.fill_depressions(
        jax.random.normal(key, (W, H)) * 2.0 + jnp.linspace(0, 4, W)[:, None]
    )
    rain = jnp.abs(jax.random.normal(jax.random.fold_in(key, 1), (W, H))) + 0.5
    total = float(rain.sum())
    flow = soil.steepest(h, soil.d8)
    roots = np.asarray(flow) < 0
    assert roots.any()
    for method in ("doubling", "stencil", "tiled"):
        A = np.asarray(soil.accumulate(flow, rain, soil.d8, method=method))
        np.testing.assert_allclose(A[roots].sum(), total, rtol=1e-4,
                                   err_msg=method)


def test_accumulate_reverse_differentiable():
    """The repo advertises jax.grad through accumulation (calibration /
    inversion workflows); the operator-doubling short-circuit must stay
    a fori_loop of conds, not a while_loop (which has no reverse rule)."""
    h = jnp.asarray(np.random.default_rng(0).random((32, 32), np.float32))
    flow = soil.steepest(h, soil.d8)
    rain = jnp.ones((32, 32), jnp.float32)

    # "doubling" is the reverse-differentiable accumulation path (the
    # stencil/tiled fixed points use convergence-checked while_loops and
    # never had a reverse rule).
    g = jax.grad(
        lambda r: jnp.sum(soil.accumulate(flow, r, soil.d8,
                                          method="doubling") ** 2)
    )(rain)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0.0


def test_accumulate_default_method_is_fixed(height):
    """method=None takes graph.DEFAULT_METHOD — chosen by measurement on
    the card, never by the backend's name."""
    from soillib_tpu.ops.graph import DEFAULT_METHOD

    graph = np.asarray(soil.steepest(height, soil.d8))
    value = np.random.default_rng(3).random(height.shape).astype(np.float32)
    got = soil.accumulate(graph, value, soil.d8)
    want = soil.accumulate(graph, value, soil.d8, method=DEFAULT_METHOD)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
