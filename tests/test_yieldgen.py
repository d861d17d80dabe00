"""soil.yield_t / make_yield / prefetch — the util/yield.hpp:24-247
equivalent (generator semantics: peek/take, strict typing, single-pass
single-owner handles, exception propagation) and the streaming
value-add (device-prefetching iteration)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import soillib_tpu as soil


def _gen(n):
    for i in range(n):
        yield i


def test_bool_peek_then_call_take():
    # operator bool peeks+caches, operator() takes (yield.hpp:160-189)
    y = soil.yield_t(_gen(3))
    out = []
    while y:
        out.append(y())
    assert out == [0, 1, 2]


def test_bool_is_idempotent_peek():
    y = soil.yield_t(_gen(1))
    assert bool(y) and bool(y) and bool(y)  # peek caches; no value lost
    assert y() == 0
    assert not y


def test_iterator_adapter_and_tuple_unpack():
    # make_yield packs multiple values into a tuple (yield.hpp:55-64)
    def pairs():
        for i in range(3):
            yield soil.make_yield(i, float(i) * 2.0)

    got = [(i, v) for i, v in soil.yield_t(pairs())]
    assert got == [(0, 0.0), (1, 2.0), (2, 4.0)]
    assert soil.make_yield(7) == 7  # single value passes through


def test_exception_propagates_at_retrieve_site():
    # unhandled_exception caching + rethrow (yield.hpp:119-121, 184-186)
    def boom():
        yield 1
        raise ValueError("inside coroutine")

    y = soil.yield_t(boom())
    assert y() == 1
    with pytest.raises(ValueError, match="inside coroutine"):
        bool(y)


def test_strict_typing():
    y = soil.yield_t(iter([1, "two"]), value_type=int)
    assert y() == 1
    with pytest.raises(TypeError, match="strict-typed"):
        y()


def test_single_pass_reiteration_raises():
    y = soil.yield_t(_gen(2))
    assert list(y) == [0, 1]
    assert not y  # querying a finished handle stays legal (h_.done())
    with pytest.raises(RuntimeError, match="single-pass"):
        iter(y).__next__()


def test_move_semantics_invalidate_source():
    # move-only handle: source is destroyed on move (yield.hpp:141-158)
    y = soil.yield_t(_gen(3))
    assert y() == 0
    z = y.move()
    with pytest.raises(RuntimeError, match="moved or destroyed"):
        bool(y)
    assert list(z) == [1, 2]


def test_exhausted_call_raises_stopiteration():
    y = soil.yield_t(_gen(0))
    assert not y
    with pytest.raises(StopIteration):
        y()


def test_prefetch_order_and_device_transfer():
    items = [np.full((4, 4), i, np.float32) for i in range(5)]
    out = list(soil.prefetch(iter(items), depth=2))
    assert len(out) == 5
    for i, a in enumerate(out):
        assert isinstance(a, jax.Array)
        np.testing.assert_array_equal(np.asarray(a), items[i])


def test_prefetch_nested_structures_and_passthrough():
    def tiles():
        for i in range(3):
            yield (f"tile{i}", np.full((2, 2), i, np.float32))

    out = list(soil.prefetch(tiles(), depth=3))
    assert [name for name, _ in out] == ["tile0", "tile1", "tile2"]
    for i, (_, a) in enumerate(out):
        assert isinstance(a, jax.Array)  # array leaf transferred
        assert float(jnp.asarray(a)[0, 0]) == float(i)


def test_prefetch_depth_validation_and_short_streams():
    with pytest.raises(ValueError):
        list(soil.prefetch([1], depth=0))
    assert list(soil.prefetch([], depth=4)) == []
    assert [int(x) for x in soil.prefetch([np.int32(7)], depth=4)] == [7]
