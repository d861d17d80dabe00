"""Checkpoint/resume: orbax pytree checkpoints + autodiff capability."""

import jax
import jax.numpy as jnp
import numpy as np

import soillib_tpu as soil


def test_orbax_checkpoint_roundtrip(tmp_path):
    """Full ErosionState through save_checkpoint/load_checkpoint
    (SURVEY.md §5: step checkpoints for multi-device runs)."""
    from soillib_tpu.io.checkpoint import load_checkpoint, save_checkpoint

    h = soil.noise((16, 16), soil.noise_t())
    state = soil.ErosionState.zeros((16, 16), height=h)
    state = soil.erode(state, (0.1, 0.1, 2.0),
                       soil.ErosionParams(transportIterations=4), steps=1)

    path = save_checkpoint(str(tmp_path), state, step=7)
    assert "step_7" in path

    abstract = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state
    )
    restored = load_checkpoint(str(tmp_path), abstract, step=7)
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_erosion_step_is_differentiable():
    """The whole coupled step is differentiable — gradients of an erosion
    outcome w.r.t. initial terrain flow through transport, transfer, and
    creep. (A capability the reference's CUDA kernels cannot provide;
    enables calibration/inversion workflows.)"""
    param = soil.ErosionParams()
    param.transportIterations = 4
    scale = (0.1, 0.1, 2.0)
    key = jax.random.PRNGKey(0)
    h0 = 1.0 + 0.2 * jax.random.normal(key, (16, 16))

    def loss(height):
        state = soil.ErosionState.zeros((16, 16), height=height)
        from soillib_tpu.models.simulation import erode_step
        out = erode_step(state, scale, param, jax.random.PRNGKey(1))
        return jnp.sum(out.discharge ** 2) + jnp.sum(out.height ** 2)

    g = jax.grad(loss)(h0)
    assert g.shape == h0.shape
    gn = np.asarray(g)
    assert np.isfinite(gn).all()
    assert np.abs(gn).max() > 0.0
