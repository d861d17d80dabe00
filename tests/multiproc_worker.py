"""Multi-process worker for tests/test_multiprocess.py — the *executed*
multi-host path (SURVEY.md §7 step 6).

Runs as one of N OS processes: initializes `jax.distributed` over a
localhost coordinator (CPU backend, 2 local devices per process), places
the erosion state as global block-decomposed arrays over the cross-process
2-D mesh, runs ONE full sharded coupled erosion step (the flagship
K-blocked halo exchange — blocks are 2*HALO_K wide and iters > HALO_K),
and asserts every locally-addressable output shard matches the
single-device reference step computed in-process. This is exactly the
multi-host launch recipe (`parallel/mesh.py` docstring):
`jax.distributed.initialize` first, then identical code. CPU only: several
JAX processes must never share one GPU.
"""

import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import jax

    # CPU only, whatever devices the host has (see module docstring).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )

    import numpy as np
    import jax.numpy as jnp

    import soillib_tpu as soil
    from soillib_tpu import parallel as par
    from soillib_tpu.models.simulation import erode_step
    from soillib_tpu.ops.sweep import HALO_K

    assert len(jax.devices()) == 2 * nproc, (
        f"expected {2 * nproc} global devices, got {len(jax.devices())}"
    )
    assert len(jax.local_devices()) == 2
    mesh = par.make_mesh()
    px, py = mesh.devices.shape

    # Blocks 2*HALO_K wide, iters = HALO_K + remainder: the K-blocked
    # exchange AND the remainder pass both execute cross-process.
    W, H = px * 2 * HALO_K, py * 2 * HALO_K
    scale = (0.078, 0.078, 4.0)

    height = jnp.asarray(
        np.asarray(soil.noise((W, H), soil.noise_t(seed=3.0))) * 0.5 + 1.0
    )
    state = soil.ErosionState.zeros((W, H), height=height)
    param = soil.ErosionParams()
    param.transportIterations = HALO_K + 4

    # Reference: the plain single-device step on the full grid, computed
    # independently inside every process.
    ref = jax.jit(lambda s, k: erode_step(s, scale, param, k))(
        state, jax.random.PRNGKey(0)
    )
    ref = jax.tree_util.tree_map(np.asarray, ref)

    gstate = par.shard_state_global(state, mesh)
    step = par.make_sharded_erode_fn(mesh, scale, param, steps=1)
    out = step(gstate, jax.random.PRNGKey(0))
    jax.block_until_ready(out)

    for name in ("layers", "discharge", "momentum", "mass", "debris"):
        want = getattr(ref, name)
        for s in getattr(out, name).addressable_shards:
            np.testing.assert_allclose(
                np.asarray(s.data), want[s.index], rtol=1e-4, atol=1e-5,
                err_msg=f"{name} shard {s.index} (process {pid})",
            )
    print(f"PARITY-OK process={pid}", flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
