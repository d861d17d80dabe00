"""Weak-scaling harness: coupled erosion step, 1 chip → N devices/hosts.

The BASELINE.md target is ≥80% weak-scaling efficiency with 2-D block
decomposition and halo exchange. This harness fixes the PER-DEVICE
block size and grows the global grid with the mesh, reporting cell-steps/s
and efficiency vs the single-device run.

Multi-host: launched per host after jax.distributed.initialize()
Structure:  --virtual N runs the same code on N CPU devices (numbers are
            not meaningful there; use it to validate the harness itself).
Cross-proc: --procs P spawns P real OS processes that
            jax.distributed.initialize against a localhost coordinator
            (the multi-host launch recipe, tests/multiproc_worker.py) and times
            the sharded step where the K-blocked ppermute exchange
            CROSSES PROCESS BOUNDARIES, against the identical global
            config in one process.  CAVEAT: all processes share one
            socket, so per-device throughput is not a hardware number —
            the signal is the measured relative cost of crossing the
            process boundary, the one configuration the virtual
            single-process harness cannot see.

    python benchmarks/scaling.py [--block 1024] [--steps 4] [--virtual 8]
    python benchmarks/scaling.py --procs 2 [--devices-per-proc 4]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_worker(args):
    """One distributed process of the --procs measurement (also the
    single-process reference when nproc == 1)."""
    pid, nproc = args.worker_id, args.procs

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices_per_proc)
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{args.port}",
            num_processes=nproc,
            process_id=pid,
        )
    import jax.numpy as jnp
    import numpy as np

    import soillib_tpu as soil
    from soillib_tpu import parallel as par

    mesh = par.make_mesh()
    px, py = mesh.devices.shape
    W, H = px * args.block, py * args.block
    scale = (20.0 / W, 20.0 / H, 4.0)
    param = soil.ErosionParams()
    param.transportIterations = args.iters
    height = jnp.asarray(
        np.asarray(soil.noise((W, H), soil.noise_t(seed=3.0))) * 0.5 + 1.0
    )
    state = soil.ErosionState.zeros((W, H), height=height)
    gstate = (par.shard_state_global(state, mesh) if nproc > 1
              else par.shard_state(state, mesh))
    step = par.make_sharded_erode_fn(mesh, scale, param, steps=args.steps)
    key = jax.random.PRNGKey(0)
    out = step(gstate, key)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = step(out, key)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    rate = W * H * args.steps / dt
    print(f"RATE pid={pid} mesh={px}x{py} grid={W}x{H} "
          f"cell_steps_per_s={rate:.1f}", flush=True)
    if nproc > 1:
        jax.distributed.shutdown()


def run_procs(args):
    """Parent of the --procs mode: cross-process run, then the identical
    global config single-process, then the comparison JSON."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p]
    )

    def launch(nproc, dev_per_proc):
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--worker-id", str(pid), "--procs", str(nproc),
                 "--port", str(port),
                 "--devices-per-proc", str(dev_per_proc),
                 "--block", str(args.block), "--steps", str(args.steps),
                 "--iters", str(args.iters)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, text=True,
            )
            for pid in range(nproc)
        ]
        rates = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=1800)
                assert p.returncode == 0, out[-3000:]
                for line in out.splitlines():
                    if line.startswith("RATE "):
                        rates.append(float(line.rsplit("=", 1)[1]))
        finally:
            # A failed/timed-out worker must not leave its siblings
            # blocked forever on the jax.distributed coordinator
            # barrier (each holds an XLA-CPU process's memory).
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return rates

    total = args.procs * args.devices_per_proc
    multi = launch(args.procs, args.devices_per_proc)
    single = launch(1, total)
    print(json.dumps({
        "mode": f"{args.procs} procs x {args.devices_per_proc} devices "
                f"(cross-process ppermute) vs 1 proc x {total}",
        "block": args.block,
        "steps": args.steps,
        "iters": args.iters,
        "cross_process_cell_steps_per_s": round(min(multi), 1),
        "single_process_cell_steps_per_s": round(single[0], 1),
        "cross_process_relative": round(min(multi) / single[0], 4),
        "caveat": "all processes share one socket; the relative number "
                  "measures the process-boundary cost, not hardware "
                  "scaling",
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=1024, help="per-device block edge")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--virtual", type=int, default=0)
    ap.add_argument("--procs", type=int, default=0,
                    help="cross-process mode: spawn N jax.distributed "
                         "processes (see module docstring)")
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--worker-id", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker_id >= 0:
        return run_worker(args)
    if args.procs:
        return run_procs(args)

    import jax
    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.virtual)

    import soillib_tpu as soil
    from soillib_tpu import parallel as par

    def sync(state):
        jax.block_until_ready(state)

    def run(devices):
        mesh = par.make_mesh(devices=devices)
        px, py = mesh.devices.shape
        W, H = px * args.block, py * args.block
        scale = (20.0 / W, 20.0 / H, 4.0)
        param = soil.ErosionParams()
        param.transportIterations = args.iters
        height = soil.noise((W, H), soil.noise_t(seed=3.0, ext=(W, H)))
        state = par.shard_state(soil.ErosionState.zeros((W, H), height=height), mesh)
        step = par.make_sharded_erode_fn(mesh, scale, param, steps=args.steps)
        key = jax.random.PRNGKey(0)
        state = step(state, key)
        sync(state)
        t0 = time.perf_counter()
        state = step(state, key)
        sync(state)
        dt = time.perf_counter() - t0
        return W * H * args.steps / dt  # cell-steps/s

    import numpy as np
    devs = jax.devices()
    results = {}
    n = 1
    while n <= len(devs):
        rate = run(np.array(devs[:n]))
        results[n] = rate
        eff = rate / (n * results[1])
        print(json.dumps({
            "devices": n,
            "cell_steps_per_s": round(rate, 1),
            "per_device": round(rate / n, 1),
            "weak_scaling_efficiency": round(eff, 4),
        }))
        n *= 2


if __name__ == "__main__":
    main()
