"""Executed multi-host path (SURVEY.md §7 step 6).

Spawns 2 real OS processes that `jax.distributed.initialize` against a
localhost coordinator (CPU backend, 2 local devices each -> a 2x2
cross-process mesh), run the full sharded coupled erosion step with the
flagship K-blocked halo exchange, and assert shard-level parity against
the single-device step (tests/multiproc_worker.py). This is the same
launch recipe a multi-host run uses — initialize first, identical code
after (parallel/mesh.py docstring). The workers run on the CPU backend
only, so they never contend for a GPU.
"""

import os
import socket
import subprocess
import sys

NPROC = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_step_matches_single_device():
    worker = os.path.join(os.path.dirname(__file__), "multiproc_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()

    env = dict(os.environ)
    # The worker picks its own device count (jax_num_cpu_devices=2); an
    # inherited XLA_FLAGS forcing 8 virtual devices would break the
    # 2-devices-per-process topology the coordinator agrees on.
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(NPROC), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True,
        )
        for pid in range(NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=280)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert f"PARITY-OK process={pid}" in out, out[-4000:]
