"""Example smoke tests: every shipped example runs headless end-to-end.

The reference rotted exactly here — half its examples call stale APIs
(SURVEY.md §4; erosion_gpu.py:48/59/78 vs the commented-out bindings at
model.cpp:62-143) because nothing enforced example health. Each example
here runs as a REAL subprocess through its own CLI (so argparse wiring,
imports and module-level code are all exercised, not just a callable) at
tiny resolution, concurrently to fit the suite budget.

The subprocess wrapper forces the CPU backend via jax.config, so the
examples run the same on a host with GPUs (see tests/conftest).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WRAPPER = """
import jax
jax.config.update("jax_platforms", "cpu")
import sys, runpy
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
"""


@pytest.fixture(scope="session")
def demdir(tmp_path_factory):
    """Two tiny adjacent GeoTIFF tiles (world-referenced, for tiff_merge)."""
    import soillib_tpu as soil

    d = tmp_path_factory.mktemp("dems")
    rng = np.random.default_rng(0)
    for i in range(2):
        arr = rng.random((32, 32), dtype=np.float32) * 40.0
        g = soil.geotiff(arr)
        g.meta.scale = [1.0, 1.0, 1.0]
        g.meta.coords = [0, 0, 0, 32.0 * i, 0.0, 0.0]
        g.write(str(d / f"tile{i}.tiff"))
    return str(d)


def _spawn(out_dir, name, args):
    env = dict(os.environ)
    env["MPLBACKEND"] = "Agg"
    pp = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = REPO + (os.pathsep + pp if pp else "")
    script = os.path.join(REPO, "examples", name + ".py")
    proc = subprocess.Popen(
        [sys.executable, "-c", _WRAPPER, script] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO,
    )
    return name, proc


def test_all_examples_smoke(demdir, tmp_path):
    t = str(tmp_path)
    jobs = [
        ("erosion_gpu",
         ["--res", 48, "--steps", 2, "--report", 2, "--faithful",
          "--out", f"{t}/ero"]),
        ("erosion_pod", ["--res", 64, "--steps", 2, "--virtual", 8]),
        ("dem_mc_pod", ["--res", 64, "--count", 6000, "--virtual", 8]),
        ("erosion_gpu_multiscale",
         ["--levels", "48:2,64:1", "--out", f"{t}/ms"]),
        ("dem_condition", ["--res", 48, "--out", f"{t}/cond.png"]),
        ("dem_process", ["--res", 48, "--out", f"{t}/proc.png"]),
        ("dem_multiflow",
         [f"{demdir}/tile0.tiff", "--K", 4, "--batch", 2,
          "--out", f"{t}/mf.png"]),
        ("tiff_view", [demdir, "--out", f"{t}/view"]),
        ("tiff_relief", [demdir, "--out", f"{t}/relief"]),
        ("tiff_normal", [demdir, "--out", f"{t}/normal"]),
        ("tiff_mesh", [f"{demdir}/tile0.tiff", f"{t}/mesh.ply"]),
        ("tiff_merge", [demdir, "--pscale", 2.0, "--out", f"{t}/merged.tiff"]),
    ]
    procs = [_spawn(t, name, args) for name, args in jobs]
    failures = []
    for name, proc in procs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"== {name}: TIMEOUT ==\n{out}")
            continue
        if proc.returncode != 0:
            failures.append(f"== {name}: exit {proc.returncode} ==\n{out}")
    assert not failures, "\n".join(failures)

    # Artifacts actually landed (a print-and-crash-later regression would
    # otherwise pass on exit code alone for the plotting examples).
    for f in ("ero/erosion.zip", "ms/multiscale.zip", "cond.png", "proc.png",
              "mf.png", "mesh.ply", "merged.tiff"):
        assert os.path.exists(os.path.join(t, f)), f
