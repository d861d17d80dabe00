"""chip_smoke.py: its phases at toy sizes on the CPU, and its refusal to
run without a GPU.

On the card the script runs the same phase functions at full size
(`python chip_smoke.py`); here each runs with the CPU standing in for
the card, which checks the plumbing, the comparisons and the records.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
import soillib_tpu as soil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def _run_script(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout):
    return not any('"ok"' in ln for ln in stdout.splitlines())


def test_refuses_without_gpu():
    p = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert p.returncode != 0
    assert _no_result(p.stdout)
    assert "no GPU" in p.stderr


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_script("chip_smoke.py", str(tmp_path))
    assert p.returncode != 0
    assert _no_result(p.stdout)


def test_phase_golden():
    out = cs.phase_golden(traj=())
    assert out["golden64_s"] > 0


def test_phase_step_vs_cpu(cpu):
    out = cs.phase_step_vs_cpu(cpu, cpu, size=64, rounds=8)
    for key in ("r1_per_cell", "r8_per_cell"):
        assert set(out[key]) == set(cs.STEP_FIELDS)
        # Same backend, same program: identical.
        assert all(v["cells_over"] == 0 and v["err_over_tol"] == 0.0
                   for v in out[key].values())
    assert all(v["corr"] == 1.0 for v in out["r8_integrals"].values())


def test_integrals_reject_a_wrong_field(cpu):
    """The schedule-robust bar still catches a structural error."""
    import dataclasses

    out = soil.make_erode_fn(cs._params(4), cs.SCALE)(cs.terrain_state(32))
    bad = dataclasses.replace(out, discharge=out.discharge[::-1])
    with pytest.raises(AssertionError, match="discharge"):
        cs._integrals(bad, out)


def test_phase_flagship(cpu):
    out = cs.phase_flagship(cpu, size=64, rounds=8)
    assert out["ms_per_step"] > 0 and out["compile_s"] > 0


def test_phase_faithful(cpu):
    out = cs.phase_faithful(cpu, size=48, maxage=40)
    assert cs._worst(out["per_cell"]) <= 1.0


def test_phase_capacity(cpu):
    out = cs.phase_capacity(cpu, size=64, rounds=8)
    assert out["albedo_on_fits"] is True


def test_phase_quality(cpu):
    out = cs.phase_quality(cpu, size=32, rounds=4)
    assert out["ms_per_step"] > 0


def test_phase_dem(cpu):
    """Above one tile, so the tiled method runs its two-level path."""
    out = cs.phase_dem(cpu, size=160)
    assert out["stencil_err_over_tol"] <= 1.0
    assert out["tiled_err_over_tol"] <= 1.0
    assert out["fastest"] in ("doubling", "stencil", "tiled")


def test_phase_sharded():
    out = cs.phase_sharded(jax.devices()[:4], size=64, rounds=20)
    assert len(out["per_cell"]) == 2 and len(out["integrals"]) == 1
    assert cs._worst(out["per_cell"][0]) <= 1.0
    assert len(out["peak_bytes_per_card"]) == 4


def test_run_records_failure(capsys):
    failures = []
    cs._run("boom", lambda: 1 / 0, "cpu", failures)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert failures == ["boom"]
    assert rec["ok"] is False and rec["device_kind"] == "cpu"
    assert "ZeroDivisionError" in rec["error"]


@pytest.mark.gpu
def test_phase_step_vs_cpu_on_card(gpu_device, cpu):
    out = cs.phase_step_vs_cpu(gpu_device, cpu, size=256, rounds=16)
    assert "r16_integrals" in out
