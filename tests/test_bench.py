"""bench.py's device table, op and kernel counters, and its refusal to
run without a GPU (its timings come only from the card)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_peaks_h100_from_data_sheet():
    p = bench.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peaks_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        bench.peaks(kind)


def test_count_ops_weights_every_op_one():
    x = jnp.ones((4, 8), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda x: jnp.exp(x) / (x * 2.0 + 1.0))(x)
    # exp, mul, add, div: four ops on 32 elements each.
    assert bench._count_ops(jaxpr.jaxpr) == 4 * 32


def test_count_ops_counts_a_repeated_subexpression_once():
    x = jnp.ones((16,), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda x: jnp.sqrt(x) + jnp.sqrt(x))(x)
    assert bench._count_ops(jaxpr.jaxpr) == 2 * 16  # sqrt (once) + add


def test_cohort_round_ops_albedo_adds_work():
    on = bench.cohort_round_ops(albedo_on=True)
    off = bench.cohort_round_ops(albedo_on=False)
    for phase in ("fluvial", "debris"):
        assert on[phase] > off[phase] > 100


def test_entry_kernels_counts_compiled_ops():
    x = jnp.ones((64, 64), jnp.float32)
    text = jax.jit(lambda x: (jnp.exp(x) + 1.0, x.sum())).lower(x) \
        .compile().as_text()
    assert bench._entry_kernels(text) >= 1
    assert bench._entry_kernels("HloModule m\n") == 0


def test_round_profile_small_grid():
    prof = bench.round_profile(16, albedo_on=False, rounds=2)
    assert set(prof) == {"fluvial", "debris"}
    for p in prof.values():
        assert p["kernels"] >= 1 and p["bytes"] > 0 and p["ms"] > 0


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "bench.py", "--size", "16"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "found none" in p.stderr
    assert p.stdout.strip() == ""
