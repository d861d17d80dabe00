"""Proof that the coupled erosion step runs on an NVIDIA GPU.

    python chip_smoke.py               # phases 1-8 on one card
    python chip_smoke.py --devices 4   # 8192² step sharded over a 2x2 mesh
                                       # of four cards vs one card

Everything runs in ONE process (a second JAX process could not get the
card's memory): the card through `jax.devices("gpu")`, the comparison
runs through `jax.devices("cpu")`. Each phase prints one JSON line with
the card's `device_kind`, its compile seconds, ms per step (after a
warm-up, ending in `block_until_ready`) and the process's running peak
of device memory (`memory_stats()["peak_bytes_in_use"]`, which only
grows); every newly compiled program also prints its
`memory_analysis()`. The line before the last is nvidia-smi's name and
power limit of the card; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Exits non-zero, before any phase, when JAX finds no GPU, and non-zero
after the phases when any of them failed.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

import soillib_tpu as soil

SCALE = (0.078, 0.078, 4.0)  # erosion_gpu.py:36-38 world scale
# Per-cell bar of __graft_entry__.py's sharded-vs-single parity: the
# fields of a well-conditioned step agree to f32 rounding noise (the
# GPU's exp/div/sqrt code, FMA contraction and reduction order differ
# from the CPU's and from another program's schedule), far below any
# structural error.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
STEP_FIELDS = ("layers", "discharge", "momentum", "mass")
# Where the comparison is not well-conditioned — tens of transport rounds
# or several coupled steps — the cohort closure's exit-face thresholds
# amplify 1-ulp differences in a few near-critical cells by ~1e4 (see
# tests/test_parallel.py), so there the repo's schedule-robust bar
# applies: field totals within 1e-3 and correlation >= 0.999
# (test_sharded_erosion_multistep_integrals). The per-cell numbers are
# still printed.
SUM_RTOL, MIN_CORR = 1e-3, 0.999


def card_lines():
    """nvidia-smi's `name, power.limit` of every card (a child process
    that stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _compile(name, lowerable, *args):
    """AOT-compile `lowerable` for `args`; prints the program's
    memory_analysis() and returns the compile seconds."""
    t0 = time.perf_counter()
    compiled = lowerable.lower(*args).compile()
    secs = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(ma, k)}
    print(json.dumps({"program": name, "compile_s": secs,
                      "memory_analysis": mem}), flush=True)
    return secs


def _timed(fn):
    """Warm-up call of `fn()`, then one timed call -> (result, ms)."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, (time.perf_counter() - t0) * 1e3


def _finite(state):
    return {f.name: bool(np.isfinite(np.asarray(getattr(state, f.name))).all())
            for f in dataclasses.fields(state)}


def terrain_state(size, seed=0.0, **zeros_kw):
    """The flagship terrain (bench.py's): FBm noise, z-scale 4."""
    h = soil.noise((size, size), soil.noise_t(seed=seed)) * 0.5 + 1.0
    return soil.ErosionState.zeros((size, size), height=h, **zeros_kw)


def _params(rounds, **kw):
    p = soil.ErosionParams()
    p.transportIterations = rounds
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _per_cell(got, want, fields=STEP_FIELDS, rtol=STEP_RTOL, atol=STEP_ATOL):
    """Per-cell comparison: max |got - want| / (atol + rtol |want|) (<= 1
    passes), how many cells miss it, and the largest relative error."""
    out = {}
    for f in fields:
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        r = np.abs(a - b) / (atol + rtol * np.abs(b))
        out[f] = {"err_over_tol": float(r.max()),
                  "cells_over": int((r > 1.0).sum()), "cells": int(r.size),
                  "max_rel": float(np.max(np.abs(a - b)
                                          / np.maximum(np.abs(b), 1e-30)))}
    return out


def _worst(per_cell):
    return max(v["err_over_tol"] for v in per_cell.values())


def _integrals(got, want):
    """Schedule-robust agreement per field: relative difference of the
    totals and the correlation of the fields; raises if either misses
    SUM_RTOL / MIN_CORR."""
    out = {}
    for f in STEP_FIELDS:
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        dsum = abs(a.sum() - b.sum()) / max(abs(b.sum()), 1e-12)
        sa, sb = a - a.mean(), b - b.mean()
        denom = np.sqrt((sa * sa).sum() * (sb * sb).sum())
        corr = float((sa * sb).sum() / denom) if denom > 0 else 1.0
        out[f] = {"sum_rel": float(dsum), "corr": corr}
        assert dsum <= SUM_RTOL and corr >= MIN_CORR, (f, out[f])
    return out


# --------------------------------------------------------------------------
# Phases. Each returns a dict of results and raises AssertionError when a
# check fails; sizes are arguments so the tests can run them on the CPU.
# --------------------------------------------------------------------------


def phase_devices(cache_dir):
    return {
        "cards": card_lines(),
        "devices": [str(d) for d in jax.devices()],
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": cache_dir,
    }


def phase_golden(traj=((128, 30, "golden_traj128.npz"),
                       (256, 100, "golden_traj256.npz"))):
    """tests/test_golden.py's goldens at their own tolerances."""
    from tests import test_golden as tg

    t0 = time.perf_counter()
    tg.test_erosion_trajectory_matches_golden()
    out = {"golden64_s": time.perf_counter() - t0}
    for n, steps, npz in traj:
        t0 = time.perf_counter()
        tg._check_traj(n, steps, npz)
        out[f"traj{n}_s"] = time.perf_counter() - t0
    return out


def phase_step_vs_cpu(dev, cpu, size=1024, rounds=32):
    """One coupled step (albedo on) on `dev` and on the CPU backend from
    identical inputs. With one transport round the step is well
    conditioned and every cell must meet the STEP_* bar — that checks
    each of the step's compiled kernels against the CPU's; at `rounds`
    the per-cell result is reported and the SUM_RTOL/MIN_CORR bar
    decides."""
    state = jax.device_put(terrain_state(size), dev)
    key = jax.device_put(jax.random.PRNGKey(1), dev)
    out = {}
    for r in (1, rounds):
        step = soil.make_erode_fn(_params(r), SCALE)
        out[f"r{r}_compile_s"] = _compile(f"step{size}_r{r}", step, state,
                                          key)
        got, out[f"r{r}_ms_per_step"] = _timed(lambda: step(state, key))
        want = step(jax.device_put(state, cpu), jax.device_put(key, cpu))
        out[f"r{r}_per_cell"] = _per_cell(got, want)
        if r == 1:
            assert _worst(out["r1_per_cell"]) <= 1.0, (
                "1-round step, device vs cpu", out["r1_per_cell"])
        else:
            out[f"r{r}_integrals"] = _integrals(got, want)
    out["peak_bytes"] = _peak_bytes(dev)
    return out


def phase_flagship(dev, size=4096, rounds=32, steps=3):
    """`steps` steps through ErosionSim.step (default closure, albedo
    on), with tests/test_erosion.py's sanity checks."""
    param = _params(rounds)
    sim = soil.ErosionSim((size, size), SCALE, param,
                          state=terrain_state(size))
    h0 = np.asarray(sim.state.height)
    compile_s = _compile(f"flagship{size}_r{rounds}",
                         soil.make_erode_fn(param, SCALE), sim.state,
                         jax.random.PRNGKey(0))
    sim.step()
    jax.block_until_ready(sim.state)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        sim.step()
    jax.block_until_ready(sim.state)
    ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    finite = _finite(sim.state)
    assert all(finite.values()), f"non-finite fields: {finite}"
    assert (np.abs(np.asarray(sim.state.height) - h0) > 0).any(), \
        "terrain did not change"
    return {"compile_s": compile_s, "ms_per_step": ms,
            "gridpoint_steps_per_s": size * size / ms * 1e3,
            "peak_bytes": _peak_bytes(dev)}


def phase_faithful(dev, size=4096, maxage=512):
    """Reference-faithful depth (maxage-2 rounds) with the adaptive exit
    vs the fixed-depth solve of the same step, at
    tests/test_cohort_adaptive.py's tolerances."""
    state = terrain_state(size)
    key = jax.random.PRNGKey(0)
    out = {}
    runs = {}
    for name, tol in (("adaptive", 1e-6), ("fixed", 0.0)):
        param = _params(0, maxage=maxage, transportTol=tol)
        fn = soil.make_erode_fn(param, SCALE)
        out[f"{name}_compile_s"] = _compile(f"faithful{size}_{name}", fn,
                                            state, key)
        runs[name], out[f"{name}_ms_per_step"] = _timed(
            lambda: fn(state, key))
    a, f = runs["adaptive"], runs["fixed"]
    out["per_cell"] = {**_per_cell(a, f, ("height",), 1e-5, 1e-6),
                       **_per_cell(a, f, ("discharge",), 1e-4, 1e-5)}
    assert _worst(out["per_cell"]) <= 1.0, out["per_cell"]
    out["peak_bytes"] = _peak_bytes(dev)
    return out


def _capacity_state(size):
    # bench.py's compact constants: rainfall, uplift and bedrock albedo
    # ride as broadcastable scalars.
    return terrain_state(size, rainfall=1.0, uplift=0.0,
                         albedo_bedrock=(1.0, 1.0, 1.0),
                         albedo_surface=(1.0, 1.0, 1.0))


def phase_capacity(dev, size=8192, rounds=32):
    """One donated step at `size`² with albedo off; then whether the
    albedo-on step fits the card too (reported, never a failure)."""
    out = {}
    param = _params(rounds, trackAlbedo=False)
    fn = soil.make_erode_fn(param, SCALE, donate=True)
    state, key = _capacity_state(size), jax.random.PRNGKey(0)
    out["compile_s"] = _compile(f"capacity{size}_albedo_off", fn, state, key)
    state = jax.block_until_ready(fn(state, key))  # warm-up (donated)
    t0 = time.perf_counter()
    state = jax.block_until_ready(fn(state, key))
    out["ms_per_step"] = (time.perf_counter() - t0) * 1e3
    finite = _finite(state)
    assert all(finite.values()), f"non-finite fields: {finite}"
    out["peak_bytes"] = _peak_bytes(dev)
    del state
    param_on = _params(rounds, trackAlbedo=True)
    fn_on = soil.make_erode_fn(param_on, SCALE, donate=True)
    try:
        state = _capacity_state(size)
        out["albedo_on_compile_s"] = _compile(
            f"capacity{size}_albedo_on", fn_on, state, key)
        state = jax.block_until_ready(fn_on(state, key))
        out["albedo_on_fits"] = bool(np.isfinite(
            np.asarray(state.height)).all())
    except Exception as e:  # report the out-of-memory, keep going
        if "RESOURCE_EXHAUSTED" not in str(e) and "memory" not in str(e):
            raise
        out["albedo_on_fits"] = False
        out["albedo_on_error"] = str(e).splitlines()[0][:300]
    out["peak_bytes_after_albedo_on"] = _peak_bytes(dev)
    return out


def phase_quality(dev, size=2048, rounds=32):
    """Quality mode: CohortClosure(nodes=4, colors=8), one timed step."""
    param = _params(rounds, closure=soil.CohortClosure(nodes=4, colors=8))
    fn = soil.make_erode_fn(param, SCALE)
    state, key = terrain_state(size), jax.random.PRNGKey(0)
    compile_s = _compile(f"quality{size}_n4c8", fn, state, key)
    state, ms = _timed(lambda: fn(state, key))
    finite = _finite(state)
    assert all(finite.values()), f"non-finite fields: {finite}"
    return {"compile_s": compile_s, "ms_per_step": ms,
            "peak_bytes": _peak_bytes(dev)}


def phase_dem(dev, size=4096):
    """noise -> steepest -> accumulate by all three methods, which must
    agree to tests/test_graph.py's tolerances; each one timed."""
    from soillib_tpu.ops.graph import DEFAULT_METHOD

    h = soil.noise((size, size), soil.noise_t())
    steepest = jax.jit(lambda h: soil.steepest(h, soil.d8))
    out = {"steepest_compile_s": _compile(f"steepest{size}", steepest, h)}
    flow, out["steepest_ms"] = _timed(lambda: steepest(h))
    rain = jnp.ones((size, size), jnp.float32)
    acc = {}
    for m in ("doubling", "stencil", "tiled"):
        fn = jax.jit(lambda g, r, m=m: soil.accumulate(g, r, soil.d8,
                                                       method=m))
        out[f"{m}_compile_s"] = _compile(f"accumulate{size}_{m}", fn,
                                         flow, rain)
        acc[m], out[f"{m}_ms"] = _timed(lambda: fn(flow, rain))
    want = np.asarray(acc["doubling"], np.float64)
    tol = {"stencil": (1e-5, 1e-5), "tiled": (1e-5, 1e-4)}
    for m, (rtol, atol) in tol.items():
        got = np.asarray(acc[m], np.float64)
        out[f"{m}_err_over_tol"] = float(
            np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))
        assert out[f"{m}_err_over_tol"] <= 1.0, (m, out)
    out["fastest"] = min(("doubling", "stencil", "tiled"),
                         key=lambda m: out[f"{m}_ms"])
    out["default_method"] = DEFAULT_METHOD
    out["peak_bytes"] = _peak_bytes(dev)
    return out


def phase_sharded(devs, size=8192, rounds=32, steps=2):
    """make_sharded_erode_fn over a 2x2 mesh of `devs` vs the
    single-device step on devs[0], compared after every step."""
    from soillib_tpu import parallel as par

    mesh = par.make_mesh((2, 2), devices=np.array(devs[:4]))
    param = _params(rounds, trackAlbedo=False)
    state0 = jax.device_put(_capacity_state(size), devs[0])
    sharded = par.shard_state(state0, mesh)
    fn = par.make_sharded_erode_fn(mesh, SCALE, param,
                                   state_template=state0)
    single = soil.make_erode_fn(param, SCALE)
    key = jax.random.PRNGKey(0)
    out = {"compile_s": _compile(f"sharded{size}_2x2", fn, sharded, key),
           "ms_per_step": [], "per_cell": [], "integrals": []}
    ref = state0
    for i in range(steps):
        t0 = time.perf_counter()
        sharded = jax.block_until_ready(fn(sharded, key))
        out["ms_per_step"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["peak_bytes_per_card"] = [_peak_bytes(d) for d in devs[:4]]
        ref = single(ref, key)
        out["per_cell"].append(_per_cell(sharded, ref))
        # Step 1 must meet the per-cell bar (__graft_entry__.py's); later
        # steps the schedule-robust one, as tests/test_parallel.py does.
        if i == 0:
            assert _worst(out["per_cell"][0]) <= 1.0, (
                "step 1, sharded vs single", out["per_cell"][0])
        else:
            out["integrals"].append(_integrals(sharded, ref))
    return out


def _run(name, fn, kind, failures):
    t0 = time.perf_counter()
    rec = {"phase": name, "device_kind": kind}
    try:
        rec.update(fn())
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        traceback.print_exc(file=sys.stderr)
        failures.append(name)
    rec["wall_s"] = time.perf_counter() - t0
    print(json.dumps(rec, default=str), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded 2x2-mesh phase")
    args = ap.parse_args(argv)

    # One process owns the card(s): let it use most of the memory (the
    # 8192² capacity phase is the point of measuring it).
    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.95")
    try:
        gpus = jax.devices("gpu")
    except RuntimeError as e:
        sys.exit(f"chip_smoke: no GPU visible to JAX ({e})")
    if len(gpus) < args.devices:
        sys.exit(f"chip_smoke: need {args.devices} GPUs, found {len(gpus)}")
    cpu = jax.devices("cpu")[0]
    dev = gpus[0]
    kind = dev.device_kind

    from soillib_tpu.core.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    failures = []
    if args.devices == 4:
        _run("sharded", lambda: phase_sharded(gpus), kind, failures)
    else:
        phases = [
            ("devices", lambda: phase_devices(cache_dir)),
            ("golden", phase_golden),
            ("step-vs-cpu", lambda: phase_step_vs_cpu(dev, cpu)),
            ("flagship", lambda: phase_flagship(dev)),
            ("faithful", lambda: phase_faithful(dev)),
            ("capacity", lambda: phase_capacity(dev)),
            ("quality", lambda: phase_quality(dev)),
            ("dem", lambda: phase_dem(dev)),
        ]
        with jax.default_device(dev):
            for name, fn in phases:
                _run(name, fn, kind, failures)
    for line in card_lines():
        print(line)
    if failures:
        sys.exit(f"chip_smoke: failed phases: {failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
