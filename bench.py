"""Headline benchmark: coupled erosion step throughput on one GPU.

Config is the BASELINE.md north star: 4096² grid, full coupled step
(fluvial + debris age-structured cohort transport @ 32 rounds each, mass
transfer, creep), one card. The reference publishes no numbers
(BASELINE.md), so `vs_baseline` is the step rate over the step's own
speed-of-light: the lower of

  * memory roofline — the card's peak HBM bandwidth over the bytes one
    step's transport rounds move: XLA's own count (`cost_analysis()`
    "bytes accessed") of one compiled fluvial round and one debris round
    at the benchmarked size, times the rounds, and
  * compute roofline — the card's peak f32 rate over the elementwise ops
    of those rounds, counted from their jaxprs with every op weighted 1.

The ~5% of step work outside the transport rounds is excluded from both,
so vs_baseline == 1.0 is a true ceiling. The peaks come from one table
keyed by `device_kind` (PEAKS); a card that is not in it is an error.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "gridpoint-steps/s", "vs_baseline": N,
   ...the inputs of both ceilings and the per-round measurements...}

    python bench.py [--size 4096] [--iters 32|auto] [--steps 8]
"""

import argparse
import json
import math
import re
import sys
import time

import jax
import jax.numpy as jnp

# Published peaks by `device_kind` (NVIDIA H100 SXM data sheet: 80 GB
# HBM3 at 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores). They
# assume the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}


def peaks(kind: str) -> dict:
    """Peak rates of a device kind; an unknown kind raises."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {kind!r}: add its data-sheet "
            f"numbers to bench.PEAKS"
        ) from None


# Elementwise primitives counted as one op each; everything else (layout,
# control flow, reductions) is free at this granularity.
_COUNTED = {
    "add", "sub", "mul", "max", "min", "neg", "abs", "sign", "floor",
    "and", "or", "xor", "not", "lt", "le", "gt", "ge", "eq", "ne",
    "select_n", "clamp", "concatenate", "rev", "convert_element_type",
    "stop_gradient", "integer_pow", "is_finite", "shift_right_logical",
    "shift_left", "rem", "exp", "log", "exp2", "log2", "tanh", "div",
    "sqrt", "rsqrt", "pow",
}


def _count_ops(jaxpr):
    """Elementwise op count of a jaxpr (recursing into calls), with a
    local value-numbering CSE so duplicated subexpressions — which XLA
    deduplicates before lowering — are not double-counted (counting them
    would understate the speed-of-light and flatter vs_baseline)."""
    import numpy as np
    from jax.extend.core import Literal

    total = 0
    canon = {}
    seen = {}

    def cid(v):
        if isinstance(v, Literal):
            val = np.asarray(v.val)
            return ("lit", val.tobytes() if val.size <= 16 else id(v))
        return canon.get(v, v)

    for eqn in jaxpr.eqns:
        sub = [v for k, v in eqn.params.items()
               if k in ("jaxpr", "call_jaxpr", "branches", "cond_jaxpr",
                        "body_jaxpr")]
        if sub:
            for s in sub:
                core = getattr(s, "jaxpr", s)
                for c in core if isinstance(core, (list, tuple)) else [core]:
                    total += _count_ops(getattr(c, "jaxpr", c))
            continue
        prim = eqn.primitive.name
        if not eqn.outvars or prim not in _COUNTED:
            continue
        key = (prim, tuple(cid(v) for v in eqn.invars),
               str(sorted(eqn.params.items())))
        if key in seen:
            for ov, prev in zip(eqn.outvars, seen[key]):
                canon[ov] = prev
            continue
        seen[key] = [cid(ov) for ov in eqn.outvars]
        total += max(math.prod(getattr(ov.aval, "shape", ()))
                     for ov in eqn.outvars)
    return total


def _round_fns(albedo_on=True):
    """{phase: (round_fn, (S, C, A))} — ONE fluvial and ONE debris cohort
    round with the REAL model closures (models/erosion.py
    make_fluvial_rules / make_debris_rules + ops/cohort.py cohort_round).
    `albedo_on` must match the benchmarked config: with trackAlbedo off
    the solves carry 3 fewer channels each."""
    from soillib_tpu.models.erosion import make_debris_rules, \
        make_fluvial_rules
    from soillib_tpu.models.params import ErosionParams
    from soillib_tpu.ops import cohort as co

    p = ErosionParams()
    p.trackAlbedo = albedo_on
    Llen = 0.11
    out = {}
    for phase, (C, rules) in {
        "fluvial": (7 if albedo_on else 4, make_fluvial_rules(p, Llen)),
        "debris": (6 if albedo_on else 3, make_debris_rules(p, Llen, 1.0)),
    }.items():
        def one_round(st, G, aux, rules=rules):
            return co.cohort_round(st, G, aux, rules, Llen, co.shift_push)

        out[phase] = (one_round, (co.NSTATE + C, C, 4))
    return out


def _round_inputs(S, C, A, W, H):
    return (jnp.ones((S, W, H), jnp.float32),
            jnp.zeros((C, W, H), jnp.float32),
            jnp.ones((A, W, H), jnp.float32))


def cohort_round_ops(albedo_on=True):
    """Per-cell elementwise op count of ONE fluvial and ONE debris round."""
    W, H = 8, 128
    return {
        phase: _count_ops(jax.make_jaxpr(fn)(
            *_round_inputs(*dims, W, H)).jaxpr) / (W * H)
        for phase, (fn, dims) in _round_fns(albedo_on).items()
    }


# HLO opcodes of a compiled module that launch no kernel of their own.
_NO_KERNEL = {"parameter", "constant", "tuple", "get-tuple-element",
              "bitcast"}
_OPCODE = re.compile(r"\s([a-z][a-z0-9_-]*)\(")


def _entry_kernels(hlo_text):
    """Instructions of the compiled module's ENTRY computation that run
    as kernels (fusions, copies, reductions, library calls)."""
    n, inside = 0, False
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY "):
            inside = True
            continue
        if inside:
            if line.startswith("}"):
                break
            # "%x = f32[17,4096,4096]{2,1,0} fusion(...), ..." -> "fusion"
            m = _OPCODE.search(line.split("=", 1)[-1])
            if m and m.group(1) not in _NO_KERNEL:
                n += 1
    return n


def round_profile(size, albedo_on=True, rounds=32):
    """XLA's plain cohort round at `size`², per phase: kernels in the
    compiled single-round program, the bytes XLA says it accesses, and
    the measured ms per round (a jitted `rounds`-round loop, timed after
    a warm-up)."""
    out = {}
    for phase, (fn, (S, C, A)) in _round_fns(albedo_on).items():
        args = _round_inputs(S, C, A, size, size)
        compiled = jax.jit(fn).lower(*args).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost

        @jax.jit
        def loop(st, G, aux, fn=fn):
            return jax.lax.fori_loop(
                0, rounds, lambda _, c: fn(c[0], c[1], aux), (st, G))

        jax.block_until_ready(loop(*args))
        t0 = time.perf_counter()
        jax.block_until_ready(loop(*args))
        ms = (time.perf_counter() - t0) * 1e3 / rounds
        out[phase] = {
            "kernels": _entry_kernels(compiled.as_text()),
            "bytes": float(cost["bytes accessed"]),
            "ms": ms,
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096, help="grid edge")
    ap.add_argument("--iters", default="32",
                    help="transport rounds (int), or 'auto' = the "
                         "reference-faithful depth (maxage-2 = 510 rounds, "
                         "erosion.cu:101) with the convergence-adaptive "
                         "exit (transportTol=1e-6): rounds run only while "
                         "cohorts still carry deposit mass")
    ap.add_argument("--steps", type=int, default=8, help="timed steps")
    ap.add_argument("--albedo", choices=("on", "off"), default="on",
                    help="albedo instrumentation (off = 8192² capacity "
                         "mode: 3 fewer carried channels per transport "
                         "solve, albedo state stays constant)")
    args = ap.parse_args()

    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError as e:
        sys.exit(f"bench.py measures the GPU and found none: {e}")
    peak = peaks(dev.device_kind)

    import soillib_tpu as soil
    from soillib_tpu.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    W = H = args.size
    scale = (0.078, 0.078, 4.0)
    height = soil.noise((W, H), soil.noise_t()) * 0.5 + 1.0
    # Constant fields as broadcastable (1, 1) scalars: rainfall, uplift and
    # bedrock albedo pass through the step unchanged, so full-grid copies
    # of them would only cost memory.
    state = soil.ErosionState.zeros((W, H), height=height, rainfall=1.0,
                                    uplift=0.0,
                                    albedo_bedrock=(1.0, 1.0, 1.0),
                                    albedo_surface=(1.0, 1.0, 1.0))
    del height
    param = soil.ErosionParams()
    auto = args.iters == "auto"
    if auto:
        # Reference-faithful depth: transportIterations=0 -> maxage-2 =
        # 510 rounds as the UPPER bound; the adaptive exit skips the
        # rounds after every cohort has died.
        param.transportIterations = 0
        param.transportTol = 1e-6
        iters_n = max(param.maxage - 2, 1)
    else:
        param.transportIterations = iters_n = int(args.iters)
    albedo_on = args.albedo == "on"
    param.trackAlbedo = albedo_on

    step = soil.make_erode_fn(param, scale, steps=1)
    key = jax.random.PRNGKey(0)

    # Warm up until the state's leaf shapes stabilize: with albedo
    # tracked, the first call broadcasts (3, 1, 1) constant albedo fields
    # to full size, so the SECOND call compiles a second program — which
    # must not land inside the timed window.
    for _ in range(3):
        shapes = jax.tree_util.tree_map(jnp.shape, state)
        state = jax.block_until_ready(step(state, key))
        if jax.tree_util.tree_map(jnp.shape, state) == shapes:
            break

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = step(state, key)
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / args.steps
    value = W * H / dt

    prof = round_profile(args.size, albedo_on)
    ops = cohort_round_ops(albedo_on)
    bytes_per_cell_step = iters_n * sum(
        p["bytes"] for p in prof.values()) / (W * H)
    ops_per_cell_step = iters_n * sum(ops.values())
    hbm_sol = peak["hbm_bytes_per_s"] / bytes_per_cell_step
    compute_sol = peak["f32_flops_per_s"] / ops_per_cell_step
    sol = min(hbm_sol, compute_sol)
    depth = f"auto(<={iters_n})" if auto else str(iters_n)
    print(
        json.dumps(
            {
                "metric": f"coupled erosion grid-point-steps/s/chip "
                          f"@{W}x{H}, {depth} transport rounds",
                "value": value,
                "unit": "gridpoint-steps/s",
                "vs_baseline": value / sol,
                "ms_per_step": dt * 1e3,
                "hbm_sol": hbm_sol,
                "compute_sol": compute_sol,
                "binding": "memory" if hbm_sol < compute_sol else "compute",
                "bytes_per_cell_step": bytes_per_cell_step,
                "ops_per_cell_step": ops_per_cell_step,
                "round": prof,
                "round_ops_per_cell": ops,
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
