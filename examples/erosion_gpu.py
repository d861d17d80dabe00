"""Coupled hydraulic + debris-flow erosion on one device.

The flagship workload (reference: example/erosion_gpu.py — 256² grid,
20 km world, 512 coupled steps, timed per step). Parameters mirror the
reference script's configuration (erosion_gpu.py:75-100); the whole step
is one jitted program, so the Python loop only paces the device.

    python examples/erosion_gpu.py [--res 256] [--steps 512] [--out DIR]
"""

import argparse
import os
import time

import jax
import numpy as np

import soillib_tpu as soil
from soillib_tpu.core.compile_cache import enable_compile_cache


def make_param() -> soil.ErosionParams:
    p = soil.param_t()
    p.timeStep = 1000.0
    p.samples = 8192
    p.maxage = 256
    p.lrate = 1.0
    p.gravity = 9.81
    p.uplift = 0.01
    p.rainfall = 1.0
    p.evapRate = 0.0005
    p.viscosity = 0.000001          # legacy alias -> viscosityWater
    p.bedShear = 12.5
    p.suspensionRate = 0.0008
    p.depositionRate = 0.00001
    p.fluvialExponent = 0.01
    p.exitSlope = 0.025
    p.critSlope = 0.57
    p.debrisCreepRate = 0.0025
    p.debrisSuspensionRate = 0.00025
    p.debrisDepositionRate = 0.0001
    p.debrisYieldStress = 2e6
    p.debrisDensity = 2500.0
    p.debrisViscosity = 0.004
    p.debrisBedShear = 60 / 2500.0
    p.transportIterations = 64      # deterministic field-solve rounds
    return p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--report", type=int, default=32)
    ap.add_argument("--out", default="out/erosion")
    ap.add_argument("--quality", action="store_true",
                    help="mixture quality mode (CohortClosure(nodes=4, "
                         "colors=8), RESULTS.md quality-mode study; debris "
                         "keeps the default closure, see "
                         "ErosionParams.closureDebris)")
    ap.add_argument("--faithful", action="store_true",
                    help="reference-faithful transport depth: maxage-2 "
                         "rounds as an upper bound with the convergence-"
                         "adaptive exit (transportTol=1e-6) — matches "
                         "the fixed full-depth solve to f32 roundoff "
                         "while skipping dead rounds (erosion.cu:101)")
    args = ap.parse_args()
    enable_compile_cache()

    res = (args.res, args.res)
    wscale = (20.0, 20.0, 4.0)                      # world scale [km]
    pscale = (wscale[0] / res[0], wscale[1] / res[1], wscale[2])

    height = soil.noise(res, soil.noise_t(seed=3.0, ext=(res[0], res[1])))
    state = soil.ErosionState.zeros(res, height=height)
    param = make_param()
    if args.quality:
        param.closure = soil.CohortClosure(nodes=4, colors=8)
    if args.faithful:
        param.transportIterations = 0   # -> maxage-2 rounds (the bound)
        param.transportTol = 1e-6       # adaptive exit pays only live rounds

    sim = soil.ErosionSim(res, pscale, param, state=state)
    done = 0
    while done < args.steps:
        n = min(args.report, args.steps - done)
        with soil.timer(soil.ms) as t:
            sim.step(n)
            t.wait(sim.state.layers)
        done += n
        print(f"steps {done:4d}/{args.steps}: {t.count / n:.2f} ms/step")

    os.makedirs(args.out, exist_ok=True)
    soil.util.zip_save(
        os.path.join(args.out, "erosion.zip"),
        {
            "height": np.asarray(sim.state.height),
            "sediment": np.asarray(sim.state.sediment),
            "discharge": np.asarray(sim.state.discharge),
        },
        pscale,
    )
    soil.util.show_height(sim.state.height,
                          save=os.path.join(args.out, "height.png"))
    soil.util.show_discharge(sim.state.discharge,
                             save=os.path.join(args.out, "discharge.png"))
    print(f"wrote {args.out}/erosion.zip")


if __name__ == "__main__":
    main()
