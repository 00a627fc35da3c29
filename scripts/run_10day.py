#!/usr/bin/env python
"""Production-run protocol at 1/4 degree.

Executes the reference's run protocol end-to-end on the coupled data-free
climate model (tripolar + gaussian islands + CATKE + coupled fluxes —
the north-star workload) at the 1536x768x64 quarter-degree grid:

  * 10 simulated days via ``simulation/simulation.py`` (reference:
    /root/reference/simulations/ocean_climate_simulation.jl:90-139),
  * progress callback every 10 iterations,
  * 3-day surface output writer,
  * periodic checkpoint (CheckpointWriter, 5-day interval),
  * a REAL kill/resume: the ``interrupt`` phase runs to day 5, checkpoints,
    and the process exits; the ``resume`` phase is a NEW process that
    restores from the day-5 checkpoint and continues to day 10,
  * bitwise comparison of the resumed day-10 state against the
    uninterrupted run's day-10 state.

Phases (each its own process; ``--phase all`` orchestrates):
    full      -> <out>/full_final/      (uninterrupted 10-day state)
    interrupt -> <out>/ckpt/ckpt_iter*  (day-5 checkpoint, then exit)
    resume    -> <out>/resume_final/    (restored, day 5 -> 10)
    compare   -> <out>/run_10day.json   (bitwise verdict + stats)
"""

import argparse
import glob
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def build(nx, nz, dt_dtype="float32"):
    import jax
    import jax.numpy as jnp

    from gb25_tpu.models.coupled import coupled_loop, data_free_ocean_climate_model

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=384.0 / nx, Nz=nz, dtype=jnp.dtype(dt_dtype),
        grid_type="gaussian_islands_tripolar",
    )
    _cl = jax.jit(coupled_loop, static_argnames="n")

    # atmos rides as a jit argument (not a closure constant): the
    # pre-regridded record would otherwise bake into the IR (bench.py note)
    def step_fn(cfg_unused, grid_, s, dt, n):
        return _cl(ccfg, grid_, atmos, s, dt, n)

    return ccfg, grid, atmos, state, step_fn


def make_sim(grid, state, step_fn, dt, stop_days, out, ccfg, tag,
             total_days=10.0):
    from gb25_tpu.io import NPZOutputWriter
    from gb25_tpu.simulation import IterationInterval, Simulation, progress_callback
    from gb25_tpu.simulation.simulation import CheckpointWriter

    sim = Simulation(ccfg.ocean, grid, state, dt=dt,
                     stop_time=stop_days * 86400.0, inner_steps=10,
                     step_fn=step_fn)
    sim.add_callback(progress_callback, IterationInterval(10))
    # reference protocol intervals (3-day writer / 5-day checkpoint at a
    # 10-day run) scale with --days so smoke runs exercise the same logic
    sim.add_output_writer(NPZOutputWriter(os.path.join(out, f"surface_{tag}"),
                                          interval_seconds=0.3 * total_days * 86400.0))
    # per-phase checkpoint dirs: resume must restore from the INTERRUPTED
    # phase's day-5 checkpoint, never the full run's day-10 one
    ckpt = CheckpointWriter(os.path.join(out, f"ckpt_{tag}"),
                            interval_seconds=0.5 * total_days * 86400.0,
                            keep=3)
    sim.add_output_writer(ckpt)
    return sim, ckpt


def state_stats(state):
    import jax
    import jax.numpy as jnp

    mu = float(jax.device_get(jnp.abs(state.u).max()))
    T = state.tracers["T"]
    finite = all(bool(jnp.isfinite(x).all())
                 for x in jax.tree_util.tree_leaves(state))
    return {"max_abs_u": mu,
            "T_min": float(jax.device_get(T.min())),
            "T_max": float(jax.device_get(T.max())),
            "finite": finite}


def run_phase(args, stop_days, final_dir, restore_from=None, tag="full"):
    from gb25_tpu.io import restore_state, save_sharded_state
    from gb25_tpu.utils.cache import enable_persistent_cache
    from gb25_tpu.utils.env import preamble

    preamble()
    enable_persistent_cache()
    ccfg, grid, atmos, state, step_fn = build(args.nx, args.nz)
    if restore_from:
        state = restore_state(state, restore_from)
        print(f"restored from {restore_from}: iter={int(state.iteration)} "
              f"t={float(state.time)/86400.0:.2f} days", flush=True)
    sim, ckpt = make_sim(grid, state, step_fn, args.dt, stop_days,
                         args.out, ccfg, tag, total_days=args.days)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    stats = state_stats(sim.state)
    if final_dir:
        save_sharded_state(sim.state, final_dir)
    steps = sim.iteration - (int(np.floor(float(state.time) / args.dt + 0.5))
                             if restore_from else 0)
    info = {"iteration": sim.iteration, "t_days": sim.time / 86400.0,
            "wall_s": round(wall, 1),
            "ms_per_step": round(1e3 * wall / max(steps, 1), 2),
            "checkpoints": sorted(glob.glob(os.path.join(
                args.out, f"ckpt_{tag}", "ckpt_iter*"))),
            **stats}
    print("PHASE_RESULT " + json.dumps(info), flush=True)
    return info


def compare(args):
    from gb25_tpu.io.checkpoint import load_all_fields

    a = load_all_fields(os.path.join(args.out, "full_final"))
    b = load_all_fields(os.path.join(args.out, "resume_final"))
    mism = {}
    for k in a:
        if not np.array_equal(a[k], b[k]):
            d = np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
            mism[k] = float(d.max())
    return {"bitwise_equal": not mism, "mismatched_fields": mism,
            "n_fields": len(a)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--phase", default="all",
                   choices=["all", "full", "interrupt", "resume", "compare"])
    p.add_argument("--nx", type=int, default=1536)
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--dt", type=float, default=60.0,
                   help="60 s clears the unbalanced-init adjustment "
                        "transient's w-CFL at 1/4 degree "
                        "(ROADMAP.md, eddy-saturation validation)")
    p.add_argument("--days", type=float, default=10.0)
    p.add_argument("--out", default="run10day_output")
    p.add_argument("--json-out", default=None,
                   help="default: <out>/run_10day.json")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    if args.phase == "full":
        run_phase(args, args.days, os.path.join(args.out, "full_final"),
                  tag="full")
    elif args.phase == "interrupt":
        # runs to day/2, checkpoints (5-day CheckpointWriter boundary),
        # then the process EXITS — the kill in kill/resume
        run_phase(args, args.days / 2.0, None, tag="interrupt")
    elif args.phase == "resume":
        cks = sorted(glob.glob(os.path.join(args.out, "ckpt_interrupt",
                                            "ckpt_iter*")))
        assert cks, "no checkpoint to resume from — run --phase interrupt first"
        run_phase(args, args.days, os.path.join(args.out, "resume_final"),
                  restore_from=cks[-1], tag="resume")
    elif args.phase == "compare":
        print(json.dumps(compare(args)))
    else:  # all: three separate processes + compare, one artifact
        import subprocess

        results = {"grid": f"{args.nx}x{args.nx // 2}x{args.nz}",
                   "dt_s": args.dt, "days": args.days,
                   "config": "data_free_climate_ocean "
                             "(tripolar+islands+CATKE+coupled fluxes)",
                   "protocol": "progress@10it, surface writer@3d, "
                               "checkpoint@5d, kill at day "
                               f"{args.days / 2:.0f}, restore in a new "
                               "process, bitwise compare at day "
                               f"{args.days:.0f}"}
        for phase in ["full", "interrupt", "resume"]:
            r = subprocess.run(
                [sys.executable, __file__, "--phase", phase,
                 "--nx", str(args.nx), "--nz", str(args.nz),
                 "--dt", str(args.dt), "--days", str(args.days),
                 "--out", args.out],
                capture_output=True, text=True, timeout=14400)
            lines = [l for l in r.stdout.splitlines()
                     if l.startswith("PHASE_RESULT ")]
            if r.returncode != 0 or not lines:
                results[phase] = {"error": (r.stderr or r.stdout).strip()[-800:]}
                print(json.dumps(results, indent=1))
                sys.exit(1)
            results[phase] = json.loads(lines[-1][len("PHASE_RESULT "):])
            print(f"phase {phase}: {results[phase]}", flush=True)
        results["comparison"] = compare(args)
        json_out = args.json_out or os.path.join(args.out, "run_10day.json")
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps(results["comparison"]))


if __name__ == "__main__":
    main()
