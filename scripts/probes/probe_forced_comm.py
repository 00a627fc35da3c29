"""Measure the decomposed (comm != None) step on ONE device via GB25_FORCE_COMM.

The weak-scaling projection's compute term was the
*serial* ms/step because a 1x1 mesh routes to the serial path. This probe
forces the decomposed program — identity-ring ppermutes, localize_grid,
overlap strip recompute + stitch, blocked barotropic solve, W-wide extends —
on one device and reports both numbers,
so the projection can be re-based on a measured distributed-path cost.

Reference product analog: the at-scale per-rank loop time,
/root/reference/analysis/weak-scaling/alps-weak-scaling.jl:8-16.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=1536)
    p.add_argument("--ny", type=int, default=768)
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--dt", type=float, default=60.0)
    p.add_argument("--no-serial", action="store_true")
    p.add_argument("--overlap", default="0", choices=["0", "1"],
                   help="overlap_split on the forced-comm path (ablation)")
    p.add_argument("--exchange-width", type=int, default=None,
                   help="SplitExplicitFreeSurface.exchange_width (e.g. 30 = "
                        "whole barotropic solve on one exchange block)")
    p.add_argument("--mode", default="both",
                   choices=["ring", "local", "both", "serial-shardmap"],
                   help="ring = identity ppermutes (includes the "
                        "collective latency); local = "
                        "decomposed program with local fills (the honest "
                        "compute-overhead number)")
    p.add_argument("--config", default="baroclinic",
                   choices=["baroclinic", "climate"],
                   help="climate = the coupled data-free climate ocean "
                        "(tripolar + gaussian islands + CATKE + coupled "
                        "fluxes) — the reference's actual benchmark "
                        "configuration; grid from --nx via resolution "
                        "384/(nx/4)")
    args = p.parse_args()

    from gb25_tpu.utils.env import preamble

    preamble()

    import dataclasses

    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import (
        baroclinic_instability_config,
        baroclinic_instability_state,
        loop,
    )
    from gb25_tpu.parallel import make_mesh, shard_state
    from gb25_tpu.parallel.sharded import sharded_step_fn
    from gb25_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    if args.config == "climate":
        from gb25_tpu.models.coupled import coupled_loop, data_free_ocean_climate_model
        from gb25_tpu.parallel.sharded import sharded_coupled_step_fn

        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=384.0 / args.nx, Nz=args.nz, dtype=jnp.float32,
            grid_type="gaussian_islands_tripolar")
        assert grid.immersed and grid.north_fold
        args.nx, args.ny = grid.Nx, grid.Ny
        if args.exchange_width:
            ocfg = dataclasses.replace(
                ccfg.ocean, free_surface=dataclasses.replace(
                    ccfg.ocean.free_surface,
                    exchange_width=args.exchange_width))
            ccfg = dataclasses.replace(ccfg, ocean=ocfg)
    else:
        grid = simple_latitude_longitude_grid(args.nx, args.ny, args.nz,
                                              dtype=jnp.float32)
        cfg = baroclinic_instability_config()
        cfg = dataclasses.replace(cfg, overlap_split=args.overlap == "1")
        if args.exchange_width:
            from gb25_tpu.models.config import SplitExplicitFreeSurface

            cfg = dataclasses.replace(
                cfg, free_surface=SplitExplicitFreeSurface(
                    exchange_width=args.exchange_width))
        state = baroclinic_instability_state(grid)
    dt = jnp.float32(args.dt)

    def sync(s):
        jax.device_get(s.iteration)

    out = {"grid": f"{args.nx}x{args.ny}x{args.nz}", "steps": args.steps,
           "overlap_split": args.overlap == "1", "config": args.config}

    if not args.no_serial:
        if args.config == "climate":
            _cl = jax.jit(coupled_loop, static_argnames="n")

            def lp(c, g, s, d, n):
                return _cl(ccfg, g, atmos, s, d, n)

            cfg = None
        else:
            lp = jax.jit(loop, static_argnames="n")
        s = lp(cfg, grid, state, dt, args.steps)
        sync(s)
        t0 = time.perf_counter()
        s = lp(cfg, grid, s, dt, args.steps)
        sync(s)
        out["serial_ms_per_step"] = round(
            1e3 * (time.perf_counter() - t0) / args.steps, 2)

    mesh = make_mesh(1, shape=(1, 1))
    modes = ["local", "ring"] if args.mode == "both" else [args.mode]
    for mode in modes:
        # serial-shardmap: the 1x1 serial-routed path (comm=None) under
        # shard_map — isolates the shard_map wrapper cost from the
        # decomposed-program cost
        if args.config == "climate":
            fn = sharded_coupled_step_fn(
                ccfg, grid, atmos, mesh, n_inner=args.steps,
                force_comm=(False if mode == "serial-shardmap" else mode))
        else:
            fn = sharded_step_fn(cfg, grid, mesh, n_inner=args.steps,
                                 force_comm=(False if mode == "serial-shardmap"
                                             else mode))
        s = shard_state(state, mesh)
        s = fn(s, dt)
        sync(s)
        t0 = time.perf_counter()
        s = fn(s, dt)
        sync(s)
        out[f"forced_comm_{mode}_ms_per_step"] = round(
            1e3 * (time.perf_counter() - t0) / args.steps, 2)
        if "serial_ms_per_step" in out:
            out[f"overhead_{mode}_pct"] = round(
                100.0 * (out[f"forced_comm_{mode}_ms_per_step"]
                         / out["serial_ms_per_step"] - 1.0), 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
