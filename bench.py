"""Benchmark: baroclinic-instability time step throughput on one device.

Reference benchmark unit (BASELINE.md): one compiled loop of **256 time
steps** of the sharded baroclinic-instability model, timing the *second*
loop (/root/reference/sharding/sharded_baroclinic_instability_simulation_run.jl:96);
per-GPU tile 768x768x64 on Alps GH200 at ~221 ms/step -> 1.708e8
cell-steps/s per GPU. We report cell-steps/s/device on the same physics
configuration (SplitExplicitFreeSurface(substeps=30), WENO-5
momentum+tracers, TEOS10), with vs_baseline = ours / reference-per-GPU.

Every row runs in this one process on ``jax.devices()[0]``, with the state
donated to each loop and the time taken around ``jax.block_until_ready``.
The device (platform, kind, count, and the card's name and power limit) is
part of the output; the peak rates that ``hbm_pct_peak`` divides by come
from ``gb25_tpu.utils.device.PEAKS``, and a device missing there is an error.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}.
"""

import argparse
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp

REFERENCE_CELL_STEPS_PER_SEC = 768 * 768 * 64 / 0.221  # Alps GH200 per-GPU


def time_loop(lp, state, steps):
    """Run ``lp(state, steps)`` twice (the first call compiles) and time the
    second loop, as the reference does. ``lp`` donates its state, so every
    leaf first gets a buffer of its own (initial states share zero arrays)."""
    state = jax.tree_util.tree_map(jnp.copy, state)
    state = jax.block_until_ready(lp(state, steps))
    t0 = time.perf_counter()
    state = jax.block_until_ready(lp(state, steps))
    return time.perf_counter() - t0, state


def _loop_fn(loop, cfg, grid, dt):
    """``lp(state, n)``: ``loop(cfg, grid, state, dt, n)`` jitted with the
    state donated (config, grid and dt ride as arguments, not constants)."""
    jl = jax.jit(loop, static_argnames="n", donate_argnames="state")
    return lambda s, n: jl(cfg, grid, s, dt, n)


def flagship(nx, ny, nz, dtype, dt, compute_dtype=None):
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import baroclinic_instability_config, baroclinic_instability_state, loop

    grid = simple_latitude_longitude_grid(nx, ny, nz, dtype=dtype)
    cfg = baroclinic_instability_config()
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return grid, baroclinic_instability_state(grid), _loop_fn(loop, cfg, grid, dt)


def climate(nx, nz, dtype, dt, compute_dtype=None):
    """The reference's benchmark configuration: data-free climate ocean on
    the tripolar grid with gaussian islands, CATKE and coupled air-sea
    fluxes (/root/reference/src/data_free_ocean_climate_model.jl:12-70);
    grid size from ``nx`` via resolution 384 / nx."""
    from gb25_tpu.models.coupled import coupled_loop, data_free_ocean_climate_model

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=384.0 / nx, Nz=nz, dtype=dtype,
        grid_type="gaussian_islands_tripolar")
    if compute_dtype:
        ccfg = dataclasses.replace(
            ccfg, ocean=dataclasses.replace(ccfg.ocean, compute_dtype=compute_dtype))
    jl = jax.jit(coupled_loop, static_argnames="n", donate_argnames="state")
    return grid, state, lambda s, n: jl(ccfg, grid, atmos, s, dt, n)


def atmosphere(nx, ny, dtype, dt):
    """The rotating shallow-water companion (the reference's weak-scaling
    atmosphere is a SpeedyWeather shallow-water model, BASELINE.md)."""
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models.shallow_water import ShallowWaterConfig, shallow_water_state, sw_loop

    grid = simple_latitude_longitude_grid(nx, ny, 1, dtype=dtype)
    state = shallow_water_state(grid, h0=1000.0)
    # ridge perturbation -> geostrophic jet, so the advection terms carry
    # physically-scaled magnitudes during the timed loop
    phi = grid.phi_c_i.reshape(1, -1)
    state = state.replace(h=state.h + 2.0 * jnp.exp(-((phi - 40.0) ** 2) / 50.0))
    return grid, state, _loop_fn(sw_loop, ShallowWaterConfig(), grid, dt)


def sharded_1x1(build, dt):
    """The decomposed (comm != None) program on a 1x1 mesh with local
    boundary fills: the distributed step's compute overhead on one device.
    ``build(mesh)`` returns (sharded step fn, global state)."""
    from gb25_tpu.parallel import make_mesh, shard_state

    mesh = make_mesh(1, shape=(1, 1))
    fn, state = build(mesh)
    state = shard_state(state, mesh)
    return lambda s, n: fn(s, dt), state


def measure(tag, grid, state, lp, steps, extra):
    """Time one row; record ms/step and vs_baseline under ``tag``."""
    elapsed, state = time_loop(lp, state, steps)
    if not bool(jnp.isfinite(state.u if hasattr(state, "u") else state.h).all()):
        raise FloatingPointError(f"{tag}: non-finite state after the timed loop")
    cells = grid.Nx * grid.Ny * grid.Nz
    ms = 1e3 * elapsed / steps
    extra[f"{tag}_ms_per_step"] = ms
    extra[f"{tag}_vs_baseline"] = cells * steps / elapsed / REFERENCE_CELL_STEPS_PER_SEC
    extra[f"{tag}_grid"] = f"{grid.Nx}x{grid.Ny}x{grid.Nz}"
    return elapsed


def companion_rows(args, dtype, dt, headline_ms, extra):
    """Precision, decomposed-path, climate and atmosphere rows beside the
    flagship headline."""
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import baroclinic_instability_config, baroclinic_instability_state
    from gb25_tpu.models.config import SplitExplicitFreeSurface

    measure("bf16", *flagship(args.nx, args.ny, args.nz, dtype, dt, "bfloat16"),
            args.steps, extra)
    # two-limb emulated f64 at the full grid (double the buffers of f32)
    measure("f32x2", *flagship(args.nx, args.ny, args.nz, dtype, dt, "f32x2"),
            min(args.steps, 32), extra)

    grid = simple_latitude_longitude_grid(args.nx, args.ny, args.nz, dtype=dtype)
    cfg1 = dataclasses.replace(baroclinic_instability_config(),
                               free_surface=SplitExplicitFreeSurface(exchange_width=30))
    steps1 = min(args.steps, 64)

    def build_flagship(mesh):
        from gb25_tpu.parallel.sharded import sharded_step_fn

        return (sharded_step_fn(cfg1, grid, mesh, n_inner=steps1, force_comm="local"),
                baroclinic_instability_state(grid))

    lp, state = sharded_1x1(build_flagship, dt)
    measure("sharded1x1", grid, state, lp, steps1, extra)
    extra["sharded1x1_vs_serial"] = extra["sharded1x1_ms_per_step"] / headline_ms

    measure("climate", *climate(768, args.nz, dtype, dt), min(args.steps, 48), extra)
    steps_q = min(args.steps, 24)
    grid_q, state_q, lp_q = climate(1536, args.nz, dtype, dt)
    measure("climate_quarter_degree", grid_q, state_q, lp_q, steps_q, extra)
    del state_q, lp_q

    def build_climate(mesh):
        from gb25_tpu.models.coupled import data_free_ocean_climate_model
        from gb25_tpu.parallel.sharded import sharded_coupled_step_fn

        ccfg, g, atmos, state = data_free_ocean_climate_model(
            resolution=384.0 / 1536, Nz=args.nz, dtype=dtype,
            grid_type="gaussian_islands_tripolar")
        fs = ccfg.ocean.free_surface
        ccfg = dataclasses.replace(ccfg, ocean=dataclasses.replace(
            ccfg.ocean, free_surface=dataclasses.replace(fs, exchange_width=fs.substeps)))
        return (sharded_coupled_step_fn(ccfg, g, atmos, mesh, n_inner=steps_q,
                                        force_comm="local"), state)

    lp, state = sharded_1x1(build_climate, dt)
    measure("climate_quarter_sharded1x1", grid_q, state, lp, steps_q, extra)
    extra["climate_quarter_sharded1x1_vs_serial"] = (
        extra["climate_quarter_sharded1x1_ms_per_step"]
        / extra["climate_quarter_degree_ms_per_step"])
    # SYPD at the 1/4-degree reference time step (BASELINE.md: dt ~ 4 min)
    extra["climate_quarter_degree_sypd_at_dt4min"] = (
        240.0 / (extra["climate_quarter_degree_ms_per_step"] / 1e3)
        * 86400.0 / 31557600.0)

    measure("atmosphere", *atmosphere(args.nx, args.ny, dtype, dt), args.steps, extra)
    extra.pop("atmosphere_vs_baseline")  # the reference's tile is unpublished


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=1536)
    p.add_argument("--ny", type=int, default=768)
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--dt", type=float, default=60.0)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--compute-dtype", default=None,
                   help="precision-lowered tendency computation, e.g. bfloat16 "
                        "(MultiFloat analog; f32 state)")
    p.add_argument("--headline-only", action="store_true",
                   help="skip the companion rows (precision, decomposed, "
                        "climate, atmosphere)")
    p.add_argument("--config", default="baroclinic",
                   choices=["baroclinic", "climate", "atmosphere"],
                   help="the headline row: climate = the reference's actual "
                        "benchmark configuration; atmosphere = the rotating "
                        "shallow-water companion (2-D grid nx x ny)")
    args = p.parse_args()

    from gb25_tpu.utils.cache import enable_persistent_cache
    from gb25_tpu.utils.device import device_info, device_peaks, nvidia_smi_line
    from gb25_tpu.utils.env import preamble

    preamble()
    enable_persistent_cache()
    device = device_info()
    peaks = device_peaks(device["kind"])
    extra = {"device": device, "xla_flags": os.environ.get("XLA_FLAGS", "")}
    if device["platform"] == "gpu":
        extra["nvidia_smi"] = nvidia_smi_line()

    dtype = jnp.dtype(args.dtype)
    dt = jnp.asarray(args.dt, dtype)
    if args.config == "climate":
        grid, state, lp = climate(args.nx, args.nz, dtype, dt, args.compute_dtype)
        name = "data_free_climate_ocean"
    elif args.config == "atmosphere":
        grid, state, lp = atmosphere(args.nx, args.ny, dtype, dt)
        name = "shallow_water_atmosphere"
    else:
        grid, state, lp = flagship(args.nx, args.ny, args.nz, dtype, dt, args.compute_dtype)
        name = "baroclinic_instability"
    # the resolution->points roundtrip of the climate grid can change both
    # extents: report the built grid's
    args.nx, args.ny, args.nz = grid.Nx, grid.Ny, grid.Nz

    # bytes one step moves, from XLA's cost model of the one-step program
    # (HloCostAnalysis counts a while body once, whatever its trip count)
    ca = jax.jit(lambda s: lp(s, 1)).lower(state).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    bytes_per_step = float(ca["bytes accessed"])

    elapsed, state = time_loop(lp, state, args.steps)
    field = state.h if args.config == "atmosphere" else state.u
    if not bool(jnp.isfinite(field).all()):
        raise FloatingPointError("benchmark produced non-finite state")
    del state

    cells = args.nx * args.ny * args.nz
    ms_per_step = 1e3 * elapsed / args.steps
    cell_steps_per_sec = cells * args.steps / elapsed
    hbm_bytes_per_s = bytes_per_step * args.steps / elapsed
    extra.update({
        "ms_per_step": ms_per_step,
        "hbm_gbs_xla_ledger": hbm_bytes_per_s / 1e9,
        "hbm_pct_peak": (100.0 * hbm_bytes_per_s / peaks["hbm_bytes_per_s"]
                         if peaks else None),
        "steps": args.steps,
        "config": args.config,
    })
    if args.config == "atmosphere":
        # the reference's spectral model's per-GPU tile is unpublished, so a
        # cell-normalized vs_baseline is not defined; its wall number instead
        extra["ref_seconds_per_256_steps_alps"] = 152.2

    if not args.headline_only and args.compute_dtype is None and args.config == "baroclinic":
        companion_rows(args, dtype, dt, ms_per_step, extra)

    print(json.dumps({
        "metric": f"{name} cell-steps/s/device ({args.nx}x{args.ny}x{args.nz}, "
                  f"{args.steps} steps, {args.dtype}, ms/step={ms_per_step:.2f})",
        "value": cell_steps_per_sec,
        "unit": "cell-steps/s",
        "vs_baseline": (None if args.config == "atmosphere"
                        else cell_steps_per_sec / REFERENCE_CELL_STEPS_PER_SEC),
        **extra,
    }))


if __name__ == "__main__":
    main()
