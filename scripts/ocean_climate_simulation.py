#!/usr/bin/env python
"""The full ocean-climate simulation (reference:
simulations/ocean_climate_simulation.jl — tripolar 360/res x 170/res x Nz
grid, regridded bathymetry, T/S restoring to a monthly climatology under a
polar taper at rate 1/(7 days), initialization from the climatology state,
prescribed atmosphere, Simulation(dt=20 min, stop_time), progress callback
every 10 iterations, surface-slice output writer every 3 days).

Dataset files are optional: absent, the synthetic stand-ins from
gb25_tpu.data keep the full pipeline runnable without downloads (the
reference's data-free model serves the same purpose, SURVEY.md section 4.7).
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse
import logging

import jax
import jax.numpy as jnp

from gb25_tpu.data import climatology_restoring, initial_state_from_climatology, regrid_bathymetry
from gb25_tpu.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu.grids.immersed import gaussian_islands_bottom
from gb25_tpu.io import NPZOutputWriter
from gb25_tpu.models import SplitExplicitFreeSurface, baroclinic_instability_config
from gb25_tpu.models.atmosphere import data_free_atmosphere
from gb25_tpu.models.catke import CATKEVerticalDiffusivity
from gb25_tpu.models.coupled import CoupledConfig, coupled_time_step
from gb25_tpu.simulation import IterationInterval, Simulation, progress_callback


def main():
    from gb25_tpu.utils.env import preamble

    preamble()
    p = argparse.ArgumentParser()
    p.add_argument("--resolution", type=float, default=2.0)
    p.add_argument("--Nz", type=int, default=20)
    p.add_argument("--dt", type=float, default=1200.0, help="20 min at 2 deg (reference :50-53)")
    p.add_argument("--stop-days", type=float, default=1.0)
    p.add_argument("--grid", default="latlon", choices=["latlon", "tripolar"])
    p.add_argument("--bathymetry", default=None, help="bathymetry.npz (ETOPO analog)")
    p.add_argument("--climatology", default=None, help="climatology.npz (ECCO analog)")
    p.add_argument("--atmosphere", default=None, help="atmosphere.npz (JRA55 analog)")
    p.add_argument("--no-pre-regrid", action="store_true",
                   help="keep atmosphere records on their native grid and "
                        "gather per step (for records too large to "
                        "materialize at ocean resolution, e.g. a year of "
                        "3-hourly JRA55-do at the flagship grid)")
    p.add_argument("--sea-ice", default="freezing_limited",
                   choices=["freezing_limited", "slab"],
                   help="freezing_limited = the reference's implicit default; "
                        "slab = prognostic zero-layer thermodynamic ice with "
                        "free-drift advection (models/seaice.py)")
    p.add_argument("--output-dir", default="climate_output")
    p.add_argument("--output-format", default="npz", choices=["npz", "netcdf"],
                   help="netcdf = one CF-readable classic .nc file with an "
                        "unlimited time axis (io/output.py::NetCDFOutputWriter)")
    p.add_argument("--float-type", default="f32")
    args = p.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    dtype = {"f32": jnp.float32, "f64": jnp.float64}[args.float_type]
    Nx, Ny = int(360 / args.resolution), int(170 / args.resolution)

    if args.grid == "tripolar":
        grid = tripolar_grid(Nx, Ny, args.Nz, dtype=dtype)
    else:
        grid = simple_latitude_longitude_grid(Nx, Ny, args.Nz, dtype=dtype)
    if args.bathymetry:
        grid = regrid_bathymetry(grid, args.bathymetry)
    else:
        grid = gaussian_islands_bottom(grid)

    ocean_cfg = baroclinic_instability_config(
        free_surface=SplitExplicitFreeSurface(substeps=30),
        closure=CATKEVerticalDiffusivity(),
    )
    if args.sea_ice == "slab":
        from gb25_tpu.models.seaice import SlabSeaIce, initial_ice_state

        ccfg = CoupledConfig(ocean=ocean_cfg, sea_ice=SlabSeaIce())
        ice_holder = {"ice": initial_ice_state(grid, dtype)}
    else:
        ccfg = CoupledConfig(ocean=ocean_cfg)
        ice_holder = None
    state = initial_state_from_climatology(grid, ocean_cfg, path=args.climatology)
    restoring = climatology_restoring(grid, path=args.climatology)

    if args.atmosphere:
        from gb25_tpu.data import file_prescribed_atmosphere

        atmos = file_prescribed_atmosphere(grid, args.atmosphere,
                                           pre_regrid=not args.no_pre_regrid)
    else:
        atmos = data_free_atmosphere(grid, dtype=dtype)

    from gb25_tpu.models.coupled import compute_interface_fluxes
    from gb25_tpu.models.hydrostatic import time_step
    from gb25_tpu.models.seaice import limit_ocean_temperature

    # atmos/restoring ride as jit ARGUMENTS: closing over them would bake
    # the (possibly pre-regridded, ocean-sized) records into the IR as
    # constants — hundreds of MB at the flagship grid
    def climate_loop(ccfg_, grid_, atmos_, restoring_, s, dt, n):
        from gb25_tpu.models.hydrostatic import premask_state

        s = premask_state(grid_, s)

        def step1(ss):
            fluxes, _diag = compute_interface_fluxes(ccfg_, grid_, atmos_, ss)
            ss = time_step(ccfg_.ocean, grid_, ss, dt, surface_fluxes=fluxes,
                           restoring=restoring_, premasked=True)
            # freezing limiter on the PROGNOSTIC temperature, exactly as
            # coupled_time_step does (ClimaOcean:
            # above_freezing_ocean_temperature!) — restoring/cooling must
            # not leave polar water supercooled
            return limit_ocean_temperature(ccfg_.sea_ice, ss)

        return jax.lax.fori_loop(0, n, lambda _, ss: step1(ss), s)

    if ice_holder is not None:
        from gb25_tpu.models.coupled import coupled_ice_loop

        def ice_loop(ccfg_, grid_, atmos_, restoring_, s, ice, dt, n):
            return coupled_ice_loop(ccfg_, grid_, atmos_, s, ice, dt, n,
                                    restoring=restoring_)

        _jloop_ice = jax.jit(ice_loop, static_argnames="n")

        def step_fn(cfg_unused, grid_, s, dt, n):
            # the ice state rides outside Simulation's ocean-state plumbing:
            # step_fn is called sequentially, so a held reference is exact
            s, ice_holder["ice"] = _jloop_ice(
                ccfg, grid_, atmos, restoring, s, ice_holder["ice"], dt, n)
            return s
    else:
        _jloop = jax.jit(climate_loop, static_argnames="n")

        def step_fn(cfg_unused, grid_, s, dt, n):
            return _jloop(ccfg, grid_, atmos, restoring, s, dt, n)

    sim = Simulation(
        ocean_cfg, grid, state, dt=args.dt,
        stop_time=args.stop_days * 86400.0, inner_steps=10,
        step_fn=step_fn,
    )
    sim.add_callback(progress_callback, IterationInterval(10))
    if args.output_format == "netcdf":
        from gb25_tpu.io.output import NetCDFOutputWriter

        writer = NetCDFOutputWriter(
            os.path.join(args.output_dir, "surface.nc"), grid,
            interval_seconds=3 * 86400.0,
        )
    else:
        writer = NPZOutputWriter(args.output_dir, interval_seconds=3 * 86400.0)
    sim.add_output_writer(writer)
    sim.run()
    if args.output_format == "netcdf":
        writer.close()
    if ice_holder is not None:
        import numpy as np

        vi = np.asarray(ice_holder["ice"].v)
        ai = np.asarray(ice_holder["ice"].a)
        print(f"sea ice: max volume {vi.max():.3f} m, "
              f"cover(a>0.15) {100.0 * float((ai > 0.15).mean()):.1f}% of cells")
    print(f"done: iteration={sim.iteration} t={sim.time / 86400:.2f} days "
          f"wall={sim.run_wall_time:.1f}s")


if __name__ == "__main__":
    main()
