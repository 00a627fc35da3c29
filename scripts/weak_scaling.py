#!/usr/bin/env python
"""Weak-scaling sweep + analysis (reference: sharding/*_scaling_test.jl +
analysis/weak-scaling/*.jl — fixed per-device tile, growing device count,
'grid points per second per device' normalized efficiency plot/table).

On a multi-GPU host this runs over the host's cards; on a dev box it sweeps
virtual CPU device counts to validate the scaling path. The projection to
larger device counts needs the halo link's measured rate and latency
(--link-bytes-per-sec, --link-latency-s, --link-uncertainty)."""

import sys, os, time, json, argparse

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_once(n, tile, Nz, steps, dtype_name, overlap=True):
    # tile: int (square) or (tx, ty) per-device extents
    import dataclasses

    import jax
    import jax.numpy as jnp
    from gb25_tpu.analysis.comm import collective_permute_stats
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import baroclinic_instability_state, baroclinic_instability_config
    from gb25_tpu.parallel import factors, make_mesh, shard_state, sharded_step_fn

    dtype = jnp.dtype(dtype_name)
    rx, ry = factors(n)
    tx, ty = tile if isinstance(tile, tuple) else (tile, tile)
    Nx, Ny = tx * rx, ty * ry
    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, dtype=dtype)
    cfg = dataclasses.replace(baroclinic_instability_config(), overlap_split=overlap)
    mesh = make_mesh(n, shape=(rx, ry))
    state = shard_state(baroclinic_instability_state(grid), mesh)
    fn = sharded_step_fn(cfg, grid, mesh, n_inner=steps)
    dt = jnp.asarray(1.0, dtype)

    # static comm accounting from the compiled program:
    # per-step collective-permute count + bytes per device; reuse this ONE
    # compiled executable for the run too (calling the jitted fn would
    # compile the identical program a second time — the AOT path does not
    # populate the jit dispatch cache, and compiles dominate a CPU sweep)
    compiled = fn.lower(state, dt).compile()
    comm = collective_permute_stats(compiled.as_text())

    s = compiled(state, dt)  # warm (lazy one-time init)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    s = compiled(s, dt)
    jax.block_until_ready(s)
    el = time.perf_counter() - t0
    return {
        "devices": n, "mesh": [rx, ry], "global": [Nx, Ny, Nz],
        "seconds": el, "ms_per_step": 1e3 * el / steps,
        "cell_steps_per_sec_per_device": Nx * Ny * Nz * steps / el / n,
        "overlap_split": overlap,
        "permutes_per_step": comm.permute_count,
        "comm_bytes_per_step_per_device": comm.bytes_per_step,
    }


def flagship_comm_stats(tile, Nz, dtype_name):
    """Exact per-device collective-permute bytes of the sharded flagship
    program at the given per-device tile: lower + compile on a 2x2 mesh
    (no execution) and read the steady-state while body (analysis/comm.py)."""
    import dataclasses

    import jax.numpy as jnp

    from gb25_tpu.analysis.comm import collective_permute_stats
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import baroclinic_instability_config, baroclinic_instability_state
    from gb25_tpu.models.config import SplitExplicitFreeSurface
    from gb25_tpu.parallel import make_mesh, shard_state, sharded_step_fn

    tx, ty = tile
    grid = simple_latitude_longitude_grid(2 * tx, 2 * ty, Nz,
                                          dtype=jnp.dtype(dtype_name))
    cfg = dataclasses.replace(
        baroclinic_instability_config(), overlap_split=False,
        free_surface=SplitExplicitFreeSurface(exchange_width=30))
    mesh = make_mesh(4, shape=(2, 2))
    fn = sharded_step_fn(cfg, grid, mesh, n_inner=4)
    compiled = fn.lower(
        shard_state(baroclinic_instability_state(grid), mesh),
        jnp.asarray(1.0, grid.dtype)).compile()
    return collective_permute_stats(compiled.as_text())


def climate_comm_stats(nx, nz):
    """Exact per-device collective-permute bytes of the sharded 1/4-degree
    coupled climate program: lower + compile (CPU backend, no execution) the
    full decomposed program on a 2x2 mesh and read the steady-state while
    body's permutes (analysis/comm.py).  The tile this yields (nx/2 x nx/4)
    is the fixed per-device tile of the projection."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from gb25_tpu.analysis.comm import collective_permute_stats
    from gb25_tpu.models.coupled import data_free_ocean_climate_model
    from gb25_tpu.parallel import make_mesh, shard_state
    from gb25_tpu.parallel.sharded import sharded_coupled_step_fn

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=384.0 / nx, Nz=nz, dtype=jnp.float32,
        grid_type="gaussian_islands_tripolar")
    # production decomposed setting: one wide exchange block for the whole
    # barotropic solve (matches the measured compute term's configuration)
    ocfg = dataclasses.replace(
        ccfg.ocean, free_surface=dataclasses.replace(
            ccfg.ocean.free_surface,
            exchange_width=ccfg.ocean.free_surface.substeps))
    ccfg = dataclasses.replace(ccfg, ocean=ocfg)
    mesh = make_mesh(4, shape=(2, 2))
    fn = sharded_coupled_step_fn(ccfg, grid, atmos, mesh, n_inner=4)
    compiled = fn.lower(shard_state(state, mesh),
                        jnp.float32(60.0)).compile()
    return collective_permute_stats(compiled.as_text())


def main():
    from gb25_tpu.utils.env import preamble

    preamble()
    p = argparse.ArgumentParser()
    p.add_argument("--tile", default="64",
                   help="per-device tile: N or NXxNY (e.g. 768x384 = the "
                        "flagship per-device tile on a 2x2 slice)")
    p.add_argument("--Nz", type=int, default=8)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--counts", default="1,2,4,8")
    p.add_argument("--virtual-cpu", action="store_true",
                   help="force N virtual CPU devices (dev-box validation)")
    p.add_argument("--ablate-overlap", action="store_true",
                   help="also run with overlap_split=False (reference analog: "
                        "the optimize_communications ablation, sharded_..._run.jl:109-112)")
    p.add_argument("--project-chips", default="8,16,32,64,128,256",
                   help="device counts for the weak-scaling projection")
    p.add_argument("--link-bytes-per-sec", type=float, required=True,
                   help="measured per-device halo-exchange link rate")
    p.add_argument("--link-latency-s", type=float, required=True,
                   help="measured latency of one collective-permute round")
    p.add_argument("--link-uncertainty", type=float, default=1.0,
                   help="factor applied to the whole comm term for the "
                        "pessimistic end of each range")
    p.add_argument("--compute-ms", type=float, default=None,
                   help="measured single-device ms/step for the "
                        "projection's compute term (from bench.py on the "
                        "GPU).  Without it the projection falls back to "
                        "this sweep's own ms/step — meaningless on virtual "
                        "CPU devices.")
    p.add_argument("--climate-compute-ms", type=float, default=None,
                   help="measured decomposed-path ms/step of the 1/4-degree "
                        "coupled climate configuration (bench.py "
                        "climate_quarter_sharded1x1 row); adds a climate "
                        "projection whose comm term is the EXACT compiled "
                        "byte count of the sharded coupled program at "
                        "1536x768 on a 2x2 mesh")
    p.add_argument("--climate-nx", type=int, default=1536)
    p.add_argument("--climate-nz", type=int, default=64)
    p.add_argument("--stats-tile", default=None,
                   help="per-device tile NXxNY for a COMPILE-ONLY comm-stats "
                        "build feeding the projection (decouples the "
                        "projection's byte accounting from the timed sweep's "
                        "tile, which must stay small on virtual-CPU devices)")
    p.add_argument("--stats-nz", type=int, default=64,
                   help="Nz of the compile-only stats build (the PRODUCTION "
                        "depth — exchanged 3-D strip bytes scale with it)")
    args = p.parse_args()
    if args.stats_tile:
        args.stats_tile = tuple(int(v) for v in args.stats_tile.split("x"))
    counts = [int(c) for c in args.counts.split(",")]
    tile = (tuple(int(v) for v in args.tile.split("x"))
            if "x" in args.tile else int(args.tile))
    args.tile = tile

    if args.virtual_cpu:
        from gb25_tpu.utils.profiling import force_virtual_cpu_devices

        force_virtual_cpu_devices(max(counts))

    results = [run_once(n, args.tile, args.Nz, args.steps, args.dtype) for n in counts]
    if args.ablate_overlap:
        results += [run_once(n, args.tile, args.Nz, args.steps, args.dtype,
                             overlap=False) for n in counts]
    base = results[0]["cell_steps_per_sec_per_device"]
    print(f"{'devs':>5} {'mesh':>8} {'global':>18} {'s/loop':>8} {'ms/step':>8} "
          f"{'eff':>6} {'ovl':>4} {'perm/st':>8} {'KB/st/dev':>10}")
    for r in results:
        eff = r["cell_steps_per_sec_per_device"] / base
        r["efficiency"] = eff
        print(f"{r['devices']:>5} {str(r['mesh']):>8} {str(r['global']):>18} "
              f"{r['seconds']:>8.2f} {r['ms_per_step']:>8.2f} {eff:>6.3f} "
              f"{str(r['overlap_split'])[0]:>4} {r['permutes_per_step']:>8} "
              f"{r['comm_bytes_per_step_per_device'] / 1e3:>10.1f}")

    # projection to larger device counts (fixed tile => constant
    # bytes/step/device).
    # The projection's comm stats come from a COMPILE-ONLY build at the
    # production per-device tile (--stats-tile) on a 2x2 mesh — the timed
    # sweep can then use small tiles (big tiles trip the virtual-CPU
    # collective rendezvous timeout when all devices share one host's
    # cores) without degrading the projection's byte accounting.
    from gb25_tpu.analysis.comm import CommStats, project_weak_scaling

    if args.stats_tile:
        stats = flagship_comm_stats(args.stats_tile, args.stats_nz, args.dtype)
        print(f"projection comm stats from compile-only build at tile "
              f"{args.stats_tile[0]}x{args.stats_tile[1]}x{args.stats_nz}: "
              f"{stats.permute_count} permutes, "
              f"{stats.bytes_per_step/1e6:.2f} MB/step/dev")
    else:
        last = results[len(counts) - 1]
        stats = CommStats(
            permute_count=last["permutes_per_step"],
            bytes_per_step=int(last["comm_bytes_per_step_per_device"]),
            trip_count=None, per_op=[])
    chips = [int(c) for c in args.project_chips.split(",")]
    projection = {}
    compute_ms = args.compute_ms if args.compute_ms else last["ms_per_step"]
    compute_src = ("measured kernel-path (--compute-ms)" if args.compute_ms
                   else "this sweep (virtual-CPU noise; pass --compute-ms)")
    link = dict(link_bytes_per_sec=args.link_bytes_per_sec,
                latency_per_round=args.link_latency_s,
                bw_uncertainty=args.link_uncertainty)
    print(f"\nweak-scaling projection (per-device tile fixed; "
          f"compute term {compute_ms:.2f} ms from {compute_src}; "
          f"eff ranges span the x{args.link_uncertainty} link uncertainty):")
    print(f"{'chips':>6} {'overlap eff':>12} {'ablated eff':>12} "
          f"{'ablated eff range':>20} {'comm ms range':>20}")
    for ovl in (True, False):
        projection["overlap" if ovl else "ablated"] = project_weak_scaling(
            compute_ms, stats, chip_counts=chips, overlap=ovl, **link)
    for n in chips:
        po = projection["overlap"][n]
        pa = projection["ablated"][n]
        er = pa["efficiency_range"]
        cr = pa["comm_ms_range"]
        print(f"{n:>6} {po['efficiency']:>12.3f} {pa['efficiency']:>12.3f} "
              f"{f'[{er[0]:.3f}, {er[1]:.3f}]':>20} "
              f"{f'[{cr[0]:.3f}, {cr[1]:.3f}]':>20}")

    # climate projection (the north-star workload): comm term from the
    # compiled sharded coupled program's exact collective-permute bytes
    climate_projection = None
    if args.climate_compute_ms:
        climate_stats = climate_comm_stats(args.climate_nx, args.climate_nz)
        climate_projection = {}
        for ovl in (True, False):
            climate_projection["overlap" if ovl else "ablated"] = \
                project_weak_scaling(args.climate_compute_ms, climate_stats,
                                     chip_counts=chips, overlap=ovl, **link)
        pa = climate_projection["ablated"][chips[0]]
        print(f"\nclimate 1/4-deg projection: compute "
              f"{args.climate_compute_ms:.2f} ms (measured decomposed path), "
              f"comm {pa['comm_ms']:.3f} ms "
              f"[{pa['comm_ms_range'][0]:.3f}, {pa['comm_ms_range'][1]:.3f}], "
              f"ablated eff {pa['efficiency']:.3f} "
              f"[{pa['efficiency_range'][0]:.3f}, "
              f"{pa['efficiency_range'][1]:.3f}] "
              f"({climate_stats.permute_count} permutes, "
              f"{climate_stats.bytes_per_step/1e6:.2f} MB/step/dev)")

    out = {"runs": results, "projection": projection,
           "projection_compute_ms": compute_ms,
           "projection_compute_source": compute_src,
           "projection_stats_tile": (list(args.stats_tile)
                                     if args.stats_tile else None),
           "projection_comm_stats": {"permutes_per_step": stats.permute_count,
                                     "bytes_per_step_per_device": stats.bytes_per_step},
           "climate_projection": climate_projection,
           "climate_projection_compute_ms": args.climate_compute_ms,
           "link": link,
           "virtual_cpu_timing_is_nonsignal": args.virtual_cpu,
           "note": ("virtual-CPU sweep rows validate the comm pattern "
                    "(permutes/bytes per step) only: all N virtual devices "
                    "share one host's cores, so per-device throughput "
                    "inherently divides by N — use the projection table, "
                    "whose compute term is the GPU measurement"
                    if args.virtual_cpu else "real-device sweep")}
    with open("weak_scaling_results.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote weak_scaling_results.json")


if __name__ == "__main__":
    main()
