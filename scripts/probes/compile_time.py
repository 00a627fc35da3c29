"""Cold vs warm-cache compile-time table.

The reference ships an entire ext/ layer of 11 PrecompileTools packages
because trace+compile dominates its startup (/root/reference/ext/, SURVEY
section 7 hard part (e)); our equivalent is the persistent XLA compilation
cache + AOT warmer (utils/cache.py).  This probe MEASURES that equivalence:
for each benchmark program it times lower+compile twice against the same
cache directory — the first pass (cold: fresh directory) pays trace + XLA +
Triton kernel compiles; the second (warm) should hit the on-disk cache.

Each timing runs in a SUBPROCESS so no in-process jit/executable cache can
leak between passes.  Writes the table to --out.

Usage:  python scripts/probes/compile_time.py [--out compile_time.md]
        python scripts/probes/compile_time.py --one flagship --cache DIR
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

PROGRAMS = {
    # flagship serial loop (the bench.py headline program)
    "flagship": dict(nx=1536, ny=768, nz=64, config="baroclinic", n=16),
    # quarter-degree coupled climate loop (the north-star workload)
    "climate_quarter": dict(nx=1536, nz=64, config="climate", n=16),
    # decomposed (forced-comm) flagship program — the distributed build
    "flagship_sharded": dict(nx=1536, ny=768, nz=64, config="sharded", n=16),
}


def measure_one(name, cache_dir):
    """Time trace+lower+compile of one program against cache_dir."""
    import jax
    import jax.numpy as jnp

    from gb25_tpu.utils.cache import enable_persistent_cache
    from gb25_tpu.utils.env import preamble

    preamble()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    enable_persistent_cache()
    spec = PROGRAMS[name]
    t0 = time.perf_counter()
    if spec["config"] == "climate":
        from gb25_tpu.models.coupled import coupled_loop, data_free_ocean_climate_model

        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=384.0 / spec["nx"], Nz=spec["nz"],
            dtype=jnp.float32, grid_type="gaussian_islands_tripolar")
        build_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        jax.jit(coupled_loop, static_argnames="n").lower(
            ccfg, grid, atmos, state, jnp.float32(60.0), spec["n"]).compile()
    else:
        from gb25_tpu.grids import simple_latitude_longitude_grid
        from gb25_tpu.models import (
            baroclinic_instability_config,
            baroclinic_instability_state,
            loop,
        )

        grid = simple_latitude_longitude_grid(spec["nx"], spec["ny"],
                                              spec["nz"], dtype=jnp.float32)
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(grid)
        build_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        if spec["config"] == "sharded":
            import dataclasses

            from gb25_tpu.models.config import SplitExplicitFreeSurface
            from gb25_tpu.parallel import make_mesh, shard_state
            from gb25_tpu.parallel.sharded import sharded_step_fn

            cfg = dataclasses.replace(
                cfg, free_surface=SplitExplicitFreeSurface(exchange_width=30))
            mesh = make_mesh(1, shape=(1, 1))
            fn = sharded_step_fn(cfg, grid, mesh, n_inner=spec["n"],
                                 force_comm="local")
            fn.lower(shard_state(state, mesh), jnp.float32(60.0)).compile()
        else:
            jax.jit(loop, static_argnames="n").lower(
                cfg, grid, state, jnp.float32(60.0), spec["n"]).compile()
    return {"program": name, "build_s": round(build_s, 2),
            "compile_s": round(time.perf_counter() - t1, 2)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--one", default=None, help="(internal) measure one program")
    p.add_argument("--cache", default=None)
    p.add_argument("--programs", default="flagship,climate_quarter,flagship_sharded")
    p.add_argument("--out", default="compile_time.md")
    args = p.parse_args()

    if args.one:
        print("RESULT " + json.dumps(measure_one(args.one, args.cache)))
        return

    rows = []
    for name in args.programs.split(","):
        cache = tempfile.mkdtemp(prefix=f"gb25_cc_{name}_")
        row = {"program": name, "cache_dir": cache}
        for phase in ("cold", "warm"):
            r = subprocess.run(
                [sys.executable, __file__, "--one", name, "--cache", cache],
                capture_output=True, text=True, timeout=7200)
            lines = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")]
            if r.returncode != 0 or not lines:
                row[phase + "_error"] = (r.stderr or r.stdout).strip()[-400:]
                break
            d = json.loads(lines[-1][len("RESULT "):])
            row[f"{phase}_compile_s"] = d["compile_s"]
            row[f"{phase}_build_s"] = d["build_s"]
        if "cold_compile_s" in row and "warm_compile_s" in row:
            row["speedup"] = round(row["cold_compile_s"]
                                   / max(row["warm_compile_s"], 1e-9), 1)
        rows.append(row)
        print(json.dumps(row), flush=True)

    backend = "unknown"
    try:
        import jax

        backend = jax.devices()[0].device_kind
    except Exception:
        pass
    lines = [
        "# Compile time: cold vs warm persistent cache",
        "",
        f"Measured on `{backend}` via `scripts/probes/compile_time.py` — each",
        "cell is wall seconds of `lower(...).compile()` in a fresh process",
        "(trace included in build_s; cold = empty `JAX_COMPILATION_CACHE_DIR`,",
        "warm = second process against the same dir).  This is the",
        "reference's ext/ precompile-layer concern, measured for this",
        "translation (utils/cache.py): the persistent XLA cache is the",
        "startup-cost answer.",
        "",
        "| program | cold compile s | warm compile s | speedup | model build s |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['program']} | {r.get('cold_compile_s', 'ERR')} | "
            f"{r.get('warm_compile_s', 'ERR')} | {r.get('speedup', '-')}x | "
            f"{r.get('cold_build_s', '-')} |")
    lines += ["", "Programs: flagship = serial 16-step loop at 1536x768x64;",
              "climate_quarter = coupled tripolar+islands+CATKE 16-step loop",
              "at 1/4 degree; flagship_sharded = the decomposed (forced-comm",
              "1x1, exchange_width=30) distributed build of the flagship.", ""]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
