"""CLI argument parsing and precision configuration.

Reference behavior reimplemented: ``src/arg_parsing.jl`` — --grid-x/-y/-z
(--Nx aliases), --float-type f64/f32/f16/bf16, --target-float-type (precision
lowering), --resolution; mapped here onto JAX dtypes. The reference's
``MultiFloatOptions`` multi-limb lowering maps to our precision policy:
compute dtype (storage) + optional lowered target dtype for experiments.
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp

_FLOAT_TYPES = {
    "f64": jnp.float64,
    "f32": jnp.float32,
    "f16": jnp.float16,
    "bf16": jnp.bfloat16,
}
_TARGET_TYPES = dict(_FLOAT_TYPES)
_TARGET_TYPES.update({
    "f8E5M2": jnp.float8_e5m2,
    "f8E4M3": jnp.float8_e4m3,
})


def float_type(name: str):
    """Reference: float_type_from_args (arg_parsing.jl).

    Requesting f64 also flips ``jax_enable_x64`` — without it JAX silently
    downcasts every array to f32, which in round 1 masqueraded as
    "fusion-order differences" and forced loosened correctness tolerances."""
    if name == "f64":
        import jax

        jax.config.update("jax_enable_x64", True)
    try:
        return _FLOAT_TYPES[name]
    except KeyError:
        raise SystemExit(f"unknown float type {name!r}; choose from {list(_FLOAT_TYPES)}")


def target_float_type(name: str):
    try:
        return _TARGET_TYPES[name]
    except KeyError:
        raise SystemExit(f"unknown target float type {name!r}")


def benchmark_parser(description="gb25_tpu simulation") -> argparse.ArgumentParser:
    """Reference: parse_baroclinic_instability_args (arg_parsing.jl:9-46)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--grid-x", "--Nx", dest="Nx", type=int, default=None,
                   help="global grid points in x")
    p.add_argument("--grid-y", "--Ny", dest="Ny", type=int, default=None)
    p.add_argument("--grid-z", "--Nz", dest="Nz", type=int, default=20)
    p.add_argument("--resolution", type=float, default=None,
                   help="degrees; Nx=384/res, Ny=192/res (reference policy)")
    p.add_argument("--float-type", default="f32", choices=list(_FLOAT_TYPES))
    p.add_argument("--target-float-type", default=None,
                   help="optional lowered compute dtype (bf16/f8 experiments)")
    p.add_argument("--limbs", type=int, default=1, choices=[1, 2],
                   help="multi-limb emulated compute precision (reference "
                        "MultiFloatOptions, arg_parsing.jl:99-107): limbs=2 "
                        "with --target-float-type f32 runs tendencies in "
                        "double-single (emulated ~f64); with bf16, paired-bf16")
    p.add_argument("--dt", type=float, default=60.0)
    p.add_argument("--steps", type=int, default=256,
                   help="steps per compiled loop (reference benchmarks use 256)")
    p.add_argument("--free-surface", default="split_explicit",
                   choices=["split_explicit", "explicit"])
    p.add_argument("--substeps", type=int, default=30)
    p.add_argument("--closure", default="none",
                   choices=["none", "vertical_scalar", "catke"])
    p.add_argument("--profile-dir", default=None,
                   help="write an XSpace profiler trace to this directory")
    p.add_argument("--output-dir", default=None)
    return p


def resolve_grid_size(args):
    from gb25_tpu.grids import resolution_to_points

    if args.Nx is None or args.Ny is None:
        res = args.resolution or 2.0
        nx, ny = resolution_to_points(res)
        return (args.Nx or nx, args.Ny or ny, args.Nz)
    return (args.Nx, args.Ny, args.Nz)


def build_config(args):
    from gb25_tpu.models import (
        ExplicitFreeSurface,
        SplitExplicitFreeSurface,
        VerticalScalarDiffusivity,
        baroclinic_instability_config,
    )

    fs = (
        SplitExplicitFreeSurface(substeps=args.substeps)
        if args.free_surface == "split_explicit"
        else ExplicitFreeSurface()
    )
    closure = None
    if args.closure == "vertical_scalar":
        closure = VerticalScalarDiffusivity(nu=1e-4, kappa=1e-5)
    elif args.closure == "catke":
        from gb25_tpu.models.catke import CATKEVerticalDiffusivity

        closure = CATKEVerticalDiffusivity()
    compute_dtype = None
    target = getattr(args, "target_float_type", None)
    limbs = getattr(args, "limbs", 1)
    if limbs == 2:
        base = target or "f32"
        if base not in ("f32", "bf16"):
            raise SystemExit("--limbs 2 supports --target-float-type f32/bf16")
        compute_dtype = {"f32": "f32x2", "bf16": "bf16x2"}[base]
    elif target is not None:
        compute_dtype = str(jnp.dtype(target_float_type(target)))
    import dataclasses

    cfg = baroclinic_instability_config(free_surface=fs, closure=closure)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return cfg
