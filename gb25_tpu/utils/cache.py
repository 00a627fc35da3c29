"""Compile-time management (the reference's ext/ precompile layer).

Reference behavior: GB-25 ships 11 PrecompileTools packages that each
@compile one stage of the time step on a tiny model to warm Julia's cache in
parallel (SURVEY.md section 2a 'Precompile packages'), because trace+compile
is the dominant startup cost. The JAX-native equivalent is (a) the persistent
XLA compilation cache and (b) an AOT warm pass that compiles the step/loop
programs for the shapes a run will use (scripts/warm_cache.py).
"""

from __future__ import annotations

import os

import jax


# The cache key includes the directory, so the default is one fixed path
# inside the checkout (listed in .gitignore), never under $HOME.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``DEFAULT_CACHE_DIR``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_cache(min_compile_time_secs: float = 1.0):
    """Turn on the on-disk XLA compilation cache at ``cache_dir()``
    (reference analog: the whole ext/Precompile* layer + Reactant's
    serialized executables). Returns the directory."""
    directory = cache_dir()
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return directory


def try_compile(jitted, *args, dump_dir="compile_failure", label="program"):
    """Compile with failure-artifact capture (reference: try_compile_code,
    timestepping_utils.jl:8-19 — compile crashes become inspectable IR dumps
    plus a deferred failure instead of an opaque abort)."""
    import os
    import traceback

    lowered = jitted.lower(*args)
    try:
        return lowered.compile()
    except Exception:
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(dump_dir, f"{label}.stablehlo.mlir")
        with open(path, "w") as f:
            f.write(lowered.as_text())
        with open(os.path.join(dump_dir, f"{label}.traceback.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise RuntimeError(
            f"compile of {label} failed; lowered IR dumped to {path}"
        )


def warm(cfg, grid, state, dt, steps=(1, 16), mesh=None):
    """AOT-compile the step programs so later runs hit the persistent cache.

    Returns the compiled executables (also usable directly, like the
    reference's compiled first/loop functions)."""
    import jax.numpy as jnp

    from gb25_tpu.models.hydrostatic import loop, time_step

    dt = jnp.asarray(dt, state.u.dtype)
    compiled = {}
    if mesh is None:
        compiled["first"] = jax.jit(time_step).lower(cfg, grid, state, dt).compile()
        for n in steps:
            if n > 1:
                compiled[f"loop{n}"] = (
                    jax.jit(loop, static_argnames="n")
                    .lower(cfg, grid, state, dt, n)
                    .compile()
                )
    else:
        from gb25_tpu.parallel import shard_state, sharded_step_fn

        st = shard_state(state, mesh)
        compiled["first"] = sharded_step_fn(cfg, grid, mesh).lower(st, dt).compile()
        for n in steps:
            if n > 1:
                compiled[f"loop{n}"] = (
                    sharded_step_fn(cfg, grid, mesh, n_inner=n).lower(st, dt).compile()
                )
    return compiled
