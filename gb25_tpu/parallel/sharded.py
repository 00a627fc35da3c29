"""Sharded model execution: the whole time step under ``shard_map``.

Reference analog: ``Oceananigans.Distributed(ReactantState(); partition =
Partition(Rx, Ry, 1))`` + Shardy propagation
(/root/reference/sharding/sharded_baroclinic_instability_simulation_run.jl:71,
108). Fields are sharded P("x", "y", None) over a 2-D device mesh; the step
runs under ``shard_map`` with explicit ``ppermute`` halo exchange (NCCL
send/recv on GPUs), so steady-state communication is *only* neighbor
collective-permutes — the invariant the reference CI greps its XLA dumps for
(no all-gather / all-reduce / all-to-all).
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gb25_tpu.models.hydrostatic import time_step
from gb25_tpu.parallel.halo import MeshComm
from gb25_tpu.parallel.localize import localize_grid


def _state_specs(state):
    """PartitionSpecs for a HydrostaticState pytree: 3-D fields P(x,y,None),
    2-D fields P(x,y), scalars replicated."""

    def spec(leaf):
        if leaf.ndim == 3:
            return P("x", "y", None)
        if leaf.ndim == 2:
            return P("x", "y")
        return P()

    return jax.tree_util.tree_map(spec, state)


def _grid_specs(grid):
    return jax.tree_util.tree_map(lambda _: P(), grid)


def shard_state(state, mesh):
    """Place a host/global state pytree onto the mesh with 2-D sharding."""
    specs = _state_specs(state)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


def replicate(tree, mesh):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )


def make_comm(mesh, grid=None, force_ring: bool = False) -> MeshComm:
    kw = {}
    if grid is not None and getattr(grid, "north_fold", False):
        kw = dict(north_fold=True, pole_index=grid.pole_index)
    if force_ring:
        kw["force_ring"] = True
    return MeshComm(Rx=mesh.shape["x"], Ry=mesh.shape["y"], **kw)


def _force_comm_env() -> str | bool:
    """GB25_FORCE_COMM: "1"/"ring" -> identity-ring ppermutes; "local" ->
    decomposed path with local boundary fills (no collectives), which
    isolates the decomposed path's compute overhead."""
    import os

    v = os.environ.get("GB25_FORCE_COMM", "0")
    if v in ("1", "ring"):
        return "ring"
    if v == "local":
        return "local"
    return False


class _CompiledShim:
    """Compiled sharded step with the (state, dt) call surface: the builders
    pass grid/atmos/restoring as hidden jit ARGUMENTS (so they are not baked
    into the IR as constants), and this shim re-injects them."""

    def __init__(self, compiled, extras):
        self._c, self._extras = compiled, extras

    def __call__(self, state, dt):
        return self._c(state, dt, *self._extras)

    def __getattr__(self, name):  # as_text, cost_analysis, memory_analysis...
        return getattr(self._c, name)


class _LoweredShim:
    def __init__(self, lowered, extras):
        self._l, self._extras = lowered, extras

    def compile(self, *a, **kw):
        return _CompiledShim(self._l.compile(*a, **kw), self._extras)

    def __getattr__(self, name):
        return getattr(self._l, name)


def _aot_fn(jitted, extras):
    """fn(state, dt) + fn.lower(state, dt) with ``extras`` injected."""

    def fn(state, dt):
        return jitted(state, dt, *extras)

    fn.lower = lambda state, dt: _LoweredShim(
        jitted.lower(state, dt, *extras), extras)
    return fn


def sharded_step_fn(cfg, grid, mesh, n_inner: int | None = None, restoring=None,
                    force_comm: bool = False):
    """Build a jitted sharded step: ``fn(state, dt) -> state``.

    ``n_inner`` wraps ``n_inner`` steps into one on-device ``fori_loop``
    (reference: the 256-step compiled loop!,
    /root/reference/sharding/sharded_baroclinic_instability_simulation_run.jl:96).
    ``restoring``: optional global {tracer: (target, rate)} dict (sliced
    per-device; reference: ECCORestoring in the sharded runs).

    ``force_comm`` (or env GB25_FORCE_COMM): keep the decomposed
    (comm != None) code path even on a 1x1 mesh — the single-chip
    measurement harness for the distributed program (overlap strip
    recompute + stitch, blocked barotropic solve, W-wide extends,
    localize) whose cost the weak-scaling projection's compute term must
    carry.  True/"ring": identity-ring ppermutes (full program incl.
    collectives).  "local": same decomposed program with local boundary
    fills in place of the ring — the compute overhead alone.
    """
    force_comm = force_comm or _force_comm_env()
    Rx, Ry = mesh.shape["x"], mesh.shape["y"]
    # a 1x1 mesh has no neighbors: every exchange degenerates to the local
    # BC fill, so the serial code path (comm=None) computes identical values
    # without the decomposed path's overhead
    serial_route = Rx == 1 and Ry == 1 and not force_comm
    comm = None if serial_route else make_comm(
        mesh, grid,
        force_ring=(Rx == 1 and Ry == 1 and force_comm != "local"))
    if grid.Nx % Rx or grid.Ny % Ry:
        raise ValueError(f"grid {grid.Nx}x{grid.Ny} not divisible by mesh {Rx}x{Ry}")
    nxl, nyl = grid.Nx // Rx, grid.Ny // Ry
    if comm is not None and min(grid.hx, grid.hy) > min(nxl - 1, nyl - 1):
        import warnings

        warnings.warn(
            f"local tiles {nxl}x{nyl} are smaller than the grid halo "
            f"({grid.hx}, {grid.hy}): the barotropic exchange width W "
            "shrinks locally, so sharded results differ from a serial run "
            "of the same problem at the arithmetic-reassociation level "
            "(~1e-12 relative); use tiles at least halo+1 wide for "
            "bitwise serial agreement", stacklevel=2,
        )

    from gb25_tpu.models.state import initial_state

    proto = initial_state(grid, tracers=cfg.tracers, dtype=grid.dtype)
    sspec = _state_specs(proto)
    gspec = _grid_specs(grid)
    # restoring targets are full 3-D fields consumed interior-only (no
    # halos): shard them like the state instead of replicating ~2 full
    # fields of HBM onto every chip
    def _rspec(leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd == 3:
            return P("x", "y", None)
        if nd == 2:
            return P("x", "y")
        return P()

    rspec = jax.tree_util.tree_map(_rspec, restoring)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(sspec, P(), gspec, rspec),
        out_specs=sspec,
    )
    def _local_step(state, dt, gridrep, restrep):
        # restoring arrives pre-sharded to the local tile (in_specs above),
        # so no per-rank slicing is needed on either branch
        lrest = restrep
        if comm is None:  # 1x1 mesh: local tile == global domain
            lgrid = gridrep
        else:
            lgrid = localize_grid(gridrep, comm, nxl, nyl)

        def one(s, premasked=False):
            return time_step(cfg, lgrid, s, dt, comm, restoring=lrest,
                             premasked=premasked)

        if n_inner is None:
            return one(state)
        # hoist the stage-1 immersed mask out of the loop (see
        # models.hydrostatic.premask_state): the step epilogue re-masks, so
        # masking is a loop invariant and the per-iteration multiply is
        # redundant HBM traffic
        from gb25_tpu.models.hydrostatic import premask_state

        state = premask_state(lgrid, state, comm)
        return jax.lax.fori_loop(
            0, n_inner, lambda _, s: one(s, premasked=True), state)

    # grid metrics and restoring targets ride as jit ARGUMENTS, not closure
    # captures: closed-over jax.Arrays are baked into the lowered module as
    # constants (2-D tripolar metrics and full-field restoring targets are
    # hundreds of MB at 1/4 degree)
    return _aot_fn(jax.jit(_local_step), (grid, restoring))


def sharded_coupled_step_fn(ccfg, grid, atmos, mesh, n_inner: int | None = None,
                            force_comm: bool = False):
    """Jitted sharded coupled (ocean-atmosphere) step: ``fn(state, dt) -> state``."""
    from gb25_tpu.models.coupled import coupled_loop, coupled_time_step
    from gb25_tpu.models.state import initial_state
    from gb25_tpu.parallel.localize import localize_atmosphere

    force_comm = force_comm or _force_comm_env()
    Rx, Ry = mesh.shape["x"], mesh.shape["y"]
    # grid wires the tripolar north fold in; 1x1 meshes take the serial path
    # (force_comm keeps the decomposed path for measurement, see sharded_step_fn)
    serial_route = Rx == 1 and Ry == 1 and not force_comm
    comm = None if serial_route else make_comm(
        mesh, grid,
        force_ring=(Rx == 1 and Ry == 1 and force_comm != "local"))
    if grid.Nx % Rx or grid.Ny % Ry:
        raise ValueError(f"grid {grid.Nx}x{grid.Ny} not divisible by mesh {Rx}x{Ry}")
    nxl, nyl = grid.Nx // Rx, grid.Ny // Ry

    proto = initial_state(grid, tracers=ccfg.ocean.tracers, dtype=grid.dtype)
    sspec = _state_specs(proto)
    gspec = _grid_specs(grid)
    aspec = jax.tree_util.tree_map(lambda _: P(), atmos)
    # place the atmosphere (the biggest replicated operand: pre-regridded
    # forcing can be ~1 GB) onto the mesh ONCE at build time — otherwise
    # every fn() call re-commits it to the required sharding
    atmos = replicate(atmos, mesh)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(sspec, P(), gspec, aspec),
        out_specs=sspec,
    )
    def _local_step(state, dt, gridrep, atmosrep):
        if comm is None:  # 1x1 mesh: local tile == global domain
            lgrid, latmos = gridrep, atmosrep
        else:
            lgrid = localize_grid(gridrep, comm, nxl, nyl)
            latmos = localize_atmosphere(atmosrep, comm, nxl, nyl)
        if n_inner is None:
            return coupled_time_step(ccfg, lgrid, latmos, state, dt, comm)
        return coupled_loop(ccfg, lgrid, latmos, state, dt, n_inner, comm)

    # atmos/grid as jit ARGUMENTS (not closure constants): the pre-regridded
    # atmosphere is ~hundreds of MB at 1/4 degree and would otherwise be
    # baked into the lowered IR
    return _aot_fn(jax.jit(_local_step), (grid, atmos))
