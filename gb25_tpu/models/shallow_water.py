"""Rotating shallow-water model (second model family).

Reference context: GB-25's weak-scaling companion benchmark is a spectral
shallow-water *atmosphere* (SpeedyWeather; BASELINE.md atmosphere rows).
This finite-volume rotating shallow-water model provides that model family
on the same staggered grids, reusing the framework's metrics,
stencils, halo machinery (single-device and shard_map/ppermute) and quasi-AB2
stepping:

    du/dt = +(zeta + f) vbar - d/dx (K + g h)
    dv/dt = -(zeta + f) ubar - d/dy (K + g h)
    dh/dt = -div(h u)

with h the total fluid thickness (bathymetry-aware: h = eta - bottom).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gb25_tpu.models.config import EARTH_ROTATION_RATE, static_pytree
from gb25_tpu.ops.halos import extend2
from gb25_tpu.ops.stencils import dx_c, dx_f, dy_c, dy_f, ix_c, ix_f, iy_c, iy_f


@static_pytree
@dataclasses.dataclass(frozen=True)
class ShallowWaterConfig:
    gravitational_acceleration: float = 9.80665
    coriolis: float = EARTH_ROTATION_RATE
    momentum_advection: str = "vector_invariant"  # | "none"
    chi: float = 0.1


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["u", "v", "h", "Gu", "Gv", "Gh", "time", "iteration"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ShallowWaterState:
    u: jax.Array   # (Nx, Ny) at (f,c)
    v: jax.Array   # (Nx, Ny) at (c,f)
    h: jax.Array   # (Nx, Ny) thickness at centers
    Gu: jax.Array
    Gv: jax.Array
    Gh: jax.Array
    time: jax.Array
    iteration: jax.Array

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def shallow_water_state(grid, h0=1000.0, dtype=None) -> ShallowWaterState:
    dtype = dtype or grid.dtype
    z2 = jnp.zeros((grid.Nx, grid.Ny), dtype)
    return ShallowWaterState(
        u=z2, v=z2, h=jnp.full((grid.Nx, grid.Ny), h0, dtype),
        Gu=z2, Gv=z2, Gh=z2,
        time=jnp.zeros((), dtype), iteration=jnp.zeros((), jnp.int32),
    )


def _metrics2w(grid, W):
    hx, hy = grid.hx, grid.hy
    sly = slice(hy - W, hy + grid.Ny + W)

    def sl(m):
        slx = slice(hx - W, hx + grid.Nx + W) if m.shape[0] > 1 else slice(None)
        return m[slx, sly, 0]

    return sl(grid.dxc), sl(grid.dxf), sl(grid.dyc), sl(grid.dyf), sl(grid.azc), sl(grid.azf)


def sw_tendencies(cfg, grid, state, comm=None):
    W = min(grid.hx, grid.hy)
    ue = extend2(grid, state.u, "u", comm, h=W)
    ve = extend2(grid, state.v, "v", comm, h=W)
    he = extend2(grid, state.h, "c", comm, h=W)
    dxc, dxf, dyc, dyf, azc, azf = _metrics2w(grid, W)

    from gb25_tpu.ops.operators import coriolis_ff

    f_ff = coriolis_ff(grid, cfg.coriolis)[..., 0]
    if f_ff.shape[0] == 1:
        hy = grid.hy
        f2 = f_ff[:, hy - W : hy + grid.Ny + W]
    else:
        hx, hy = grid.hx, grid.hy
        f2 = f_ff[hx - W : hx + grid.Nx + W, hy - W : hy + grid.Ny + W]

    g = cfg.gravitational_acceleration
    q = jnp.broadcast_to(f2, ue.shape)
    if cfg.momentum_advection == "vector_invariant":
        q = q + (dx_f(ve * dyf) - dy_f(ue * dxc)) / azf
        K = 0.5 * (ix_c(ue * ue) + iy_c(ve * ve))
    else:
        K = jnp.zeros_like(ue)

    vbar_fc = iy_c(ix_f(ve))
    ubar_cf = ix_c(iy_f(ue))
    phi = K + g * he  # Bernoulli potential (h = thickness; flat-bottom form)

    Gu = iy_c(q) * vbar_fc - dx_f(phi) / dxc
    Gv = -ix_c(q) * ubar_cf - dy_f(phi) / dyf
    # mass: -div(h u) with thickness interpolated to faces
    Gh = -(dx_c(ix_f(he) * ue * dyc) + dy_c(iy_f(he) * ve * dxf)) / azc

    def crop(a):
        return a[W : W + grid.Nx, W : W + grid.Ny]

    from gb25_tpu.models.hydrostatic import mask_v_wall

    return crop(Gu), mask_v_wall(grid, crop(Gv), comm), crop(Gh)


def sw_time_step(cfg, grid, state, dt, comm=None):
    dtype = state.u.dtype
    dt = jnp.asarray(dt, dtype)
    Gu, Gv, Gh = sw_tendencies(cfg, grid, state, comm)
    first = state.iteration == 0
    c1 = jnp.where(first, 1.0, 1.5 + cfg.chi).astype(dtype)
    c2 = jnp.where(first, 0.0, -(0.5 + cfg.chi)).astype(dtype)

    from gb25_tpu.models.hydrostatic import mask_v_wall

    u = state.u + dt * (c1 * Gu + c2 * state.Gu)
    v = mask_v_wall(grid, state.v + dt * (c1 * Gv + c2 * state.Gv), comm)
    h = state.h + dt * (c1 * Gh + c2 * state.Gh)
    return state.replace(
        u=u, v=v, h=h, Gu=Gu, Gv=Gv, Gh=Gh,
        time=state.time + dt, iteration=state.iteration + 1,
    )


def sw_loop(cfg, grid, state, dt, n, comm=None):
    def body(_, s):
        return sw_time_step(cfg, grid, s, dt, comm)

    return jax.lax.fori_loop(0, n, body, state)
