"""Prescribed atmosphere + regridding to the ocean grid.

Reference capability: ``PrescribedAtmosphere(atmos_grid, atmos_times)`` on a
360x180 lat-lon grid with 24 hourly times, analytic zonal wind / shortwave /
temperature, q = 0 (/root/reference/src/data_free_ocean_climate_model.jl:1-3,
30-58).

Design: atmosphere state fields live on their own (coarser) lat-lon grid as
``(Nx_a, Ny_a, Nt)`` arrays; each coupled step linearly interpolates in time
(periodic over the record) and bilinearly regrids to ocean cell centers using
precomputed gather indices + weights (a handful of ``jnp.take`` ops — cheap,
fusable, and sharding-friendly since the atmosphere is replicated like the
grid metrics).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _bilinear_weights(src_x, src_y, dst_x, dst_y, periodic_x=360.0):
    """Precompute separable bilinear gather indices/weights.

    src_x (Na,), src_y (Ma,): source cell-center coords (monotonic).
    dst_x, dst_y: target coords, arbitrary shape (broadcastable pair).
    Returns (ix0, ix1, wx, iy0, iy1, wy) as numpy arrays.
    """
    src_x = np.asarray(src_x, np.float64)
    src_y = np.asarray(src_y, np.float64)
    dx = np.asarray(dst_x, np.float64)
    dy = np.asarray(dst_y, np.float64)

    if periodic_x:
        dxm = (dx - src_x[0]) % periodic_x + src_x[0]
        ext = np.concatenate([src_x, src_x[:1] + periodic_x])
        ix0 = np.clip(np.searchsorted(ext, dxm, side="right") - 1, 0, len(src_x) - 1)
        x0 = ext[ix0]
        x1 = ext[ix0 + 1]
        ix1 = (ix0 + 1) % len(src_x)
        wx = (dxm - x0) / (x1 - x0)
    else:
        ix0 = np.clip(np.searchsorted(src_x, dx, side="right") - 1, 0, len(src_x) - 2)
        ix1 = ix0 + 1
        wx = np.clip((dx - src_x[ix0]) / (src_x[ix1] - src_x[ix0]), 0.0, 1.0)

    iy0 = np.clip(np.searchsorted(src_y, dy, side="right") - 1, 0, len(src_y) - 2)
    iy1 = iy0 + 1
    wy = np.clip((dy - src_y[iy0]) / (src_y[iy1] - src_y[iy0]), 0.0, 1.0)
    return ix0, ix1, wx, iy0, iy1, wy


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["fields", "times", "ix0", "ix1", "wx", "iy0", "iy1", "wy"],
    meta_fields=["period", "on_ocean_grid"],
)
@dataclasses.dataclass(frozen=True)
class PrescribedAtmosphere:
    """Time series of atmospheric surface fields + regrid plan to the ocean grid.

    fields: dict name -> (Na, Ma, Nt) array. Standard names:
      Ta (K), ua/va (m/s), qa (kg/kg), Qsw (W/m^2, downwelling shortwave),
      Qlw (W/m^2, downwelling longwave), pa (Pa).

    ``on_ocean_grid=True``: fields are pre-regridded (Nx, Ny, Nt) arrays on
    ocean centers and ``at_time`` is a pure time interpolation.  Keep this on
    whenever the record fits in HBM: spatial regridding per coupled step
    costs ~28 two-dimensional gathers, while regridding once at
    construction moves that to init-time numpy and leaves a 2-pass lerp.
    """

    fields: dict
    times: jax.Array  # (Nt,) seconds
    period: float  # record period (seconds); time interp is cyclic
    # regrid plan onto ocean centers (shape = ocean (Nx, Ny))
    ix0: jax.Array
    ix1: jax.Array
    wx: jax.Array
    iy0: jax.Array
    iy1: jax.Array
    wy: jax.Array
    on_ocean_grid: bool = False

    def _time_weights(self, t):
        tt = jnp.mod(t, self.period)
        nt = self.times.shape[0]
        k0 = jnp.clip(jnp.searchsorted(self.times, tt, side="right") - 1, 0, nt - 1)
        k1 = jnp.where(k0 + 1 < nt, k0 + 1, 0)
        t0 = self.times[k0]
        t1 = jnp.where(k0 + 1 < nt, self.times[k1], self.times[k0] + (self.times[1] - self.times[0]))
        wt = jnp.clip((tt - t0) / jnp.maximum(t1 - t0, 1e-30), 0.0, 1.0)
        return k0, k1, wt

    def at_time(self, t):
        """Regridded fields on ocean centers at model time t: dict of (Nx, Ny)."""
        k0, k1, wt = self._time_weights(t)

        out = {}
        for name, f in self.fields.items():
            ft = (1.0 - wt) * f[:, :, k0] + wt * f[:, :, k1]
            if self.on_ocean_grid:
                out[name] = ft  # already (Nx, Ny)
                continue
            f00 = ft[self.ix0, self.iy0]
            f10 = ft[self.ix1, self.iy0]
            f01 = ft[self.ix0, self.iy1]
            f11 = ft[self.ix1, self.iy1]
            out[name] = (
                (1 - self.wx) * (1 - self.wy) * f00
                + self.wx * (1 - self.wy) * f10
                + (1 - self.wx) * self.wy * f01
                + self.wx * self.wy * f11
            )
        return out

    def pre_regrid(self):
        """Apply the (static) spatial regrid to every time snapshot at once,
        returning an ``on_ocean_grid`` atmosphere.  Runs in numpy at
        construction time — the per-step gathers disappear from the traced
        coupled step.  Time interpolation and spatial interpolation are both
        linear, so the reordering (regrid-then-lerp vs lerp-then-regrid) is
        exact up to float rounding."""
        if self.on_ocean_grid:
            return self
        ix0, ix1 = np.asarray(self.ix0), np.asarray(self.ix1)
        iy0, iy1 = np.asarray(self.iy0), np.asarray(self.iy1)
        wx = np.asarray(self.wx, np.float64)[:, :, None]
        wy = np.asarray(self.wy, np.float64)[:, :, None]
        out = {}
        for name, f in self.fields.items():
            fn = np.asarray(f, np.float64)  # (Na, Ma, Nt)
            g = (
                (1 - wx) * (1 - wy) * fn[ix0, iy0, :]
                + wx * (1 - wy) * fn[ix1, iy0, :]
                + (1 - wx) * wy * fn[ix0, iy1, :]
                + wx * wy * fn[ix1, iy1, :]
            )
            out[name] = jnp.asarray(g, f.dtype)
        empty_i = jnp.zeros((0,), jnp.int32)
        empty_f = jnp.zeros((0,), self.wx.dtype)
        return dataclasses.replace(
            self, fields=out, on_ocean_grid=True,
            ix0=empty_i, ix1=empty_i, wx=empty_f,
            iy0=empty_i, iy1=empty_i, wy=empty_f,
        )


def zonal_wind(phi):
    """Reference analytic wind (data_free_ocean_climate_model.jl:1)."""
    return 4.0 * np.sin(np.deg2rad(2 * phi)) ** 2 - 2.0 * np.exp(-((np.abs(phi) - 12.0) ** 2) / 72.0)


def sunlight(phi):
    """Reference analytic shortwave (:2). Sign: reference uses negative-down
    heating convention; we store positive-down W/m^2."""
    return 200.0 + 600.0 * np.cos(np.deg2rad(phi)) ** 2


def atmos_temperature(phi):
    """Reference analytic air temperature (:3), Kelvin."""
    return 30.0 * np.cos(np.deg2rad(phi)) + 273.15


def data_free_atmosphere(ocean_grid, Na=360, Ma=180, ntimes=24, dtype=None,
                         pre_regrid=True):
    """The reference's data-free atmosphere: analytic, steady fields sampled
    on a 360x180 grid with 24 hourly times over one day
    (data_free_ocean_climate_model.jl:30-58).

    ``pre_regrid``: regrid the whole record onto ocean centers at
    construction (see PrescribedAtmosphere.on_ocean_grid); pass False to
    keep the per-step gather path (exercised in tests)."""
    dtype = dtype or ocean_grid.dtype
    lam_a = (np.arange(Na) + 0.5) * (360.0 / Na)
    phi_a = -90.0 + (np.arange(Ma) + 0.5) * (180.0 / Ma)
    times = np.linspace(0.0, 86400.0, ntimes, endpoint=False)

    Ta = np.broadcast_to(atmos_temperature(phi_a)[None, :, None], (Na, Ma, ntimes))
    ua = np.broadcast_to(zonal_wind(phi_a)[None, :, None], (Na, Ma, ntimes))
    Qsw = np.broadcast_to(sunlight(phi_a)[None, :, None], (Na, Ma, ntimes))
    zeros = np.zeros((Na, Ma, ntimes))

    if getattr(ocean_grid, "lam2_c", None) is not None:
        # curvilinear (tripolar) ocean grid: 2-D cell-center coordinates
        dst_lam = np.asarray(ocean_grid.lam2_c) % 360.0
        dst_phi = np.asarray(ocean_grid.phi2_c)
    else:
        dst_lam = np.asarray(ocean_grid.lam_c_i)[:, None] + 0 * np.asarray(ocean_grid.phi_c_i)[None, :]
        dst_phi = 0 * dst_lam + np.asarray(ocean_grid.phi_c_i)[None, :]
    ix0, ix1, wx, iy0, iy1, wy = _bilinear_weights(lam_a, phi_a, dst_lam, dst_phi)

    as_dt = lambda a: jnp.asarray(a, dtype)
    atmos = PrescribedAtmosphere(
        fields={
            "Ta": as_dt(Ta), "ua": as_dt(ua), "va": as_dt(zeros),
            "qa": as_dt(zeros), "Qsw": as_dt(Qsw),
            "Qlw": as_dt(zeros + 350.0),  # steady clear-sky downwelling LW
            "pa": as_dt(zeros + 101325.0),
        },
        times=as_dt(times), period=86400.0,
        ix0=jnp.asarray(ix0), ix1=jnp.asarray(ix1), wx=as_dt(wx),
        iy0=jnp.asarray(iy0), iy1=jnp.asarray(iy1), wy=as_dt(wy),
    )
    return atmos.pre_regrid() if pre_regrid else atmos
