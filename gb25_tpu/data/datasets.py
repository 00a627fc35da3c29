"""Data-driven layer: bathymetry regridding, climatology restoring, and
file-backed prescribed atmospheres.

Reference capability (simulations/ocean_climate_simulation.jl):
  - ``regrid_bathymetry`` from ETOPO1 (:60-62)
  - ``ECCORestoring`` of T/S to ECCO4 monthly climatology with a
    ``LinearlyTaperedPolarMask(southern=(-80,-70), northern=(70,90))`` and
    rate 1/(7 days) (:65-72); initialization from the ECCO state (:78-79)
  - ``JRA55PrescribedAtmosphere`` (:83)

This environment has zero network egress and no NetCDF reader, so the loaders
consume pre-converted ``.npz`` files with a documented layout, and every
entry point has a synthetic fallback so the data-free path (the reference's
benchmark configuration, BASELINE.md) never needs a download. Dataset files:

  bathymetry.npz:  lat (Ma,), lon (Na,), z (Na, Ma) [m, negative under water]
  climatology.npz: lat, lon, z_levels (L,), T (Na, Ma, L), S (Na, Ma, L)
  atmosphere.npz:  lat, lon, times (Nt,) [s], Ta/ua/va/qa/Qsw/Qlw/pa (Na,Ma,Nt)
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from gb25_tpu.models.atmosphere import PrescribedAtmosphere, _bilinear_weights


def _dst_coords(grid):
    if getattr(grid, "lam2_c", None) is not None:
        return np.asarray(grid.lam2_c), np.asarray(grid.phi2_c)
    lam = np.asarray(grid.lam_c_i)[:, None]
    phi = np.asarray(grid.phi_c_i)[None, :]
    return (np.broadcast_to(lam, (grid.Nx, grid.Ny)),
            np.broadcast_to(phi, (grid.Nx, grid.Ny)))


def _regrid2d(src_lon, src_lat, field, dst_lon, dst_lat):
    ix0, ix1, wx, iy0, iy1, wy = _bilinear_weights(src_lon, src_lat, dst_lon, dst_lat)
    f00 = field[ix0, iy0]
    f10 = field[ix1, iy0]
    f01 = field[ix0, iy1]
    f11 = field[ix1, iy1]
    return ((1 - wx) * (1 - wy) * f00 + wx * (1 - wy) * f10
            + (1 - wx) * wy * f01 + wx * wy * f11)


def _interp_z_columns(zc, zl, F):
    """Vectorized per-column linear z interpolation with ``np.interp``
    semantics (clamped to the end values outside the level range).

    ``F``: (..., L) sampled at ascending ``zl``; returns (..., len(zc)).
    One fancy-index expression instead of a Python loop over every (i, j)
    column (~600k np.interp calls at flagship resolution)."""
    zc = np.asarray(zc, dtype=np.float64)
    zl = np.asarray(zl, dtype=np.float64)
    if len(zl) == 1:  # constant column
        return np.broadcast_to(F[..., 0:1], F.shape[:-1] + (len(zc),)).copy()
    idx = np.clip(np.searchsorted(zl, zc, side="right"), 1, len(zl) - 1)
    z0, z1 = zl[idx - 1], zl[idx]
    w = np.clip((zc - z0) / np.maximum(z1 - z0, 1e-30), 0.0, 1.0)
    return F[..., idx - 1] * (1.0 - w) + F[..., idx] * w


def _is_netcdf(path):
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        magic = f.read(4)
    return magic[:3] == b"CDF" or magic == b"\x89HDF"


def regrid_bathymetry(grid, path):
    """Regrid a bathymetry dataset onto the model grid and attach it
    (reference: regrid_bathymetry from ETOPO1). Accepts the converted
    ``.npz`` contract or a NetCDF file directly (ETOPO variable names)."""
    from gb25_tpu.grids.immersed import with_bathymetry

    if _is_netcdf(path):
        from gb25_tpu.data.netcdf import load_bathymetry_nc

        lon, lat, z = load_bathymetry_nc(path)
    else:
        with np.load(path) as d:
            lon, lat, z = d["lon"], d["lat"], d["z"]
    dlon, dlat = _dst_coords(grid)
    bh = _regrid2d(lon, lat, z, dlon, dlat)
    return with_bathymetry(grid, jnp.asarray(np.minimum(bh, 0.0), grid.dtype))


def linearly_tapered_polar_mask(grid, southern=(-80.0, -70.0), northern=(70.0, 90.0)):
    """Rate mask ramping 0 -> 1 into the polar caps (reference:
    LinearlyTaperedPolarMask)."""
    _, phi = _dst_coords(grid)
    s0, s1 = southern
    n0, n1 = northern
    south = np.clip((s1 - phi) / max(s1 - s0, 1e-9), 0.0, 1.0)
    north = np.clip((phi - n0) / max(n1 - n0, 1e-9), 0.0, 1.0)
    return jnp.asarray(np.maximum(south, north), grid.dtype)[:, :, None]


def climatology_restoring(grid, path=None, rate=1.0 / (7 * 86400.0), mask=None,
                          synthetic=True):
    """Build the ``restoring`` dict for time_step: T/S relaxed toward a
    climatology at ``rate`` under a polar mask (reference: ECCORestoring).

    With no dataset (``path=None`` and synthetic=True) a smooth analytic
    climatology stands in, so the pipeline is exercised without downloads.
    """
    dlon, dlat = _dst_coords(grid)
    zc = np.asarray(grid.z_c_i)
    if path is not None and not os.path.exists(path):
        # an explicitly requested dataset must not silently degrade to the
        # synthetic stand-in (mistyped --climatology would otherwise produce
        # scientifically wrong "ECCO-restored" results with no warning)
        raise FileNotFoundError(f"climatology dataset not found: {path}")
    if path is not None:
        if _is_netcdf(path):
            from gb25_tpu.data.netcdf import load_climatology_nc

            d = load_climatology_nc(path)
            lon, lat, zl = d["lon"], d["lat"], d["z_levels"]
            Tsrc, Ssrc = d["T"], d["S"]
        else:
            with np.load(path) as d:
                lon, lat, zl = d["lon"], d["lat"], d["z_levels"]
                Tsrc, Ssrc = d["T"], d["S"]
        # horizontal regrid per level then linear interp in z
        T = np.stack([_regrid2d(lon, lat, Tsrc[..., k], dlon, dlat)
                      for k in range(len(zl))], axis=-1)
        S = np.stack([_regrid2d(lon, lat, Ssrc[..., k], dlon, dlat)
                      for k in range(len(zl))], axis=-1)
        order = np.argsort(zl)
        Tg = _interp_z_columns(zc, zl[order], T[..., order])
        Sg = _interp_z_columns(zc, zl[order], S[..., order])
    elif synthetic:
        # analytic stand-in with realistic structure
        phi3 = dlat[:, :, None]
        z3 = zc[None, None, :]
        Tg = (2.0 + 26.0 * np.cos(np.deg2rad(phi3)) ** 2) * np.exp(z3 / 1000.0) + 2.0
        Sg = 35.0 - 1.5 * np.exp(z3 / 500.0) * np.cos(np.deg2rad(phi3))
    else:
        raise FileNotFoundError(f"climatology dataset not found: {path}")

    if mask is None:
        mask = linearly_tapered_polar_mask(grid)
    r = rate * mask
    return {
        "T": (jnp.asarray(Tg, grid.dtype), r),
        "S": (jnp.asarray(Sg, grid.dtype), r),
    }


def initial_state_from_climatology(grid, cfg, path=None):
    """Initialize T/S from the (file or synthetic) climatology (reference:
    set!(ocean.model, T=ECCOMetadata(:temperature), ...))."""
    from gb25_tpu.models.state import initial_state

    rest = climatology_restoring(grid, path=path, rate=0.0)
    st = initial_state(grid, cfg.tracers, grid.dtype)
    tr = dict(st.tracers)
    tr["T"] = rest["T"][0]
    tr["S"] = rest["S"][0]
    if "e" in tr:
        tr["e"] = jnp.full(grid.shape, 1e-6, grid.dtype)
    if "eps" in tr:
        tr["eps"] = jnp.full(grid.shape, 1e-9, grid.dtype)
    return st.replace(tracers=tr)


def file_prescribed_atmosphere(grid, path, dtype=None, pre_regrid=True):
    """PrescribedAtmosphere from a converted dataset file (reference:
    JRA55PrescribedAtmosphere with a NetCDF backend).

    ``pre_regrid``: regrid the record onto ocean centers at load time (one
    numpy pass; removes ~28 two-dimensional gathers per coupled step).  Pass False for
    records too large for HBM — the step then gathers per step."""
    dtype = dtype or grid.dtype
    if _is_netcdf(path):
        from gb25_tpu.data.netcdf import load_atmosphere_nc

        d = load_atmosphere_nc(path)
        lon, lat, times = d["lon"], d["lat"], d["times"]
        fields = {k: d[k] for k in ("Ta", "ua", "va", "qa", "Qsw", "Qlw", "pa") if k in d}
    else:
        with np.load(path) as d:
            lon, lat, times = d["lon"], d["lat"], d["times"]
            fields = {k: d[k] for k in ("Ta", "ua", "va", "qa", "Qsw", "Qlw", "pa") if k in d}
    dlon, dlat = _dst_coords(grid)
    ix0, ix1, wx, iy0, iy1, wy = _bilinear_weights(lon, lat, dlon, dlat)
    period = float(times[-1] + (times[1] - times[0]) - times[0]) if len(times) > 1 else 86400.0
    as_dt = lambda a: jnp.asarray(a, dtype)
    defaults = {"va": 0.0, "qa": 0.0, "Qlw": 350.0, "pa": 101325.0}
    Na, Ma, Nt = fields["Ta"].shape
    for k, v in defaults.items():
        if k not in fields:
            fields[k] = np.full((Na, Ma, Nt), v)
    atmos = PrescribedAtmosphere(
        fields={k: as_dt(v) for k, v in fields.items()},
        times=as_dt(times), period=period,
        ix0=jnp.asarray(ix0), ix1=jnp.asarray(ix1), wx=as_dt(wx),
        iy0=jnp.asarray(iy0), iy1=jnp.asarray(iy1), wy=as_dt(wy),
    )
    return atmos.pre_regrid() if pre_regrid else atmos
