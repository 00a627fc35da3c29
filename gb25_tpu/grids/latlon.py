"""Latitude-longitude grid with staggered (Arakawa C) finite-volume metrics.

Reference behavior reimplemented (not ported): GB-25's
``simple_latitude_longitude_grid`` (/root/reference/src/model_utils.jl:56-65)
builds an Oceananigans ``LatitudeLongitudeGrid`` with latitude in (-80, 80),
longitude in (0, 360), exponential z faces (depth 4000 m, surface spacing
~30 m) and halo (8,8,8).

Design notes:

- Field arrays are laid out ``(x, y, z)`` with z innermost so a column is
  contiguous (the vertical solves walk it) and horizontal stencils are
  strided shifts that XLA fuses.
- Prognostic fields are stored *interior-only* ``(Nx, Ny, Nz)``; stencil
  operators act on halo-extended arrays produced functionally each stage
  (single device: pad/wrap; distributed: ``lax.ppermute`` under
  ``shard_map``), so the identical physics code serves both paths.
- All grid metric arrays are precomputed *already halo-extended* so stencils
  evaluated in the halo band see correct metrics. The bounded-y extension
  mirrors latitudes about the wall, which keeps ``cos(phi)`` in range for any
  halo width and makes a mirrored (free-slip) velocity field have exactly
  zero circulation at the wall.

Staggering convention (indices align with Oceananigans'):
  - tracer/center points: cell ``(i, j, k)``
  - ``u`` at x-face ``i`` = *west* face of cell ``i``   (f, c, c)
  - ``v`` at y-face ``j`` = *south* face of cell ``j``  (c, f, c)
  - ``w`` at z-face ``k`` = *bottom* face of cell ``k`` (c, c, f)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gb25_tpu.grids.vertical import exponential_z_faces, uniform_z_faces

EARTH_RADIUS = 6.371e6  # meters (Oceananigans' R_Earth default)
DEG2RAD = np.pi / 180.0


def _extend_wrap_coord(a: np.ndarray, h: int, period: float) -> np.ndarray:
    """Periodic extension of a coordinate (adds/subtracts the period)."""
    if h == 0:
        return a
    return np.concatenate([a[-h:] - period, a, a[:h] + period])


def _extend_mirror_centers(a: np.ndarray, h: int, lo_pivot: float, hi_pivot: float) -> np.ndarray:
    """Mirror-extend center coordinates (walls lie *between* samples)."""
    if h == 0:
        return a
    below = (2 * lo_pivot - a[:h])[::-1]
    above = (2 * hi_pivot - a[-h:])[::-1]
    return np.concatenate([below, a, above])


def _extend_mirror_faces(a: np.ndarray, h: int, lo_pivot: float, hi_pivot: float) -> np.ndarray:
    """Mirror-extend face coordinates (walls *are* the end samples)."""
    if h == 0:
        return a
    below = 2 * lo_pivot - a[1 : h + 1][::-1]
    above = 2 * hi_pivot - a[-h - 1 : -1][::-1]
    return np.concatenate([below, a, above])


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "lam_c", "lam_f", "phi_c", "phi_f", "z_c", "z_f",
        "dz_c", "dz_f",
        "dxc", "dxf", "dyc", "dyf", "azc", "azf",
        "bottom_height",
    ],
    meta_fields=["Nx", "Ny", "Nz", "halo", "x_periodic", "dtype_name", "immersed"],
)
@dataclasses.dataclass(frozen=True)
class LatitudeLongitudeGrid:
    """Spherical-shell staggered grid. All metric arrays are halo-extended.

    1-D coordinate arrays have extended length (``N + 2h``); metric arrays are
    shaped to broadcast against extended ``(X, Y, Z)`` field arrays:
    ``dx*/dy*/az*`` are ``(1, Ny+2hy, 1)`` and ``dz*`` are ``(1, 1, Nz+2hz)``.
    """

    # -- static metadata --
    Nx: int
    Ny: int
    Nz: int
    halo: tuple  # (hx, hy, hz)
    x_periodic: bool
    dtype_name: str
    immersed: bool  # True when bottom_height carries real bathymetry

    # -- coordinates (halo-extended 1-D) --
    lam_c: jax.Array  # (Nx+2hx,) cell-center longitude, degrees
    lam_f: jax.Array  # (Nx+2hx,) west-face longitude
    phi_c: jax.Array  # (Ny+2hy,) cell-center latitude
    phi_f: jax.Array  # (Ny+2hy,) south-face latitude
    z_c: jax.Array    # (1,1,Nz+2hz) cell-center z (m, negative below surface)
    z_f: jax.Array    # (1,1,Nz+2hz) bottom-face z

    # -- spacings --
    dz_c: jax.Array   # (1,1,Nz+2hz) cell thickness (z_f[k+1]-z_f[k])
    dz_f: jax.Array   # (1,1,Nz+2hz) center-to-center spacing at bottom face k

    # -- horizontal metrics (broadcast (1, Ny+2hy, 1)) --
    dxc: jax.Array  # zonal spacing at phi-centers  (locations (c,c),(f,c))
    dxf: jax.Array  # zonal spacing at phi-faces    (locations (c,f),(f,f))
    dyc: jax.Array  # meridional spacing at phi-centers
    dyf: jax.Array  # meridional spacing at phi-faces
    azc: jax.Array  # horizontal cell area at phi-centers (exact spherical)
    azf: jax.Array  # horizontal corner-cell area at phi-faces

    # -- bathymetry: bottom height (m, negative), (Nx, Ny) interior-only;
    #    full-depth grids use a constant -depth array --
    bottom_height: jax.Array

    # ------------------------------------------------------------------
    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    @property
    def hx(self):
        return self.halo[0]

    @property
    def hy(self):
        return self.halo[1]

    @property
    def hz(self):
        return self.halo[2]

    @property
    def shape(self):
        return (self.Nx, self.Ny, self.Nz)

    def interior(self, ext: jax.Array) -> jax.Array:
        """Crop a halo-extended (X, Y, Z) array to the interior."""
        hx, hy, hz = self.halo
        return ext[hx : hx + self.Nx, hy : hy + self.Ny, hz : hz + self.Nz]

    # Interior coordinate accessors (for initial conditions / output)
    @property
    def lam_c_i(self):
        return self.lam_c[self.hx : self.hx + self.Nx]

    @property
    def phi_c_i(self):
        return self.phi_c[self.hy : self.hy + self.Ny]

    @property
    def z_c_i(self):
        return self.z_c[0, 0, self.hz : self.hz + self.Nz]

    @property
    def z_f_i(self):
        return self.z_f[0, 0, self.hz : self.hz + self.Nz]


def latitude_longitude_grid(
    Nx: int,
    Ny: int,
    Nz: int,
    latitude=(-80.0, 80.0),
    longitude=(0.0, 360.0),
    z_faces: np.ndarray | None = None,
    depth: float = 4000.0,
    surface_dz: float = 30.0,
    halo=(4, 4, 4),
    dtype=jnp.float32,
) -> LatitudeLongitudeGrid:
    """Build a LatitudeLongitudeGrid (defaults mirror the reference's
    ``simple_latitude_longitude_grid``; halo default 4 suffices for WENO-5)."""
    hx, hy, hz = halo
    lat0, lat1 = latitude
    lon0, lon1 = longitude
    x_periodic = abs((lon1 - lon0) - 360.0) < 1e-12

    dlam = (lon1 - lon0) / Nx
    dphi = (lat1 - lat0) / Ny
    lam_f = lon0 + dlam * np.arange(Nx, dtype=np.float64)
    lam_c = lam_f + 0.5 * dlam
    phi_f = lat0 + dphi * np.arange(Ny, dtype=np.float64)
    phi_c = phi_f + 0.5 * dphi

    if z_faces is None:
        if surface_dz is None:
            z_faces = uniform_z_faces(Nz, depth)
        else:
            z_faces = exponential_z_faces(Nz, depth=depth, h=surface_dz)
    z_faces = np.asarray(z_faces, dtype=np.float64)
    assert z_faces.shape == (Nz + 1,)

    # --- extend coordinates ---
    if x_periodic:
        lam_c_e = _extend_wrap_coord(lam_c, hx, 360.0)
        lam_f_e = _extend_wrap_coord(lam_f, hx, 360.0)
    else:
        lam_c_e = np.concatenate(
            [lam_c[0] + dlam * np.arange(-hx, 0), lam_c, lam_c[-1] + dlam * np.arange(1, hx + 1)]
        )
        lam_f_e = np.concatenate(
            [lam_f[0] + dlam * np.arange(-hx, 0), lam_f, lam_f[-1] + dlam * np.arange(1, hx + 1)]
        )

    # Bounded y: mirror about the walls (south wall at phi_f[0], north wall at
    # phi_f[0] + Ny*dphi). Mirroring keeps |phi| bounded and makes free-slip
    # ghost velocities circulation-free.
    south_wall = phi_f[0]
    north_wall = phi_f[0] + Ny * dphi
    phi_c_e = _extend_mirror_centers(phi_c, hy, south_wall, north_wall)
    # Faces mirror about walls too; the face array's pivot entries are the
    # walls themselves.
    phi_f_full = np.append(phi_f, north_wall)  # Ny+1 faces
    phi_f_e = _extend_mirror_faces(phi_f_full, hy, south_wall, north_wall)[: Ny + 2 * hy]

    # z extension: continue edge spacing outward.
    zf = z_faces
    dz_bot = zf[1] - zf[0]
    dz_top = zf[-1] - zf[-2]
    z_f_full = np.concatenate(
        [zf[0] + dz_bot * np.arange(-hz, 0), zf, zf[-1] + dz_top * np.arange(1, hz + 1)]
    )  # Nz+1+2hz faces
    z_c_full = 0.5 * (z_f_full[:-1] + z_f_full[1:])  # Nz+2hz centers
    z_f_e = z_f_full[: Nz + 2 * hz]  # bottom-face of each (extended) cell
    dz_c = z_f_full[1:] - z_f_full[:-1]  # (Nz+2hz,) thickness of cell k
    # spacing between centers, located at bottom face k (center k - center k-1)
    dz_f = np.empty(Nz + 2 * hz)
    dz_f[1:] = z_c_full[1:] - z_c_full[:-1]
    dz_f[0] = dz_f[1]

    # --- metrics (double precision on host, cast at the end) ---
    # Metric *values* are computed on the interior (+walls) and mirror-extended
    # in bounded y. Mirroring values (rather than evaluating cos(phi) at
    # mirrored ghost latitudes, which can exceed +-90 deg on coarse grids)
    # keeps every ghost metric positive and makes free-slip ghost velocities
    # exactly circulation-free at the walls.
    R = EARTH_RADIUS
    dlam_r = dlam * DEG2RAD
    dphi_r = dphi * DEG2RAD
    dx_c_i = R * np.cos(phi_c * DEG2RAD) * dlam_r  # (Ny,)
    dx_f_i = R * np.cos(phi_f_full * DEG2RAD) * dlam_r  # (Ny+1,)
    # Exact spherical areas: R^2 * dlam * (sin(phi_north) - sin(phi_south))
    az_c_i = R * R * dlam_r * (
        np.sin(phi_f_full[1:] * DEG2RAD) - np.sin(phi_f_full[:-1] * DEG2RAD)
    )  # (Ny,)
    az_f_i = R * R * dlam_r * np.abs(
        np.sin(np.minimum(phi_f_full + 0.5 * dphi, 90.0) * DEG2RAD)
        - np.sin(np.maximum(phi_f_full - 0.5 * dphi, -90.0) * DEG2RAD)
    )  # (Ny+1,)

    # value-mirroring: same index bookkeeping as the coordinate mirrors but
    # without the pivot reflection (values are symmetric about the wall).
    dx_c = np.concatenate([dx_c_i[:hy][::-1], dx_c_i, dx_c_i[-hy:][::-1]]) if hy else dx_c_i
    dx_f = (
        np.concatenate([dx_f_i[1 : hy + 1][::-1], dx_f_i, dx_f_i[-hy - 1 : -1][::-1]])[: Ny + 2 * hy]
        if hy
        else dx_f_i[:Ny]
    )
    az_c = np.concatenate([az_c_i[:hy][::-1], az_c_i, az_c_i[-hy:][::-1]]) if hy else az_c_i
    az_f = (
        np.concatenate([az_f_i[1 : hy + 1][::-1], az_f_i, az_f_i[-hy - 1 : -1][::-1]])[: Ny + 2 * hy]
        if hy
        else az_f_i[:Ny]
    )
    dy_c = np.full(Ny + 2 * hy, R * dphi_r)
    dy_f = np.full(Ny + 2 * hy, R * dphi_r)

    def col(a):  # (1, Ny+2hy, 1)
        return jnp.asarray(a, dtype=dtype).reshape(1, -1, 1)

    def zrow(a):  # (1, 1, Nz+2hz)
        return jnp.asarray(a, dtype=dtype).reshape(1, 1, -1)

    return LatitudeLongitudeGrid(
        Nx=Nx, Ny=Ny, Nz=Nz, halo=(hx, hy, hz), x_periodic=x_periodic,
        dtype_name=jnp.dtype(dtype).name, immersed=False,
        lam_c=jnp.asarray(lam_c_e, dtype=dtype),
        lam_f=jnp.asarray(lam_f_e, dtype=dtype),
        phi_c=jnp.asarray(phi_c_e, dtype=dtype),
        phi_f=jnp.asarray(phi_f_e, dtype=dtype),
        z_c=zrow(z_c_full), z_f=zrow(z_f_e),
        dz_c=zrow(dz_c), dz_f=zrow(dz_f),
        dxc=col(dx_c), dxf=col(dx_f), dyc=col(dy_c), dyf=col(dy_f),
        azc=col(az_c), azf=col(az_f),
        bottom_height=jnp.full((Nx, Ny), z_faces[0], dtype=dtype),
    )


def simple_latitude_longitude_grid(Nx, Ny, Nz, halo=(4, 4, 4), dtype=jnp.float32):
    """The reference's benchmark grid (model_utils.jl:56-65): lat (-80,80),
    lon (0,360), exponential z over 4000 m with 30 m surface spacing."""
    return latitude_longitude_grid(
        Nx, Ny, Nz,
        latitude=(-80.0, 80.0), longitude=(0.0, 360.0),
        depth=4000.0, surface_dz=30.0, halo=halo, dtype=dtype,
    )


def resolution_to_points(resolution: float) -> tuple[int, int]:
    """Reference: resolution_to_points (model_utils.jl:45-49)."""
    return int(384 / resolution), int(192 / resolution)
