"""Tripolar grid (curvilinear north cap with two displaced poles + north fold).

Reference capability: Oceananigans' ``TripolarGrid`` used by
``gaussian_islands_tripolar_grid`` (/root/reference/src/model_utils.jl:134-146)
— the reference even places its two Gaussian islands at the tripolar pole
locations (70E, 55N) and (250E, 55N) so the singularities sit on land.

Construction (Murray 1996-style composite grid, implemented independently):
  - south of the pole latitude ``phi_p``: ordinary lat-lon rows;
  - north of it: a conformal bipolar cap. In the stereographic projection
    about the north pole the two displaced poles sit at +-r_p on the rotated
    real axis; the bipolar map w = log((z - r_p)/(z + r_p)) sends the family
    of circles through both poles to iso-tau lines, with tau = pi/2 on the
    phi_p parallel and tau = pi on the fold seam. Rows are uniform in tau,
    columns reuse the lat-lon sigma = log(tan(theta/2)) so grid lines are
    continuous at the junction and orthogonal in the cap.
  - T-pivot north fold: the seam passes through the *centers* of the last
    row, which is self-mirrored (i <-> 2p - i mod Nx); ghost rows beyond are
    mirrored/sign-flipped copies of interior rows (NEMO/ORCA-style fold).

Metrics are great-circle finite differences of the generated staggered
coordinates (what curvilinear ocean grids do in practice); the conformal cap
keeps the grid orthogonal so Az = dx * dy holds to discretization order.

Round-1 scope: single-device (and x-sharded-free) execution; the distributed
north-fold ppermute pairing is deferred and guarded.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gb25_tpu.grids.latlon import DEG2RAD, EARTH_RADIUS
from gb25_tpu.grids.vertical import exponential_z_faces, uniform_z_faces


def _great_circle(lam1, phi1, lam2, phi2):
    """Great-circle distance [m] between points given in degrees."""
    l1, p1, l2, p2 = (np.asarray(a) * DEG2RAD for a in (lam1, phi1, lam2, phi2))
    dphi = p2 - p1
    dlam = l2 - l1
    h = np.sin(dphi / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dlam / 2) ** 2
    return 2 * EARTH_RADIUS * np.arcsin(np.minimum(np.sqrt(h), 1.0))


def _cap_map(sigma, tau, r_p, lam_p):
    """Inverse bipolar map -> (lam, phi) in degrees.

    Upper half (0 < sigma branch handled by caller via conjugation).
    z = r_p (1 + e^w) / (1 - e^w), w = sigma + i tau.
    """
    w = sigma + 1j * tau
    ew = np.exp(w)
    z = r_p * (1.0 + ew) / (1.0 - ew)
    rho = np.abs(z)
    lam = (np.angle(z) / DEG2RAD + lam_p) % 360.0
    phi = 90.0 - 2.0 * np.arctan(rho) / DEG2RAD
    return lam, phi


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "lam_c", "lam_f", "phi_c", "phi_f", "z_c", "z_f",
        "dz_c", "dz_f",
        "dxc", "dxf", "dyc", "dyf", "azc", "azf",
        "bottom_height",
        "lam2_c", "phi2_c", "phi2_ff",
    ],
    meta_fields=[
        "Nx", "Ny", "Nz", "halo", "x_periodic", "dtype_name", "immersed",
        "north_fold", "pole_index",
    ],
)
@dataclasses.dataclass(frozen=True)
class TripolarGrid:
    """Duck-type compatible with LatitudeLongitudeGrid (same metric names,
    2-D metric arrays; extra 2-D coordinates + fold metadata)."""

    Nx: int
    Ny: int
    Nz: int
    halo: tuple
    x_periodic: bool
    dtype_name: str
    immersed: bool
    north_fold: bool
    pole_index: int  # center index p of the first pole; fold: i <-> (2p - i) mod Nx

    # 1-D nominal coordinates (kept for API parity; cap rows hold nominal values)
    lam_c: jax.Array
    lam_f: jax.Array
    phi_c: jax.Array
    phi_f: jax.Array
    z_c: jax.Array
    z_f: jax.Array
    dz_c: jax.Array
    dz_f: jax.Array

    # 2-D metrics, halo-extended, shaped (Nx+2hx, Ny+2hy, 1)
    dxc: jax.Array
    dxf: jax.Array
    dyc: jax.Array
    dyf: jax.Array
    azc: jax.Array
    azf: jax.Array

    bottom_height: jax.Array  # (Nx, Ny)

    # 2-D true coordinates (interior-only) + corner latitude for Coriolis
    lam2_c: jax.Array  # (Nx, Ny)
    phi2_c: jax.Array  # (Nx, Ny)
    phi2_ff: jax.Array  # (Nx+2hx, Ny+2hy, 1) corner latitude, halo-extended

    # ---- API parity with LatitudeLongitudeGrid ----
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

    def interior(self, ext):
        hx, hy, hz = self.halo
        return ext[hx : hx + self.Nx, hy : hy + self.Ny, hz : hz + self.Nz]

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


def _staggered_coords(Nx, Ny, lat0, phi_p, lam_p_target):
    """Generate (lam, phi) at the 4 horizontal staggered locations on a
    node grid sampled at half-integer resolution: returns arrays of shape
    (2Nx+1, 2Ny+1): index (2i, 2j) = corner (f,f) of cell (i, j)."""
    # snap the pole longitude to a cell center: lam_c(p) = (p + .5) dlam
    dlam = 360.0 / Nx
    p = int(round(lam_p_target / dlam - 0.5)) % Nx
    lam_p = (p + 0.5) * dlam

    # split rows: southern lat-lon band gets a share proportional to its
    # nominal extent; the cap gets the rest, with the last center row on the
    # seam (tau = pi).
    south_extent = phi_p - lat0
    cap_extent = 90.0 - phi_p  # nominal
    n_south = int(round(Ny * south_extent / (south_extent + cap_extent)))
    n_south = min(max(n_south, 1), Ny - 2)
    n_cap = Ny - n_south
    dphi = south_extent / n_south

    # half-index sampling grids
    ii = np.arange(2 * Nx + 1) / 2.0  # in cell units: i_c = i + .5
    jj = np.arange(2 * Ny + 1) / 2.0

    lam = np.empty((2 * Nx + 1, 2 * Ny + 1))
    phi = np.empty((2 * Nx + 1, 2 * Ny + 1))

    lam_nodes = ii * dlam  # face at i -> i*dlam; center -> (i+.5)*dlam
    r_p = np.tan((90.0 - phi_p) * DEG2RAD / 2.0)

    # sigma per x-node from the angular offset to the pole longitude
    theta = (lam_nodes - lam_p) % 360.0  # in (0, 360)
    theta_eff = np.where(theta <= 180.0, theta, 360.0 - theta)
    theta_eff = np.clip(theta_eff, 1e-9, 180.0 - 1e-9)
    sigma = np.log(np.tan(theta_eff * DEG2RAD / 2.0))
    upper = theta <= 180.0

    # tau rows: from pi/2 at the junction FACE (j = n_south) to pi at the
    # last CENTER row (j = Ny - 1 -> jj = Ny - 0.5)
    j_junction = float(n_south)
    j_seam = Ny - 0.5
    dtau = (np.pi - np.pi / 2) / (j_seam - j_junction)

    for col, jval in enumerate(jj):
        if jval <= j_junction + 1e-12:
            lam[:, col] = lam_nodes % 360.0
            phi[:, col] = lat0 + jval * dphi
        else:
            tau = np.pi / 2 + (jval - j_junction) * dtau
            tau = min(tau, np.pi - 1e-12)
            lam_u, phi_u = _cap_map(sigma, tau, r_p, lam_p)
            # lower branch: conjugate symmetry -> mirror longitude about lam_p
            lam_l = (2 * lam_p - lam_u) % 360.0
            lam[:, col] = np.where(upper, lam_u, lam_l)
            phi[:, col] = phi_u
    return lam, phi, p, n_south


def tripolar_grid(
    Nx, Ny, Nz,
    southernmost_latitude=-80.0,
    north_poles_latitude=55.0,
    first_pole_longitude=70.0,
    z_faces=None, depth=4000.0, surface_dz=30.0,
    halo=(4, 4, 4), dtype=jnp.float32,
):
    """Build a TripolarGrid (defaults mirror the reference's TripolarGrid use)."""
    hx, hy, hz = halo
    lam, phi, p, n_south = _staggered_coords(
        Nx, Ny, southernmost_latitude, north_poles_latitude, first_pole_longitude
    )

    # staggered coordinate samples (interior)
    def at(di, dj):
        # di, dj in {0 (face), 1 (center)}; returns (Nx, Ny) or edges padded
        return lam[di::2, dj::2][:Nx, :Ny], phi[di::2, dj::2][:Nx, :Ny]

    lam_ff, phi_ff = at(0, 0)
    lam_cc, phi_cc = at(1, 1)
    lam_fc, phi_fc = at(0, 1)
    lam_cf, phi_cf = at(1, 0)

    # --- metrics by great-circle differences (interior) ---
    def xdiff(lams, phis):
        lam_e = np.concatenate([lams, lams[:1]], axis=0)
        phi_e = np.concatenate([phis, phis[:1]], axis=0)
        return _great_circle(lam_e[:-1], phi_e[:-1], lam_e[1:], phi_e[1:])

    # dxc: cell width at centers = distance between bounding (f,c) nodes
    dxc_i = xdiff(lam_fc, phi_fc)
    # dxf: width along the y-face row = distance between adjacent (f,f) nodes
    dxf_i = xdiff(lam_ff, phi_ff)

    def ydiff(lams, phis, last_row_pad):
        d = _great_circle(lams[:, :-1], phis[:, :-1], lams[:, 1:], phis[:, 1:])
        return np.concatenate([d, last_row_pad * np.ones((Nx, 1))], axis=1)

    # dyc: cell height at centers = distance between bounding (c,f) nodes
    dyc_full = _great_circle(lam_cf[:, :-1], phi_cf[:, :-1], lam_cf[:, 1:], phi_cf[:, 1:])
    dyc_i = np.concatenate([dyc_full, dyc_full[:, -1:]], axis=1)
    # dyf: spacing between (c,c) centers across the y-face
    dyf_full = _great_circle(lam_cc[:, :-1], phi_cc[:, :-1], lam_cc[:, 1:], phi_cc[:, 1:])
    dyf_i = np.concatenate([dyf_full[:, :1], dyf_full], axis=1)

    # Cells touching the two pole singularities degenerate to zero size (grid
    # columns at the pole longitude pass through the poles). Real tripolar
    # configurations bury the poles in land (the reference's gaussian islands
    # sit exactly on them). We (a) floor the metrics at 1e-3 of the largest
    # spacing so divisions stay finite, and (b) mark the degenerate columns
    # as permanent land via the immersed-boundary machinery.
    dx_floor = 1e-3 * dxc_i.max()
    dy_floor = 1e-3 * dyc_i.max()
    degenerate = (dxc_i < dx_floor) | (dyc_i < dy_floor) | (dxf_i < dx_floor) | (dyf_i < dy_floor)
    # pad the land cap by one cell so faces adjacent to a singular cell close
    deg_pad = degenerate.copy()
    deg_pad |= np.roll(degenerate, 1, 0) | np.roll(degenerate, -1, 0)
    deg_pad[:, 1:] |= degenerate[:, :-1]
    deg_pad[:, :-1] |= degenerate[:, 1:]

    dxc_i = np.maximum(dxc_i, dx_floor)
    dxf_i = np.maximum(dxf_i, dx_floor)
    dyc_i = np.maximum(dyc_i, dy_floor)
    dyf_i = np.maximum(dyf_i, dy_floor)

    azc_i = dxc_i * dyc_i
    azf_i = dxf_i * dyf_i

    # --- halo extension: x wrap; y south mirror-values; y north fold-values ---
    def extend_metric(m, yface=False, xface=False):
        # north fold for metric VALUES (no sign), by staggering (the same
        # T-pivot algebra as the DATA fold, grids/tripolar.py::
        # fold_ghosts_north — the pivot is the center of row P = Ny-1):
        #   y-center rows: ghost(i, P+k)  = m(fold(i), P-k)
        #   y-face rows:   ghost(i, Ny-1+k) = m(fold(i), Ny-k)
        #     (ghost face j is the fold image of face 2Ny-1-j; the first
        #      ghost face Ny mirrors face Ny-1 about the pivot center)
        # x mapping: centers fold(i) = (2p - i) mod Nx; x-faces (2p+1 - i).
        fold = np.roll(m[::-1, :], (2 * p + (2 if xface else 1)) % Nx, axis=0)
        if yface:
            north = fold[:, Ny - hy : Ny][:, ::-1]  # faces Ny-1 .. Ny-hy
        else:
            north = fold[:, Ny - 1 - hy : Ny - 1][:, ::-1]  # rows P-1 .. P-hy
        south = m[:, :hy][:, ::-1]
        me = np.concatenate([south, m, north], axis=1) if hy else m
        # x wrap
        return np.concatenate([me[-hx:], me, me[:hx]], axis=0) if hx else me

    # y-staggering per construction above: dxf/dyf/azf live on y-face rows
    # (v-points), phi_ff on corners (x-face AND y-face); the rest at y-centers
    dxc_e = extend_metric(dxc_i)
    dxf_e = extend_metric(dxf_i, yface=True)
    dyc_e = extend_metric(dyc_i)
    dyf_e = extend_metric(dyf_i, yface=True)
    azc_e = extend_metric(azc_i)
    azf_e = extend_metric(azf_i, yface=True)
    phi_ff_e = extend_metric(phi_ff, yface=True, xface=True)

    # --- vertical (same as lat-lon) ---
    if z_faces is None:
        z_faces = (
            uniform_z_faces(Nz, depth)
            if surface_dz is None
            else exponential_z_faces(Nz, depth=depth, h=surface_dz)
        )
    zf = np.asarray(z_faces, np.float64)
    dz_bot = zf[1] - zf[0]
    dz_top = zf[-1] - zf[-2]
    z_f_full = np.concatenate(
        [zf[0] + dz_bot * np.arange(-hz, 0), zf, zf[-1] + dz_top * np.arange(1, hz + 1)]
    )
    z_c_full = 0.5 * (z_f_full[:-1] + z_f_full[1:])
    dz_c = z_f_full[1:] - z_f_full[:-1]
    dz_f = np.empty(Nz + 2 * hz)
    dz_f[1:] = z_c_full[1:] - z_c_full[:-1]
    dz_f[0] = dz_f[1]

    # nominal 1-D coordinates (x: uniform lon; y: nominal row latitude)
    dlam = 360.0 / Nx
    lam_c_1d = np.concatenate(
        [np.arange(-hx, 0), np.arange(Nx), np.arange(Nx, Nx + hx)]
    ) * dlam + 0.5 * dlam
    lam_f_1d = lam_c_1d - 0.5 * dlam
    phi_row = phi_cc.mean(axis=0)  # nominal center latitude per row
    phi_c_1d = np.concatenate(
        [phi_row[:hy][::-1], phi_row, phi_row[-hy:][::-1]]
    )
    phi_f_1d = phi_c_1d  # nominal only

    def col3(a):
        return jnp.asarray(a, dtype)[:, :, None]

    def zrow(a):
        return jnp.asarray(a, dtype).reshape(1, 1, -1)

    # land at the pole singularities (bottom at sea level = dry column)
    bottom = np.where(deg_pad, 0.0, zf[0])

    return TripolarGrid(
        Nx=Nx, Ny=Ny, Nz=Nz, halo=(hx, hy, hz), x_periodic=True,
        dtype_name=jnp.dtype(dtype).name, immersed=True,
        north_fold=True, pole_index=p,
        lam_c=jnp.asarray(lam_c_1d, dtype), lam_f=jnp.asarray(lam_f_1d, dtype),
        phi_c=jnp.asarray(phi_c_1d, dtype), phi_f=jnp.asarray(phi_f_1d, dtype),
        z_c=zrow(z_c_full), z_f=zrow(z_f_full[: Nz + 2 * hz]),
        dz_c=zrow(dz_c), dz_f=zrow(dz_f),
        dxc=col3(dxc_e), dxf=col3(dxf_e), dyc=col3(dyc_e), dyf=col3(dyf_e),
        azc=col3(azc_e), azf=col3(azf_e),
        bottom_height=jnp.asarray(bottom, dtype=dtype),
        lam2_c=jnp.asarray(lam_cc, dtype), phi2_c=jnp.asarray(phi_cc, dtype),
        phi2_ff=col3(phi_ff_e),
    )


# ---------------------------------------------------------------------------
# North-fold halo exchange (single device)
# ---------------------------------------------------------------------------

def _fold_x(a, p, face: bool, axis: int = 0):
    """x-index fold: centers i -> (2p - i) mod Nx; x-faces i -> (2p+1-i) mod Nx.

    ``axis``: which array axis is x (0 for (X, ...) rows; 1 for transposed
    (Z, X) rows from the kernel-layout fast path)."""
    flipped = jnp.flip(a, axis=axis)  # index i -> Nx-1-i
    shift = (2 * p + (2 if face else 1))
    return jnp.roll(flipped, shift, axis=axis)


def fold_ghosts_north(a, h: int, kind: str, p: int):
    """Ghost rows beyond the T-pivot seam (last center row P = Ny-1).

    centers (T, w, eta): ghost(:, P+m) =  T(fold_c, P-m)
    u (x-faces):         ghost(:, P+m) = -u(fold_u, P-m)
    v (y-faces):         ghost(:, P+m) = -v(fold_c, P-m+1)   [face algebra]

    The x-fold runs on the *thin* h-row slab only (slicing commutes with the
    x flip/roll) — folding the full array first costs two full-array HBM
    passes per field per step, ~14 wasted passes on the 7-field climate step.
    """
    Ny = a.shape[1]
    sign = -1.0 if kind in ("u", "v") else 1.0
    face = kind == "u"
    if kind == "v":
        # v ghost face j in [Ny, Ny+h) maps to source face 2Ny-1-j:
        # descending rows Ny-1 .. Ny-h
        thin = a[:, Ny - h : Ny]
    else:
        # centers/u ghost j maps to 2(Ny-1)-j: descending rows Ny-2 .. Ny-1-h
        thin = a[:, Ny - 1 - h : Ny - 1]
    thin = jnp.flip(thin, axis=1)  # ghost row order j = Ny, Ny+1, ...
    return sign * _fold_x(thin, p, face)


def extend_field_tripolar(grid, a, kind: str, hx: int, hy: int):
    """x-wrap + south BC + north-fold extension of an interior field (works
    for both 2-D (Nx, Ny) and 3-D (Nx, Ny, Nz) arrays)."""
    from gb25_tpu.ops.halos import FIELD_BCS, ghost_blocks

    north = fold_ghosts_north(a, hy, kind, grid.pole_index)
    # ONE pad materialization + thin ghost-slab writes (mirrors
    # _extend_3d_fast) instead of three concat chains
    Nx, Ny = a.shape[0], a.shape[1]
    pad = ((hx, hx), (hy, hy)) + ((0, 0),) * (a.ndim - 2)
    e = jnp.pad(a, pad)
    e = e.at[hx : hx + Nx, hy + Ny :].set(north)
    # south boundary (wall, like lat-lon)
    lo, _ = ghost_blocks(a, hy, 1, FIELD_BCS[kind][1][0], "zerograd")
    e = e.at[hx : hx + Nx, :hy].set(lo)
    # x periodic wrap (after the fold so corner halos are consistent)
    e = e.at[:hx].set(e[Nx : hx + Nx])
    e = e.at[hx + Nx :].set(e[hx : 2 * hx])
    return e


def north_fold_projection(grid, u, v, eta, tracers):
    """Enforce the T-pivot self-consistency on the seam row (NEMO lbc_lnk
    analog): the last center row is its own mirror image."""
    p = grid.pole_index
    P = grid.Ny - 1

    # fold the seam ROW only (one (Nx, Nz) slab), not the full array: the
    # x-fold commutes with the row slice, and folding first costs two
    # full-array passes per field
    def sym_center(c):
        row = c[:, P]
        return c.at[:, P].set(0.5 * (row + _fold_x(row, p, face=False)))

    def asym_u(uu):
        row = uu[:, P]
        return uu.at[:, P].set(0.5 * (row - _fold_x(row, p, face=True)))

    u = asym_u(u)
    eta = sym_center(eta)
    tracers = {k: sym_center(c) for k, c in tracers.items()}
    # v's seam face (j = P) pairs with face P+1 on the mirror — both interior
    # representations stay; no pivot-row constraint applies to v itself.
    return u, v, eta, tracers
