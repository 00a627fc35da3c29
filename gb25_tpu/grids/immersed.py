"""Immersed bathymetry (grid-fitted bottom).

Reference behavior reimplemented: ``ImmersedBoundaryGrid(grid,
GridFittedBottom(bottom))`` with the two-Gaussian-island bathymetry
(/root/reference/src/model_utils.jl:67-80,134-146) and the per-step
``mask_immersed_model_fields!`` stage (/root/reference/src/precompile.jl:34).

Design: no active-cells map (the reference also runs ``active_cells_map =
false``); cells are masked by comparing cell-center height to the local
bottom height. Face velocities on solid faces are zeroed, which makes every
advective/pressure flux through solid faces vanish; solid-cell tracers are
frozen (zero flux divergence). Masks are recomputed on the fly from the 2-D
``bottom_height`` — a fused compare against z, cheaper in HBM traffic than
storing 3-D mask arrays in HBM.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from gb25_tpu.ops.halos import extend_field_xy
from gb25_tpu.ops.stencils import sm


def with_bathymetry(grid, bottom_height):
    """Return a copy of ``grid`` carrying ``bottom_height(x, y)`` (meters,
    negative) clamped to the grid's depth range; marks the grid immersed."""
    bh = jnp.asarray(bottom_height, dtype=grid.dtype)
    assert bh.shape == (grid.Nx, grid.Ny)
    zbot = float(grid.z_f_i[0])
    bh = jnp.clip(bh, zbot, 0.0)
    if grid.immersed:
        # preserve pre-existing land (e.g. tripolar pole caps)
        bh = jnp.maximum(bh, grid.bottom_height)
    return dataclasses.replace(grid, bottom_height=bh, immersed=True)


def gaussian_islands_bottom(grid):
    """The reference's two Gaussian islands (model_utils.jl:67-80,139-141):
    bottom = zb + h * (mtn1 + mtn2), zb = deepest z face, h = -zb + 100."""
    if getattr(grid, "lam2_c", None) is not None:
        lam = np.asarray(grid.lam2_c)
        phi = np.asarray(grid.phi2_c)
    else:
        lam = np.asarray(grid.lam_c_i)[:, None]
        phi = np.asarray(grid.phi_c_i)[None, :]
    zb = float(grid.z_f_i[0])
    h = -zb + 100.0

    def mtn(lam0, phi0, dphi=5.0):
        return np.exp(-((lam - lam0) ** 2 + (phi - phi0) ** 2) / (2 * dphi**2))

    bottom = zb + h * (mtn(70.0, 55.0) + mtn(250.0, 55.0))
    return with_bathymetry(grid, bottom)


def immersed_masks(grid, comm=None):
    """(c_mask, u_mask, v_mask) on extended arrays (1 = fluid, 0 = solid)."""
    be = extend_field_xy(grid, grid.bottom_height, "c", comm)[:, :, None]
    zc = grid.z_c  # (1, 1, Nz+2hz)
    c_mask = (zc > be).astype(grid.dtype)
    u_mask = (zc > jnp.maximum(be, sm(be, "x"))).astype(grid.dtype)
    v_mask = (zc > jnp.maximum(be, sm(be, "y"))).astype(grid.dtype)
    return c_mask, u_mask, v_mask


def interior_masks(grid, comm=None):
    """(u_mask, v_mask) cropped to the interior, for masking updates."""
    c, u, v = immersed_masks(grid, comm)
    return grid.interior(u), grid.interior(v)
