"""Finite-volume operators on the staggered C grid (halo-extended arrays).

These implement the discrete operators the reference gets from Oceananigans:
horizontal divergence, vertical vorticity, continuity (diagnostic w),
hydrostatic pressure integral, kinetic energy — all as shape-preserving
element-wise/shift arithmetic that XLA fuses.

All inputs/outputs are halo-extended arrays; each operator consumes one cell
of halo validity per difference/interpolation.
"""

from __future__ import annotations

import jax.numpy as jnp

from gb25_tpu.ops.multifloat import (
    mf_concatenate,
    mf_cumsum,
    mf_sum,
    mf_zeros_like,
)
from gb25_tpu.ops.stencils import dx_c, dx_f, dy_c, dy_f, ix_c, iy_c, sm, sp


def horizontal_divergence(grid, u, v):
    """del_h . (u, v) at cell centers: (dx_c(u dy) + dy_c(v dx)) / Az.

    With depth-independent cell thickness the dz factors cancel, so this is
    the per-layer horizontal divergence used by continuity and the free
    surface. u at (f,c), v at (c,f); dy at u-points is ``dyc``, dx at
    v-points is ``dxf``.

    Metric divisions are written as reciprocal multiplies throughout the
    tendency cone: the reciprocal of a metric is a thin (1, Ny, 1) or 2-D
    array, so the full-field work is a multiply, not a divide.
    """
    return (dx_c(u * grid.dyc) + dy_c(v * grid.dxf)) * (1.0 / grid.azc)


def vertical_vorticity(grid, u, v):
    """zeta at corners (f,f): circulation / corner area.

    zeta = (dx_f(v dyf) - dy_f(u dxc)) / azf. Free-slip walls give exactly
    zero wall circulation thanks to mirrored ghost u and mirrored metrics.
    """
    return (dx_f(v * grid.dyf) - dy_f(u * grid.dxc)) * (1.0 / grid.azf)


def kinetic_energy(u, v, scheme: str = "hollingsworth"):
    """K at cell centers for the vector-invariant Bernoulli gradient.

    "standard": K = (ℑx(u²) + ℑy(v²))/2 — the plain C-grid form.  At
    eddy-resolving resolution this form is known to excite the
    Hollingsworth instability (Hollingsworth et al. 1983 QJRMS): the
    discrete ∇K is inconsistent with the vorticity-flux coupling across
    the transverse direction, pumping a spurious bottom-intensified mode
    at fronts over long integrations.

    "hollingsworth" (default): the NEMO-style corrected KE
        K = 2/3 K_standard + 1/3 K_bar,
        K_bar = (ℑx(ū²) + ℑy(v̄²))/2,   ū = (u_{j-1}+u_{j+1})/2,
                                         v̄ = (v_{i-1}+v_{i+1})/2
    (one third of the squared velocities replaced by squares of the
    transverse two-point averages; exact for uniform flow — verified —
    2nd-order on smooth fields, and restores the ∇K/vorticity-flux
    compatibility).  The reference stack cures the same instability
    inside Oceananigans' WENOVectorInvariant by self-upwinding the KE
    gradient (Silvestri et al. 2024); the Hollingsworth correction is a
    cheaper equivalent — a pure stencil, no extra WENO reconstructions —
    adopted as the production default for the same robustness reason.

    Honesty note (round 4): a fast 1/4-degree blow-up initially blamed on
    Hollingsworth turned out to be the vertical-advection CFL of the
    geostrophic-adjustment transient of the probe's unbalanced (u = 0)
    front initialization — w reaches ~0.5 m/s against 30 m surface cells,
    so dt must satisfy the transient's w-CFL (dt <= ~60 s at 1/4 degree)
    or the run must start balanced; the corrected KE neither caused nor
    cured that (scripts/probes/eddy_statistics.py notes)."""
    Ks = 0.5 * (ix_c(u * u) + iy_c(v * v))
    if scheme == "standard":
        return Ks
    ubar = 0.5 * (sp(u, "y") + sm(u, "y"))
    vbar = 0.5 * (sp(v, "x") + sm(v, "x"))
    Kb = 0.5 * (ix_c(ubar * ubar) + iy_c(vbar * vbar))
    third = 1.0 / 3.0
    return (2.0 * third) * Ks + third * Kb


def _zcumsum(a):
    """Inclusive cumulative sum along z."""
    return mf_cumsum(a, axis=2)


def diagnose_w(grid, u, v):
    """Vertical velocity at z-faces from continuity: dw/dz = -del_h.(u,v).

    Integrates upward from w = 0 at the sea floor. Input u, v are extended
    arrays; the returned w is an extended array whose z-ghosts are zero below
    the bottom and zero-gradient above the surface; horizontal halo validity
    shrinks by one cell.
    """
    hz, Nz = grid.hz, grid.Nz
    div = horizontal_divergence(grid, u, v)  # extended; z-ghosts garbage
    div_int = div[:, :, hz : hz + Nz] * grid.dz_c[:, :, hz : hz + Nz]
    # w at bottom face of interior cell k: -(sum of div*dz below k)
    wcum = _zcumsum(div_int)
    w_int = mf_concatenate([mf_zeros_like(wcum[:, :, :1]), -wcum[:, :, :-1]], axis=2)
    w_top = -wcum[:, :, -1:]  # w at the surface face (= d(eta)/dt forcing)
    # re-extend in z: zeros below bottom; surface value then zero-gradient above
    below = [mf_zeros_like(w_int[:, :, :1])] * hz
    above = [w_top] * hz
    return mf_concatenate(below + [w_int] + above, axis=2)


def hydrostatic_pressure(grid, b):
    """Hydrostatic pressure anomaly (p/rho0, m^2/s^2) at cell centers.

    Hydrostatic balance dp/dz = b integrated down from p(surface) = 0:
    p(z_c[k]) = -integral_z^0 b dz' = -(sum_{k'>k} b[k'] dz_c[k'] +
    0.5 b[k] dz_c[k]), so a buoyant column carries LOW pressure at depth
    (deep flow converges under buoyant anomalies; thermal wind upright).
    The momentum tendency then applies Gu -= dx(p). The free-surface
    contribution g*eta is handled by the free-surface solver, not here
    (split-explicit: reference src/baroclinic_instability_model.jl:22).
    """
    hz, Nz = grid.hz, grid.Nz
    bdz = b[:, :, hz : hz + Nz] * grid.dz_c[:, :, hz : hz + Nz]
    # negated reversed cumulative sum excluding own layer + half own layer
    total = mf_sum(bdz, axis=2, keepdims=True)
    csum = _zcumsum(bdz)
    p_int = csum - total - 0.5 * bdz
    below = [p_int[:, :, :1]] * hz
    above = [p_int[:, :, -1:]] * hz
    return mf_concatenate(below + [p_int] + above, axis=2)


def barotropic_transport(grid, u, v):
    """Depth-integrated transports U = int u dz, V = int v dz (extended xy)."""
    hz, Nz = grid.hz, grid.Nz
    dz = grid.dz_c[:, :, hz : hz + Nz]
    U = jnp.sum(u[:, :, hz : hz + Nz] * dz, axis=2)
    V = jnp.sum(v[:, :, hz : hz + Nz] * dz, axis=2)
    return U, V


def coriolis_ff(grid, omega):
    """Planetary vorticity f = 2 Omega sin(phi) at corner points (f,f).

    Lat-lon grids carry 1-D face latitudes; curvilinear (tripolar) grids
    provide the 2-D corner latitude ``phi2_ff`` (already halo-extended)."""
    phi2 = getattr(grid, "phi2_ff", None)
    if phi2 is not None:
        return (2.0 * omega * jnp.sin(jnp.deg2rad(phi2))).astype(grid.dtype)
    f = 2.0 * omega * jnp.sin(jnp.deg2rad(grid.phi_f))
    return f.reshape(1, -1, 1).astype(grid.dtype)
