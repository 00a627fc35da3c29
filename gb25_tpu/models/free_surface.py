"""Free-surface solvers.

Split-explicit barotropic substepping (reference:
``SplitExplicitFreeSurface(substeps=30)``,
/root/reference/src/baroclinic_instability_model.jl:22 and the filtered state
(U, V, eta) it carries, /root/reference/src/correctness.jl:51-58):

The barotropic system
    d eta / d tau = -div(U, V)
    d (U, V) / d tau = -g H grad(eta) + (GU, GV)
is integrated with ``substeps`` forward-backward substeps over the window
[t, t + 2 dt], where (GU, GV) is the depth-integrated AB2-combined baroclinic
tendency. The prognostic free surface and the barotropic part of the updated
velocities are replaced by the time-filtered averages (weights integrate to 1
with centroid at t + dt), following the standard split-explicit design
(Shchepetkin & McWilliams 2005) that Oceananigans implements.

The substeps are unrolled in blocks of the exchange width: each block is a
handful of fused 2-D stencil ops after one width-W halo exchange, so the
whole 30-substep solve stays on device inside the step program.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gb25_tpu.ops.halos import extend_axis
from gb25_tpu.ops.stencils import dx_c, dx_f, dy_c, dy_f, ix_f, iy_f, sm


def averaging_weights(substeps: int, kind: str = "parabolic") -> np.ndarray:
    """Normalized filter weights over the [0, 2 dt] barotropic window."""
    tau = 2.0 * (np.arange(substeps, dtype=np.float64) + 1.0) / substeps
    if kind == "flat":
        w = np.ones(substeps)
    elif kind == "parabolic":
        w = tau * (2.0 - tau)
        w = np.maximum(w, 0.0)
    else:  # pragma: no cover
        raise ValueError(f"unknown averaging kind {kind}")
    return w / w.sum()


from gb25_tpu.ops.halos import extend2 as _extend2_impl


def _extend2(grid, a, kind, comm, h=1):
    return _extend2_impl(grid, a, kind, comm, h)


def _crop2(grid, a, h=1):
    return a[h : h + grid.Nx, h : h + grid.Ny]


def _zint(grid, a):
    """Depth integral of an interior (X, Y, Z) field."""
    hz, Nz = grid.hz, grid.Nz
    return jnp.sum(a * grid.dz_c[:, :, hz : hz + Nz], axis=2)


def _metrics2(grid, h=1):
    """2-D metric slices with halo width h (grid metrics carry width hx/hy).
    Lat-lon metrics are (1, Ny+2hy, 1); tripolar metrics are fully 2-D."""
    hx, hy = grid.hx, grid.hy
    sly = slice(hy - h, hy + grid.Ny + h)

    def sl2(m):
        slx = slice(hx - h, hx + grid.Nx + h) if m.shape[0] > 1 else slice(None)
        return m[slx, sly, 0]

    return sl2(grid.dxc), sl2(grid.dxf), sl2(grid.dyc), sl2(grid.dyf), sl2(grid.azc)


def _metrics2_exchange(grid, comm, W):
    """Width-W 2-D metric planes for W beyond the stored grid halo
    (``exchange_width`` > halo): rebuilt from the interior metrics by the
    same exchange machinery as the fields — interior-seam ghosts are the
    neighbor's true metrics; global-boundary ghosts use zero-gradient
    (y wall) / periodic wrap (x).  Metrics are constant over the solve, so
    under an outer ``fori_loop`` XLA hoists the whole construction out of
    the steady state.  Wall-ghost metric values only influence the in-block
    roundoff drift that every exchange re-zeroes (see ``per_block`` notes);
    x-periodic and shard-interface ghosts are exact."""
    hx, hy = grid.hx, grid.hy

    def ext(m):
        if m.shape[0] == 1:  # thin lat-lon y profile: extend y only
            prof = m[:, hy : hy + grid.Ny, 0]  # (1, Ny)
            if comm is not None:
                return comm.extend_xy(prof, 0, W, ("wrap", "wrap"),
                                      ("zerograd", "zerograd"))
            return extend_axis(prof, W, 1, "zerograd", "zerograd")
        interior = m[hx : hx + grid.Nx, hy : hy + grid.Ny, 0]
        return _extend2_impl(grid, interior, "c", comm, W)

    return (ext(grid.dxc), ext(grid.dxf), ext(grid.dyc), ext(grid.dyf),
            ext(grid.azc))


def barotropic_substep(cfg, grid, state, u_star, v_star, Gu_ab, Gv_ab, dt,
                       comm=None):
    """Run the split-explicit barotropic solve; returns (eta_new, u_new, v_new).

    u_star/v_star: baroclinic AB2-updated velocities (no eta gradient force).
    Gu_ab/Gv_ab:   the AB2-combined tendencies used for that update (interior).

    Latency optimization (SURVEY.md hard part (b)): instead of two width-1
    halo exchanges per substep (2 x 30 rounds of thin ppermutes per model
    step — pure latency at scale), halos of width W (= grid halo) are
    exchanged once per *block*; each forward-backward substep consumes ONE
    ghost ring (the eta and U half-steps are sequentially dependent: eta
    reads U one ring out, then U reads the just-updated eta at its own
    ring), so a block covers W substeps: 30 substeps with W=8 need 4
    exchange rounds instead of 30.  Interior arithmetic is identical up to
    a bounded wall-ghost drift (see per_block below).
    """
    fs = cfg.free_surface
    g = fs.gravitational_acceleration
    M = fs.substeps
    dtau = 2.0 * dt / M
    w_all = averaging_weights(M, fs.averaging)
    dtype = state.eta.dtype

    hz, Nz = grid.hz, grid.Nz
    U0, V0 = _zint(grid, state.u), _zint(grid, state.v)
    GU, GV = _zint(grid, Gu_ab), _zint(grid, Gv_ab)

    # exchange width: the grid halo (or the config's exchange_width — up to
    # `substeps`, making the whole solve ONE blocked solve + ONE
    # exchange round), clamped so strips (width W+1 for the depth field)
    # never exceed the local tile extent on tiny/sliver tiles
    # NOTE: W must be identical in the serial and distributed runs for bitwise
    # agreement (different block widths reassociate the substep arithmetic at
    # the 1e-12 level); on fold grids a sliver tile that cannot source the
    # W+1-wide exchange raises in fold_exchange_strips rather than silently
    # shrinking W locally.
    W_cfg = fs.exchange_width or min(grid.hx, grid.hy)
    W = min(W_cfg, grid.Nx - 1, grid.Ny - 1)
    W = max(W, 1)
    # substeps supported per exchange: each FB substep advances the invalid
    # front by exactly ONE ring (the continuity update at ring r reads U at
    # r+1; the pressure gradient then reads the just-updated eta at its own
    # ring), so a width-W exchange supports W substeps.  The bound is sharp:
    # tests/test_barotropic_kernel.py::test_per_block_width_is_exact proves
    # by NaN-poisoning that a width W-1 halo survives exactly W-1 substeps.
    # Blocked vs exchange-every-substep is NOT bitwise at physical walls:
    # wall ghost rows evolve in-block with their own (latitude-asymmetric)
    # metrics instead of being re-mirrored each substep, a roundoff-scale
    # drift (~1e-9 abs) re-zeroed at every exchange
    # (test_per_block_agrees_with_every_substep); x-periodic and
    # shard-interface ghosts evolve bitwise-exactly.
    # NOTE: serial and distributed runs must use the same value for bitwise
    # agreement; override via GB25_BAROTROPIC_BLOCK for experiments only.
    import os

    per_block = int(os.environ.get("GB25_BAROTROPIC_BLOCK", "0")) or max(W, 1)

    # static column depth at u/v points (linearized free surface) and the
    # barotropic forcing, all extended to width W (constant over the solve)
    if grid.immersed:
        # immersed-aware face depths: the *discrete* fluid depth of the
        # shallower adjacent column (sum of dz over cells above the higher
        # of the two bottoms), so solid faces carry zero depth and the
        # correction divides by exactly the depth the 3-D face mask spans
        # (reference analog: Oceananigans' immersed column_depth at faces)
        bhe = _extend2(grid, grid.bottom_height, "c", comm, h=W + 1)
        zc = grid.z_c[0, 0, hz : hz + Nz]
        dzc = grid.dz_c[0, 0, hz : hz + Nz]

        def face_depth(bf):  # bf: (X, Y) face-max bottom height
            return jnp.sum(
                jnp.where(zc[None, None, :] > bf[:, :, None], dzc[None, None, :], 0.0),
                axis=2,
            ).astype(dtype)

        bu = jnp.maximum(bhe, sm(bhe, "x"))[1:-1, 1:-1]
        bv = jnp.maximum(bhe, sm(bhe, "y"))[1:-1, 1:-1]
        Hu_e = face_depth(bu)  # width W
        Hv_e = face_depth(bv)
        maskU_e = (Hu_e > 0).astype(dtype)
        maskV_e = (Hv_e > 0).astype(dtype)
    else:
        H = -grid.bottom_height  # (Nx, Ny), positive depth
        He = _extend2(grid, H, "c", comm, h=W + 1)
        Hu_e = ix_f(He)[1:-1, 1:-1]  # width W
        Hv_e = iy_f(He)[1:-1, 1:-1]
        maskU_e = maskV_e = None
    GU_e = _extend2(grid, GU, "u", comm, h=W)
    GV_e = _extend2(grid, GV, "v", comm, h=W)
    if maskU_e is not None:
        GU_e = GU_e * maskU_e
        GV_e = GV_e * maskV_e

    if W <= min(grid.hx, grid.hy):
        dxc, dxf, dyc, dyf, azc = _metrics2(grid, h=W)
    else:
        # fold grids included: metrics are orientation-free per-cell
        # scalars, so their fold ghosts are plain fold images — exactly
        # what the "c"-kind fold exchange produces
        dxc, dxf, dyc, dyf, azc = _metrics2_exchange(grid, comm, W)

    def interior(a):
        return a[W:-W, W:-W]

    eta, U, V = state.eta, U0, V0
    eta_b = jnp.zeros_like(state.eta)
    U_b = jnp.zeros_like(U0)
    V_b = jnp.zeros_like(V0)

    m = 0
    while m < M:
        block = min(per_block, M - m)
        eta_e = _extend2(grid, eta, "c", comm, h=W)
        U_e = _extend2(grid, U, "u", comm, h=W)
        V_e = _extend2(grid, V, "v", comm, h=W)
        for j in range(block):
            wm = jnp.asarray(w_all[m + j], dtype)
            div = (dx_c(U_e * dyc) + dy_c(V_e * dxf)) / azc
            eta_e = eta_e - dtau * div
            detax = dx_f(eta_e) / dxc
            detay = dy_f(eta_e) / dyf
            U_e = U_e + dtau * (-g * Hu_e * detax + GU_e)
            V_e = V_e + dtau * (-g * Hv_e * detay + GV_e)
            if maskU_e is not None:
                # no transport through solid faces: the free surface
                # cannot flux mass through coastlines (ADVICE r1 medium)
                U_e = U_e * maskU_e
                V_e = V_e * maskV_e
            eta_b = eta_b + wm * interior(eta_e)
            U_b = U_b + wm * interior(U_e)
            V_b = V_b + wm * interior(V_e)
        eta, U, V = interior(eta_e), interior(U_e), interior(V_e)
        m += block

    # barotropic correction: replace the depth mean of (u*, v*) with the
    # filtered barotropic transport (reference:
    # correct_velocities_and_cache_previous_tendencies!, precompile.jl:41)
    Hu_safe = jnp.maximum(interior(Hu_e), 1e-30)
    Hv_safe = jnp.maximum(interior(Hv_e), 1e-30)
    du = (U_b - _zint(grid, u_star)) / Hu_safe
    dv = (V_b - _zint(grid, v_star)) / Hv_safe
    return eta_b, u_star + du[:, :, None], v_star + dv[:, :, None]


def explicit_eta_tendency(grid, ue, ve):
    """G_eta = -div(U, V) on extended arrays (valid halo shrinks by 1)."""
    hz, Nz = grid.hz, grid.Nz
    dz = grid.dz_c[:, :, hz : hz + Nz]
    U = jnp.sum(ue[:, :, hz : hz + Nz] * dz, axis=2)
    V = jnp.sum(ve[:, :, hz : hz + Nz] * dz, axis=2)
    dyc = grid.dyc[:, :, 0]
    dxf = grid.dxf[:, :, 0]
    azc = grid.azc[:, :, 0]
    return -(dx_c(U * dyc) + dy_c(V * dxf)) / azc
