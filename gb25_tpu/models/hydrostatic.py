"""The hydrostatic free-surface model time step (one pure jitted function).

Reimplements the capability of Oceananigans' ``HydrostaticFreeSurfaceModel``
quasi-AB2 step, whose stage decomposition the reference documents at
/root/reference/src/precompile.jl:31-42:

  1. mask immersed fields            -> masking (immersed grids; no-op here)
  2. fill halos of prognostic fields -> functional halo extension
  3. compute auxiliaries             -> w from continuity, buoyancy,
                                        hydrostatic pressure, diffusivities
  4. fill diffusivity halos          -> (local) extension
  5. compute tendencies              -> WENO advection, Coriolis, pressure
  6. ab2_step                        -> quasi-AB2 update (Euler first step)
                                        + split-explicit barotropic substep
  7. fill halos                      -> next step's extension
  8. correct velocities & cache G    -> barotropic correction, G history

The eight stages are one traced function body that XLA compiles into one
program per step (the reference's design: Reactant raises the kernels to
StableHLO and XLA fuses the stencils); the halo extensions are
``lax.ppermute`` exchanges when running under ``shard_map``. Named scopes
("closure", "tendency", "barotropic", "vertical_solve") label the stages in
profiler traces.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gb25_tpu.models.config import (
    ExplicitFreeSurface,
    HydrostaticConfig,
    SplitExplicitFreeSurface,
    VerticalScalarDiffusivity,
)
from gb25_tpu.models.free_surface import barotropic_substep, explicit_eta_tendency
from gb25_tpu.models.state import HydrostaticState
from gb25_tpu.ops.halos import extend_field, extend_field_xy
from gb25_tpu.ops.multifloat import (
    mf_broadcast_to,
    mf_concatenate,
    mf_zeros_like,
    wrap_compute,
)
from gb25_tpu.ops.operators import (
    coriolis_ff,
    diagnose_w,
    hydrostatic_pressure,
    kinetic_energy,
    vertical_vorticity,
)
from gb25_tpu.ops.stencils import (
    dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c,
)
from gb25_tpu.ops.tridiagonal import implicit_vertical_diffusion
from gb25_tpu.ops.weno import centered2, upwind1, weno5_upwind


def mask_v_wall(grid, v, comm=None, total_ny=None):
    """Zero the meridional velocity on the southern wall face (global j = 0).

    v[j] sits on the *south* face of row j, so only global row 0 is a wall;
    the north wall is the virtual face Ny (not stored).

    Single device: a thin in-place row write (a full-array mask multiply
    would cost a whole pass over the field). Distributed: global
    j = y_offset + j_local = 0 requires j_local = 0 (offsets are
    non-negative), so only LOCAL row 0 can ever be the wall — a thin row-0
    multiply by the traced scalar (y_offset != 0).
    """
    if comm is None:
        return v.at[:, 0].set(0.0)
    keep = (comm.y_offset(grid.Ny) != 0).astype(v.dtype)
    return v.at[:, 0].multiply(keep)


def buoyancy_field(cfg, grid, tracers_e):
    """Buoyancy on extended arrays from the configured EOS / tracer set."""
    if "b" in tracers_e:  # direct buoyancy-tracer mode
        return tracers_e["b"]
    return cfg.eos.buoyancy(tracers_e["T"], tracers_e["S"], grid.z_c)


def tendency_math(cfg, grid, f_ff, ue, ve, tr_e):
    """Stages 3+5 physics on halo-extended arrays -> extended tendencies.

    Pure function of extended arrays + (possibly tile-local) grid metrics:
    it runs on whole (local) domains and on the overlap split's windows.
    """
    we = diagnose_w(grid, ue, ve)
    be = buoyancy_field(cfg, grid, tr_e)
    pe = hydrostatic_pressure(grid, be)
    Gu, Gv = momentum_tendency_math(cfg, grid, f_ff, ue, ve, we, pe)
    Gtr = tracer_tendency_math(cfg, grid, ue, ve, we, tr_e)
    return Gu, Gv, Gtr


def momentum_tendency_math(cfg, grid, f_ff, ue, ve, we=None, pe=None, tr_e=None):
    """Momentum tendencies (upwinded vector-invariant + pressure gradient).
    Auxiliaries are recomputed from tr_e when not supplied."""
    eps = cfg.weno_eps
    if we is None:
        we = diagnose_w(grid, ue, ve)
    if pe is None:
        pe = hydrostatic_pressure(grid, buoyancy_field(cfg, grid, tr_e))

    q = mf_broadcast_to(f_ff, ue.shape)
    if cfg.momentum_advection in ("weno_vector_invariant", "vector_invariant"):
        q = q + vertical_vorticity(grid, ue, ve)

    vbar_fc = iy_c(ix_f(ve))  # v interpolated to u-points (f,c)
    ubar_cf = ix_c(iy_f(ue))  # u interpolated to v-points (c,f)

    if cfg.momentum_advection == "weno_vector_invariant":
        q_u = weno5_upwind(q, vbar_fc, "y", align="center", eps=eps)
        q_v = weno5_upwind(q, ubar_cf, "x", align="center", eps=eps)
    else:
        q_u = iy_c(q)
        q_v = ix_c(q)

    Gu = q_u * vbar_fc
    Gv = -q_v * ubar_cf

    # reciprocal metrics (see horizontal_divergence)
    r_dxc = 1.0 / grid.dxc
    r_dyf = 1.0 / grid.dyf
    if cfg.momentum_advection in ("weno_vector_invariant", "vector_invariant"):
        K = kinetic_energy(ue, ve, getattr(cfg, "ke_scheme", "hollingsworth"))
        Gu = Gu - dx_f(K) * r_dxc
        Gv = Gv - dy_f(K) * r_dyf
        # vertical advection in advective form: -w du/dz at velocity points
        r_dz_f = 1.0 / grid.dz_f
        dudz = dz_f(ue) * r_dz_f
        dvdz = dz_f(ve) * r_dz_f
        Gu = Gu - iz_c(ix_f(we) * dudz)
        Gv = Gv - iz_c(iy_f(we) * dvdz)

    # hydrostatic pressure-anomaly gradient
    Gu = Gu - dx_f(pe) * r_dxc
    Gv = Gv - dy_f(pe) * r_dyf
    return Gu, Gv


def tracer_tendency_math(cfg, grid, ue, ve, we=None, tr_e=None):
    """Tracer flux-form advection tendencies (w recomputed if not supplied)."""
    eps = cfg.weno_eps
    if we is None:
        we = diagnose_w(grid, ue, ve)

    r_azc = 1.0 / grid.azc
    r_dz_c = 1.0 / grid.dz_c
    Gtr = {}
    for name, ce in tr_e.items():
        if cfg.tracer_advection == "none":
            Gtr[name] = mf_zeros_like(ce)
            continue
        if cfg.tracer_advection == "weno5":
            cx = weno5_upwind(ce, ue, "x", eps=eps)
            cy = weno5_upwind(ce, ve, "y", eps=eps)
            cz = weno5_upwind(ce, we, "z", eps=eps)
        elif cfg.tracer_advection == "centered2":
            cx, cy, cz = centered2(ce, "x"), centered2(ce, "y"), centered2(ce, "z")
        else:  # upwind1
            cx, cy, cz = upwind1(ce, ue, "x"), upwind1(ce, ve, "y"), upwind1(ce, we, "z")
        Gc = -(dx_c(ue * grid.dyc * cx) + dy_c(ve * grid.dxf * cy)) * r_azc
        Gc = Gc - dz_c(we * cz) * r_dz_c
        Gtr[name] = Gc
    return Gtr


def _grid_window(grid, sx, sy, nxw, nyw):
    """A tile-window view of the grid: metrics sliced to the extended window
    (sx, sy), interior size (nxw, nyw). Only the attributes tendency_math
    touches need to be consistent."""
    import dataclasses

    def sl(m):
        if m.shape[0] == 1:
            return m[:, sy, :]
        return m[sx, sy, :]

    return dataclasses.replace(
        grid, Nx=nxw, Ny=nyw,
        dxc=sl(grid.dxc), dxf=sl(grid.dxf), dyc=sl(grid.dyc), dyf=sl(grid.dyf),
        azc=sl(grid.azc), azf=sl(grid.azf),
    )


def _window_tendency(cfg, grid, f_ff, ue, ve, tr_e, x0, nxw, y0, nyw):
    """Tendencies for the interior window [x0, x0+nxw) x [y0, y0+nyw)
    (interior coordinates) from the minimal extended slice."""
    hx, hy = grid.hx, grid.hy
    sx = slice(x0, x0 + nxw + 2 * hx)
    sy = slice(y0, y0 + nyw + 2 * hy)

    def sub(a):
        return a[sx, sy, :]

    gw = _grid_window(grid, sx, sy, nxw, nyw)
    f_w = f_ff[:, sy, :] if f_ff.shape[0] == 1 else f_ff[sx, sy, :]
    Gu_e, Gv_e, Gtr_e = tendency_math(cfg, gw, f_w, sub(ue), sub(ve),
                                      {k: sub(c) for k, c in tr_e.items()})
    return gw.interior(Gu_e), gw.interior(Gv_e), {k: gw.interior(v) for k, v in Gtr_e.items()}


def split_tendency_math(cfg, grid, f_ff, ue, ve, tr_e, ue_loc, ve_loc, tr_loc):
    """Interior/boundary tendency split for communication overlap.

    Reference analog: Oceananigans' boundary/interior kernel split under
    ``complete_communication_and_compute_buffer!``
    (/root/reference/src/precompile.jl:52-73), ablated by the reference's
    ``optimize_communications`` CompileOption. The *core* region (further
    than one halo width from every tile edge) is computed from the
    local-only extension ``*_loc`` — in the HLO dependency graph it does not
    consume any ``ppermute`` result, so XLA's latency-hiding scheduler is
    free to run it while the halo exchange is in flight. The four boundary
    strips are computed from the exchanged extension and stitched back; the
    stitched result is value-identical to the monolithic computation
    (tests/test_overlap.py asserts both the equality and, by NaN-poisoning
    the exchanged halos, the core's independence).
    """
    hx, hy = grid.hx, grid.hy
    Nx, Ny = grid.Nx, grid.Ny

    core = _window_tendency(cfg, grid, f_ff, ue_loc, ve_loc, tr_loc,
                            hx, Nx - 2 * hx, hy, Ny - 2 * hy)
    west = _window_tendency(cfg, grid, f_ff, ue, ve, tr_e, 0, hx, 0, Ny)
    east = _window_tendency(cfg, grid, f_ff, ue, ve, tr_e, Nx - hx, hx, 0, Ny)
    south = _window_tendency(cfg, grid, f_ff, ue, ve, tr_e, hx, Nx - 2 * hx, 0, hy)
    north = _window_tendency(cfg, grid, f_ff, ue, ve, tr_e, hx, Nx - 2 * hx, Ny - hy, hy)

    def assemble(i):
        mid = mf_concatenate([south[i], core[i], north[i]], axis=1)
        return mf_concatenate([west[i], mid, east[i]], axis=0)

    Gu = assemble(0)
    Gv = assemble(1)
    Gtr = {}
    for k in tr_e:
        mid = mf_concatenate([south[2][k], core[2][k], north[2][k]], axis=1)
        Gtr[k] = mf_concatenate([west[2][k], mid, east[2][k]], axis=0)
    return Gu, Gv, Gtr


def _closure_diffusivities(cfg, grid, ue, ve, tr_e):
    """Stage 3 closure: interior diffusivities for the implicit solves and
    the explicit TKE (and dissipation) sources, or (None, {}) without a
    turbulence closure."""
    from gb25_tpu.models.catke import CATKEVerticalDiffusivity, catke_diffusivities
    from gb25_tpu.models.keps import TKEDissipationVerticalDiffusivity, keps_diffusivities

    if isinstance(cfg.closure, CATKEVerticalDiffusivity):
        be = buoyancy_field(cfg, grid, tr_e)
        ku, kc, ke, G_e, lam_e = catke_diffusivities(
            cfg.closure, grid, ue, ve, be, tr_e["e"])
        diffusivities = {
            "kappa_u": grid.interior(ku), "kappa_c": grid.interior(kc),
            "kappa_e": grid.interior(ke), "lam_e": grid.interior(lam_e),
        }
        return diffusivities, {"e": grid.interior(G_e)}
    if isinstance(cfg.closure, TKEDissipationVerticalDiffusivity):
        be = buoyancy_field(cfg, grid, tr_e)
        ku, kc, ke, keps, G_e, G_eps = keps_diffusivities(
            cfg.closure, grid, ue, ve, be, tr_e["e"], tr_e["eps"])
        diffusivities = {
            "kappa_u": grid.interior(ku), "kappa_c": grid.interior(kc),
            "kappa_e": grid.interior(ke), "kappa_eps": grid.interior(keps),
        }
        return diffusivities, {"e": grid.interior(G_e),
                               "eps": grid.interior(G_eps)}
    return None, {}


def compute_tendencies(cfg, grid, state, comm=None, surface_fluxes=None, restoring=None):
    """Stages 1-5: returns interior tendency arrays (Gu, Gv, Geta, {Gc}) and
    the closure diffusivities (None without a turbulence closure).

    ``surface_fluxes``: optional dict of 2-D (Nx, Ny) kinematic surface fluxes
    {"u", "v", "T", "S", ...} (units: field-units * m/s, positive into the
    ocean) deposited into the top cell — the coupling interface used by the
    ocean-atmosphere model (reference: ComponentInterfaces flux application).

    ``restoring``: optional dict tracer-name -> (target, rate) applying
    G_c += rate * (target - c) (reference: ECCORestoring with polar-tapered
    rate mask, simulations/ocean_climate_simulation.jl:65-72).
    """
    # -- stage 2: halo fill (prognostic) --
    ue = extend_field(grid, state.u, "u", comm)
    ve = extend_field(grid, state.v, "v", comm)
    tr_e = {k: extend_field(grid, c, "c", comm) for k, c in state.tracers.items()}

    # -- stage 1: immersed masking (reference: mask_immersed_model_fields!,
    # precompile.jl:34) — zero face velocities on solid faces so every flux
    # through the bathymetry vanishes --
    if grid.immersed:
        from gb25_tpu.grids.immersed import immersed_masks

        _, u_mask_e, v_mask_e = immersed_masks(grid, comm)
        ue = ue * u_mask_e
        ve = ve * v_mask_e

    dtype = state.u.dtype
    f_ff = coriolis_ff(grid, cfg.coriolis).astype(dtype)

    with jax.named_scope("closure"):
        diffusivities, closure_sources = _closure_diffusivities(
            cfg, grid, ue, ve, tr_e)

    # -- stages 3+5: auxiliaries + tendencies as XLA-fused array ops --
    ue_c, ve_c, tr_c, f_c, grid_c = ue, ve, tr_e, f_ff, grid
    multifloat = cfg.compute_dtype in ("bf16x2", "f32x2")
    if multifloat:
        # two-limb emulated precision (MultiFloatOptions limbs=2 analog,
        # reference arg_parsing.jl:99-107): f32x2 ~ emulated f64 via
        # error-free transforms, bf16x2 ~ paired-bf16 storage limbs
        def wr(x):
            return wrap_compute(x, cfg.compute_dtype)

        ue_c, ve_c, f_c = wr(ue), wr(ve), wr(f_ff)
        tr_c = {k: wr(v) for k, v in tr_e.items()}
        grid_c = jax.tree_util.tree_map(
            lambda x: wr(x) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            grid,
        )
    elif cfg.compute_dtype is not None:
        # precision-lowered tendency computation (MultiFloat analog)
        cdt = jnp.dtype(cfg.compute_dtype)
        ue_c = ue.astype(cdt)
        ve_c = ve.astype(cdt)
        tr_c = {k: v.astype(cdt) for k, v in tr_e.items()}
        f_c = f_ff.astype(cdt)
        grid_c = jax.tree_util.tree_map(
            lambda x: x.astype(cdt) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            grid,
        )

    use_split = (
        cfg.overlap_split
        and comm is not None
        and grid.Nx > 2 * grid.hx
        and grid.Ny > 2 * grid.hy
    )
    with jax.named_scope("tendency"):
        if use_split:
            # comm/compute overlap: core tendencies from a local-only
            # extension (no ppermute in their dependency cone), strips from
            # the exchange
            ue_l = extend_field(grid, state.u, "u", None)
            ve_l = extend_field(grid, state.v, "v", None)
            tr_l = {k: extend_field(grid, c, "c", None)
                    for k, c in state.tracers.items()}
            if grid.immersed:
                from gb25_tpu.grids.immersed import immersed_masks

                _, um_l, vm_l = immersed_masks(grid, None)
                ue_l = ue_l * um_l
                ve_l = ve_l * vm_l
            if multifloat:
                ue_l = wrap_compute(ue_l, cfg.compute_dtype)
                ve_l = wrap_compute(ve_l, cfg.compute_dtype)
                tr_l = {k: wrap_compute(v, cfg.compute_dtype) for k, v in tr_l.items()}
            elif cfg.compute_dtype is not None:
                cdt = jnp.dtype(cfg.compute_dtype)
                ue_l = ue_l.astype(cdt)
                ve_l = ve_l.astype(cdt)
                tr_l = {k: v.astype(cdt) for k, v in tr_l.items()}
            Gu, Gv, Gtr = split_tendency_math(
                cfg, grid_c, f_c, ue_c, ve_c, tr_c, ue_l, ve_l, tr_l
            )
        else:
            Gu_e, Gv_e, Gtr_e = tendency_math(cfg, grid_c, f_c, ue_c, ve_c, tr_c)
            Gu = grid.interior(Gu_e)
            Gv = grid.interior(Gv_e)
            Gtr = {k: grid.interior(v) for k, v in Gtr_e.items()}
    if cfg.compute_dtype is not None:
        Gu = Gu.astype(dtype)
        Gv = Gv.astype(dtype)
        Gtr = {k: v.astype(dtype) for k, v in Gtr.items()}

    # explicit free surface: barotropic pressure gradient in the slow tendency
    if isinstance(cfg.free_surface, ExplicitFreeSurface):
        g = cfg.free_surface.gravitational_acceleration
        hx, hy = grid.hx, grid.hy
        etae = extend_field_xy(grid, state.eta, "c", comm)[:, :, None]
        Gu = Gu + grid.interior(
            jnp.broadcast_to(-g * dx_f(etae) / grid.dxc, ue.shape)
        )
        Gv = Gv + grid.interior(
            jnp.broadcast_to(-g * dy_f(etae) / grid.dyf, ve.shape)
        )
        Geta = explicit_eta_tendency(grid, ue, ve)[hx : hx + grid.Nx, hy : hy + grid.Ny]
    else:
        Geta = jnp.zeros_like(state.eta)

    for name, src in closure_sources.items():
        Gtr[name] = Gtr[name] + src

    if restoring is not None:
        for name, (target, rate) in restoring.items():
            Gtr[name] = Gtr[name] + rate * (target - state.tracers[name])

    if surface_fluxes is not None:
        hz, Nz = grid.hz, grid.Nz
        dz_top = grid.dz_c[0, 0, hz + Nz - 1]
        # each deposit is a plane-indexed update of the top cell (one
        # dynamic-update-slice of a single z plane), not a full-field
        # pad + add that reads and writes the whole 3-D array
        for name, flux in surface_fluxes.items():
            fa = flux / dz_top
            if name == "u":
                Gu = Gu.at[:, :, -1].add(fa)
            elif name == "v":
                Gv = Gv.at[:, :, -1].add(fa)
            else:
                Gtr[name] = Gtr[name].at[:, :, -1].add(fa)

    if grid.immersed:
        # the stored G feeds next step's dt*c2 term: keep it 0 on solid faces
        Gu = Gu * grid.interior(u_mask_e)
        Gv = Gv * grid.interior(v_mask_e)
    # the v surface-flux deposit and the explicit-FS eta gradient can put
    # values on the southern wall row
    Gv = mask_v_wall(grid, Gv, comm)
    return Gu, Gv, Geta, Gtr, diffusivities


def _ab2_coeffs(cfg, state, dtype):
    chi = cfg.chi
    first = (state.iteration == 0)
    c1 = jnp.where(first, 1.0, 1.5 + chi).astype(dtype)
    c2 = jnp.where(first, 0.0, -(0.5 + chi)).astype(dtype)
    return c1, c2


def premask_state(grid, state, comm=None):
    """Apply the stage-1 immersed mask to the prognostic velocities once.

    Loop wrappers call this BEFORE entering the on-device loop and pass
    ``premasked=True`` to every in-loop ``time_step``: the step's own
    epilogue re-masks u/v after the barotropic correction (and after the
    north-fold projection), so "velocities are masked" is a loop invariant
    and the per-iteration stage-1 mask is two redundant full-field passes.
    Masking is idempotent (exact 0/1 multiply), so hoisting it is
    bitwise-neutral."""
    if not grid.immersed:
        return state
    from gb25_tpu.grids.immersed import interior_masks

    u_mask, v_mask = interior_masks(grid, comm)
    return state.replace(u=state.u * u_mask, v=state.v * v_mask)


def _implicit_solves(cfg, grid, diffusivities, u, v, tracers, dt):
    """Stage: vertically-implicit closure. Fields sharing a diffusivity (u
    with v; the tracers without their own) solve together, sharing one
    forward elimination (ops/tridiagonal.py)."""
    hz, Nz = grid.hz, grid.Nz
    dzc = grid.dz_c[:, :, hz : hz + Nz]
    dzf = grid.dz_f[:, :, hz : hz + Nz]
    tracers = dict(tracers)
    if isinstance(cfg.closure, VerticalScalarDiffusivity):
        ku, kc = cfg.closure.nu, cfg.closure.kappa
        special, damping = {}, {}
    else:  # CATKE / k-eps: lagged diffusivities from stage 3
        ku, kc = diffusivities["kappa_u"], diffusivities["kappa_c"]
        special = {k: diffusivities[f"kappa_{k}"] for k in ("e", "eps")
                   if f"kappa_{k}" in diffusivities}
        damping = {"e": diffusivities["lam_e"]} if "lam_e" in diffusivities else {}
    u, v = implicit_vertical_diffusion((u, v), ku, dt, dzc, dzf)
    plain = tuple(k for k in tracers if k not in special)
    if plain:
        sols = implicit_vertical_diffusion(
            tuple(tracers[k] for k in plain), kc, dt, dzc, dzf)
        tracers.update(zip(plain, sols))
    for k, kap in special.items():
        tracers[k] = implicit_vertical_diffusion(
            tracers[k], kap, dt, dzc, dzf, damping=damping.get(k))
    for k in special:
        tracers[k] = jnp.maximum(tracers[k], 0.0)
    return u, v, tracers


def time_step(cfg: HydrostaticConfig, grid, state: HydrostaticState, dt, comm=None,
              surface_fluxes=None, restoring=None, premasked=False):
    """One full quasi-AB2 hydrostatic time step (stages 1-8). Pure function.

    ``premasked``: the caller guarantees the stage-1 immersed mask already
    holds on ``state.u/v`` (see ``premask_state``); only loop wrappers set
    this."""
    dtype = state.u.dtype
    dt = jnp.asarray(dt, dtype)
    if grid.immersed and not premasked:
        # stage 1 masks the *prognostic* velocities, not just the extended
        # tendency inputs (reference: mask_immersed_model_fields!,
        # precompile.jl:34): barotropic_substep depth-integrates state.u/v
        # directly, so an unmasked initial condition (e.g. noise on land)
        # would otherwise flux mass into land columns on the first step
        state = premask_state(grid, state, comm)
    c1, c2 = _ab2_coeffs(cfg, state, dtype)

    Gu, Gv, Geta, Gtr, diffusivities = compute_tendencies(
        cfg, grid, state, comm, surface_fluxes, restoring
    )

    Gu_ab = c1 * Gu + c2 * state.Gu
    Gv_ab = c1 * Gv + c2 * state.Gv
    u_star = state.u + dt * Gu_ab
    v_star = state.v + dt * Gv_ab
    tracers = {k: state.tracers[k] + dt * (c1 * Gtr[k] + c2 * state.Gtracers[k])
               for k in state.tracers}

    if isinstance(cfg.free_surface, SplitExplicitFreeSurface):
        with jax.named_scope("barotropic"):
            eta, u_new, v_new = barotropic_substep(
                cfg, grid, state, u_star, v_star, Gu_ab, Gv_ab, dt, comm)
    else:
        eta = state.eta + dt * (c1 * Geta + c2 * state.Geta)
        u_new, v_new = u_star, v_star

    v_new = mask_v_wall(grid, v_new, comm)

    if getattr(grid, "north_fold", False):
        # enforce the T-pivot seam self-consistency (NEMO lbc_lnk analog)
        if comm is not None:
            from gb25_tpu.parallel.fold import north_fold_projection_dist

            u_new, v_new, eta, tracers = north_fold_projection_dist(
                comm, grid, u_new, v_new, eta, tracers)
        else:
            from gb25_tpu.grids.tripolar import north_fold_projection

            u_new, v_new, eta, tracers = north_fold_projection(
                grid, u_new, v_new, eta, tracers)

    if grid.immersed:
        # re-mask after the barotropic correction touched full columns
        from gb25_tpu.grids.immersed import interior_masks

        u_mask, v_mask = interior_masks(grid, comm)
        u_new = u_new * u_mask
        v_new = v_new * v_mask

    if isinstance(cfg.closure, VerticalScalarDiffusivity) or diffusivities is not None:
        with jax.named_scope("vertical_solve"):
            u_new, v_new, tracers = _implicit_solves(
                cfg, grid, diffusivities, u_new, v_new, tracers, dt)

    from gb25_tpu.models.state import advance_clock

    t_new, t_lo = advance_clock(state.time, state.time_lo, dt)
    return state.replace(
        u=u_new, v=v_new, eta=eta, tracers=tracers,
        Gu=Gu, Gv=Gv, Geta=Geta, Gtracers=Gtr,
        time=t_new, time_lo=t_lo, iteration=state.iteration + 1,
    )


def loop(cfg, grid, state, dt, n, comm=None):
    """n time steps as one on-device loop (reference: GordonBell25.loop!,
    /root/reference/src/timestepping_utils.jl:37-45 — a single HLO while)."""
    state = premask_state(grid, state, comm)

    def body(_, s):
        return time_step(cfg, grid, s, dt, comm, premasked=True)

    return jax.lax.fori_loop(0, n, body, state)
