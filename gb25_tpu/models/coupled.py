"""Coupled ocean-atmosphere model (the reference's OceanSeaIceModel surface).

Reference capability reimplemented: ``data_free_ocean_climate_model_init``
(/root/reference/src/data_free_ocean_climate_model.jl:12-70) —
``ocean_simulation`` defaults (SplitExplicitFreeSurface(substeps=30), CATKE
mixing, dt = 30 s), ``PrescribedAtmosphere`` with analytic wind / shortwave /
air temperature, ``Radiation``, ``SimilarityTheoryFluxes(FixedIterations(5))``,
``ComponentInterfaces`` + ``OceanSeaIceModel``. The sea-ice slot carries
ClimaOcean's constructor default — ``FreezingLimitedOceanTemperature``
(no prognostic ice; seawater is clamped at the salinity-dependent freezing
point and the bulk fluxes see the limited surface temperature).

Each coupled step: (1) time-interp + regrid the atmosphere, (2) solve the
similarity bulk fluxes against the ocean surface state, (3) radiation
balance, (4) deposit kinematic fluxes into the ocean's top cells, (5) ocean
hydrostatic step. Everything is one traced program and shards like the ocean
state.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gb25_tpu.models.catke import CATKEVerticalDiffusivity
from gb25_tpu.models.config import HydrostaticConfig, SplitExplicitFreeSurface, static_pytree
from gb25_tpu.models.fluxes import Radiation, SimilarityTheoryFluxes, radiative_fluxes, similarity_fluxes
from gb25_tpu.models.hydrostatic import time_step
from gb25_tpu.models.seaice import FreezingLimitedOceanTemperature, limit_ocean_temperature
from gb25_tpu.ops.halos import extend2
from gb25_tpu.ops.stencils import i_f, i_c


@static_pytree
@dataclasses.dataclass(frozen=True)
class CoupledConfig:
    ocean: HydrostaticConfig = None
    fluxes: SimilarityTheoryFluxes = SimilarityTheoryFluxes()
    radiation: Radiation = Radiation()
    # ClimaOcean's OceanSeaIceModel default sea-ice component (models/seaice.py):
    # constructing CoupledConfig directly gets the same freezing limiter the
    # reference's constructor default provides; pass sea_ice=None to disable
    sea_ice: "FreezingLimitedOceanTemperature" = FreezingLimitedOceanTemperature()
    rho_ocean: float = 1020.0
    cp_ocean: float = 3991.0
    rho_freshwater: float = 1000.0
    include_currents: bool = True  # wind-relative-to-currents in the bulk solve


def _extend2(grid, a, kind, comm):
    return extend2(grid, a, kind, comm, h=1)


def _crop2(grid, a):
    return a[1 : 1 + grid.Nx, 1 : 1 + grid.Ny]


def compute_interface_fluxes(ccfg: CoupledConfig, grid, atmos, state, comm=None,
                             ice_cover=None, ice_coupling=None):
    """Air-sea fluxes on ocean centers -> kinematic surface fluxes dict.

    ``ice_cover``/``ice_coupling`` (prognostic ``SlabSeaIce`` path): shade
    the open-water fluxes by (1 - a), substitute ice-ocean drag for wind
    stress under the ice fraction, and add the thermodynamic coupling
    fluxes (basal heat extraction, frazil heat, brine/meltwater salt) from
    ``seaice_thermodynamics``."""
    a = atmos.at_time(state.time)
    S_surf = state.tracers["S"][:, :, -1]
    To = state.tracers["T"][:, :, -1]
    if ccfg.sea_ice is not None:
        # the bulk solve sees the freezing-limited surface temperature
        To = ccfg.sea_ice.limit(To, S_surf)
    To_K = To + 273.15

    if ccfg.include_currents:
        u_surf = state.u[:, :, -1]
        v_surf = state.v[:, :, -1]
        uo = _crop2(grid, i_c(_extend2(grid, u_surf, "u", comm), "x"))
        vo = _crop2(grid, i_c(_extend2(grid, v_surf, "v", comm), "y"))
    else:
        uo = jnp.zeros_like(To_K)
        vo = jnp.zeros_like(To_K)

    turb = similarity_fluxes(ccfg.fluxes, a, To_K, uo, vo)
    Q_rad = radiative_fluxes(ccfg.radiation, a, To_K)
    Q_net = Q_rad + turb["Q_sensible"] + turb["Q_latent"]

    rho0, cp0 = ccfg.rho_ocean, ccfg.cp_ocean
    # kinematic fluxes into the top cell (positive into the ocean)
    T_flux = Q_net / (rho0 * cp0)
    E = turb["evaporation"] / ccfg.rho_freshwater  # freshwater volume flux, m/s
    S_flux = S_surf * E  # virtual salinity flux (evap concentrates salt)

    # stress at centers -> velocity points
    taux_c = turb["tau_x"] / rho0
    tauy_c = turb["tau_y"] / rho0

    if ice_cover is not None:
        si = ccfg.sea_ice
        shade = 1.0 - ice_cover
        T_flux = T_flux * shade + ice_coupling["T_flux"]
        S_flux = S_flux * shade + ice_coupling["S_flux"]
        # under the ice fraction the ocean feels free-drift ice-ocean drag
        # (relative velocity = wind_drift_factor * u_a) instead of wind
        wdf2 = si.wind_drift_factor**2
        Ua = jnp.sqrt(a["ua"] ** 2 + a["va"] ** 2)
        taux_c = taux_c * shade + ice_cover * si.ice_ocean_drag * wdf2 * Ua * a["ua"]
        tauy_c = tauy_c * shade + ice_cover * si.ice_ocean_drag * wdf2 * Ua * a["va"]

    taux_u = _crop2(grid, i_f(_extend2(grid, taux_c, "c", comm), "x"))
    tauy_v = _crop2(grid, i_f(_extend2(grid, tauy_c, "c", comm), "y"))

    fluxes = {"u": taux_u, "v": tauy_v, "T": T_flux, "S": S_flux}

    # CATKE surface TKE injection from the friction velocity (the closure's
    # surface boundary condition; see models/catke.py::surface_tke_flux)
    if isinstance(ccfg.ocean.closure, CATKEVerticalDiffusivity):
        from gb25_tpu.models.catke import surface_tke_flux

        fluxes["e"] = surface_tke_flux(ccfg.ocean.closure, taux_c, tauy_c)

    return fluxes, {"Q_net": Q_net, **turb}


def coupled_time_step(ccfg: CoupledConfig, grid, atmos, state, dt, comm=None,
                      premasked=False):
    """One coupled step: interface fluxes, ocean hydrostatic step, then the
    freezing limiter (ClimaOcean: above_freezing_ocean_temperature!).

    ``premasked``: hoisted stage-1 mask (see models.hydrostatic.premask_state)
    — only ``coupled_loop`` sets it."""
    with jax.named_scope("fluxes"):
        fluxes, _ = compute_interface_fluxes(ccfg, grid, atmos, state, comm)
    state = time_step(ccfg.ocean, grid, state, dt, comm, surface_fluxes=fluxes,
                      premasked=premasked)
    return limit_ocean_temperature(ccfg.sea_ice, state)


def coupled_ice_time_step(ccfg, grid, atmos, state, ice, dt, comm=None,
                          restoring=None, premasked=False):
    """One coupled step with the prognostic ``SlabSeaIce`` component:
    ice thermodynamics -> shaded/augmented interface fluxes -> free-drift
    ice advection -> ocean step -> freezing limiter. Returns (state, ice)."""
    from gb25_tpu.models.seaice import seaice_advect, seaice_thermodynamics

    si = ccfg.sea_ice
    af = atmos.at_time(state.time)
    ice_th, coup = seaice_thermodynamics(si, grid, af, state, ice, dt)
    fluxes, _ = compute_interface_fluxes(
        ccfg, grid, atmos, state, comm,
        ice_cover=coup["shade"], ice_coupling=coup)
    ice_new = seaice_advect(si, grid, state, ice_th, af, dt, comm)
    state = time_step(ccfg.ocean, grid, state, dt, comm, surface_fluxes=fluxes,
                      restoring=restoring, premasked=premasked)
    return limit_ocean_temperature(si, state), ice_new


def coupled_ice_loop(ccfg, grid, atmos, state, ice, dt, n, comm=None,
                     restoring=None):
    """n coupled steps carrying (ocean state, sea-ice state); one HLO while."""

    from gb25_tpu.models.hydrostatic import premask_state

    state = premask_state(grid, state, comm)

    def body(_, c):
        s, i = c
        return coupled_ice_time_step(ccfg, grid, atmos, s, i, dt, comm,
                                     restoring=restoring, premasked=True)

    return jax.lax.fori_loop(0, n, body, (state, ice))


def coupled_loop(ccfg, grid, atmos, state, dt, n, comm=None):
    """n coupled steps as one on-device loop."""
    from gb25_tpu.models.hydrostatic import premask_state

    state = premask_state(grid, state, comm)

    def body(_, s):
        return coupled_time_step(ccfg, grid, atmos, s, dt, comm,
                                 premasked=True)

    return jax.lax.fori_loop(0, n, body, state)


def data_free_ocean_climate_model(resolution=2.0, Nz=20, dtype=jnp.float32,
                                  closure="catke", grid_type="gaussian_islands",
                                  sea_ice="freezing_limited"):
    """Reference: data_free_ocean_climate_model_init (resolution=2, Nz=20),
    gaussian-islands bathymetry, analytic atmosphere, CATKE ocean defaults.

    ``grid_type``: "gaussian_islands" (lat-lon band) or
    "gaussian_islands_tripolar" (the reference's actual configuration:
    gaussian_islands_tripolar_grid, model_utils.jl:134-146 — curvilinear
    tripolar grid with the two-island bathymetry and north-fold seam).

    ``sea_ice``: "freezing_limited" (the reference's constructor default) or
    "slab" (prognostic zero-layer thermodynamic ice, models/seaice.py —
    drive with ``coupled_ice_loop`` and an ``initial_ice_state(grid)``)."""
    from gb25_tpu.grids import resolution_to_points, simple_latitude_longitude_grid, tripolar_grid
    from gb25_tpu.grids.immersed import gaussian_islands_bottom
    from gb25_tpu.models.atmosphere import data_free_atmosphere
    from gb25_tpu.models.baroclinic import baroclinic_instability_config, smooth_step
    from gb25_tpu.models.state import initial_state

    Nx, Ny = resolution_to_points(resolution)
    if grid_type == "gaussian_islands_tripolar":
        grid = gaussian_islands_bottom(tripolar_grid(Nx, Ny, Nz, dtype=dtype))
    else:
        grid = simple_latitude_longitude_grid(Nx, Ny, Nz, dtype=dtype)
        if grid_type == "gaussian_islands":
            grid = gaussian_islands_bottom(grid)

    closure_obj = CATKEVerticalDiffusivity() if closure == "catke" else None
    ocean_cfg = baroclinic_instability_config(
        free_surface=SplitExplicitFreeSurface(substeps=30), closure=closure_obj
    )
    if sea_ice == "slab":
        from gb25_tpu.models.seaice import SlabSeaIce

        ice_component = SlabSeaIce()
    else:
        ice_component = FreezingLimitedOceanTemperature()
    ccfg = CoupledConfig(ocean=ocean_cfg, sea_ice=ice_component)

    state = initial_state(grid, ocean_cfg.tracers, dtype)
    if getattr(grid, "phi2_c", None) is not None:
        phi = grid.phi2_c[:, :, None].astype(dtype)  # curvilinear 2-D latitudes
    else:
        phi = grid.phi_c_i.reshape(1, -1, 1).astype(dtype)
    z = grid.z_c_i.reshape(1, 1, -1).astype(dtype)
    # reference T/S init (model_utils.jl:89-97, sans noise)
    T = jnp.broadcast_to((30.0 + 1e-3 * z) * smooth_step(phi), grid.shape)
    S = jnp.broadcast_to(-5e-3 * z + 0.0 * phi, grid.shape)
    tr = dict(state.tracers)
    tr["T"], tr["S"] = T.astype(dtype), S.astype(dtype)
    if "e" in tr:
        tr["e"] = jnp.full(grid.shape, 1e-6, dtype)
    state = state.replace(tracers=tr)

    atmos = data_free_atmosphere(grid, dtype=dtype)
    return ccfg, grid, atmos, state
