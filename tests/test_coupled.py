"""Coupled ocean-atmosphere model tests (reference:
data_free_ocean_climate_model.jl — analytic atmosphere, similarity fluxes,
radiation, coupled stepping)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gb25_tpu.models.atmosphere import data_free_atmosphere, zonal_wind, sunlight
from gb25_tpu.models.coupled import (
    coupled_loop,
    coupled_time_step,
    compute_interface_fluxes,
    data_free_ocean_climate_model,
)
from gb25_tpu.models.fluxes import (
    Radiation,
    SimilarityTheoryFluxes,
    radiative_fluxes,
    saturation_specific_humidity,
    similarity_fluxes,
)


def test_saturation_humidity_physical():
    # ~20 g/kg at 25C, ~3.7 g/kg at 0C over seawater at 1 atm
    q25 = float(saturation_specific_humidity(jnp.float64(298.15), 101325.0))
    q0 = float(saturation_specific_humidity(jnp.float64(273.15), 101325.0))
    assert 0.018 < q25 < 0.021
    assert 0.003 < q0 < 0.005


def test_similarity_fluxes_signs_and_magnitudes():
    cfg = SimilarityTheoryFluxes()
    shape = (4, 4)
    atmos = {
        "ua": jnp.full(shape, 10.0), "va": jnp.zeros(shape),
        "Ta": jnp.full(shape, 283.15), "qa": jnp.full(shape, 0.005),
        "pa": jnp.full(shape, 101325.0),
    }
    To = jnp.full(shape, 288.15)  # ocean 5 K warmer than air
    out = similarity_fluxes(cfg, atmos, To, jnp.zeros(shape), jnp.zeros(shape))
    taux = float(out["tau_x"][0, 0])
    # 10 m/s wind: tau ~ rho Cd U^2 ~ 1.225*1.3e-3*100 ~ 0.16 N/m^2 (unstable: larger)
    assert 0.05 < taux < 0.5
    assert float(out["Q_sensible"][0, 0]) < 0  # ocean warmer -> ocean loses heat
    assert float(out["Q_latent"][0, 0]) < 0    # evaporation cools the ocean
    assert float(out["evaporation"][0, 0]) > 0
    assert np.isfinite(np.asarray(list(out.values()))).all()


def test_similarity_fluxes_zero_wind_zero_stress():
    cfg = SimilarityTheoryFluxes()
    shape = (2, 2)
    atmos = {
        "ua": jnp.zeros(shape), "va": jnp.zeros(shape),
        "Ta": jnp.full(shape, 288.15), "qa": jnp.full(shape, 0.01),
        "pa": jnp.full(shape, 101325.0),
    }
    out = similarity_fluxes(cfg, atmos, jnp.full(shape, 288.15), jnp.zeros(shape), jnp.zeros(shape))
    np.testing.assert_allclose(np.asarray(out["tau_x"]), 0.0, atol=1e-12)


def test_radiation_balance():
    rad = Radiation()
    atmos = {"Qsw": jnp.asarray([[800.0]]), "Qlw": jnp.asarray([[350.0]])}
    q = float(radiative_fluxes(rad, atmos, jnp.asarray([[288.15]]))[0, 0])
    # SW*(1-albedo) + eps*(LW_down - sigma T^4): 776 + 0.97*(350 - 390.1) ~ 737
    assert 700 < q < 780


def test_atmosphere_regrid_and_time_interp():
    from gb25_tpu.grids import simple_latitude_longitude_grid

    grid = simple_latitude_longitude_grid(32, 16, 4, dtype=jnp.float64)
    atmos = data_free_atmosphere(grid, dtype=jnp.float64)
    a = atmos.at_time(jnp.float64(3600.0))
    assert a["Ta"].shape == (32, 16)
    # regridded air temperature tracks 30 cos(phi) + 273.15
    phi = np.asarray(grid.phi_c_i)
    expected = 30.0 * np.cos(np.deg2rad(phi)) + 273.15
    got = np.asarray(a["Ta"])[0]
    np.testing.assert_allclose(got, expected, atol=0.2)
    # wind profile shape
    np.testing.assert_allclose(
        np.asarray(a["ua"])[5], zonal_wind(phi), atol=0.2
    )
    np.testing.assert_allclose(np.asarray(a["Qsw"])[3], sunlight(phi), atol=2.0)


def test_data_free_coupled_model_runs():
    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=8.0, Nz=6, dtype=jnp.float64
    )
    assert grid.immersed
    assert "e" in state.tracers  # CATKE default, like ClimaOcean ocean_simulation
    lp = jax.jit(coupled_loop, static_argnames="n")
    s = lp(ccfg, grid, atmos, state, 600.0, 20)
    leaves = jax.tree_util.tree_leaves(s)
    assert all(bool(jnp.isfinite(x).all()) for x in leaves)
    # wind stress spun up surface currents
    assert float(jnp.abs(s.u[:, :, -1]).max()) > 1e-3
    # fluxes are sane
    fluxes, diag = compute_interface_fluxes(ccfg, grid, atmos, s)
    assert float(jnp.abs(diag["Q_net"]).max()) < 2000.0


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_coupled_sharded_matches_serial():
    from gb25_tpu.parallel import make_mesh, shard_state
    from gb25_tpu.parallel.sharded import sharded_coupled_step_fn

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=12.0, Nz=4, dtype=jnp.float64
    )
    lp = jax.jit(coupled_loop, static_argnames="n")
    s_ref = lp(ccfg, grid, atmos, state, 300.0, 3)

    mesh = make_mesh(4, shape=(2, 2))
    fn = sharded_coupled_step_fn(ccfg, grid, atmos, mesh, n_inner=3)
    s_sh = fn(shard_state(state, mesh), jnp.float64(300.0))
    for xa, xb in zip(jax.tree_util.tree_leaves(s_ref), jax.tree_util.tree_leaves(s_sh)):
        np.testing.assert_allclose(np.asarray(xa), np.asarray(xb), rtol=1e-8, atol=1e-12)


def test_data_free_coupled_tripolar_runs():
    """The reference's actual configuration: gaussian-islands *tripolar* grid
    (model_utils.jl:134-146) under the coupled step (atmosphere regrid onto
    2-D curvilinear coords + fold seam)."""
    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=8.0, Nz=4, dtype=jnp.float64, grid_type="gaussian_islands_tripolar"
    )
    assert grid.north_fold and grid.immersed
    lp = jax.jit(coupled_loop, static_argnames="n")
    s = lp(ccfg, grid, atmos, state, 600.0, 5)
    assert all(bool(jnp.isfinite(x).all()) for x in jax.tree_util.tree_leaves(s))
    # wind stress spun up surface currents somewhere in the fluid
    assert float(jnp.abs(s.u[:, :, -1]).max()) > 1e-4


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_coupled_sharded_tripolar_matches_serial(mesh_shape):
    """The coupled step on a sharded *tripolar* grid
    (fold + atmosphere regrid + immersed islands) must match single-device."""
    from gb25_tpu.parallel import make_mesh, shard_state
    from gb25_tpu.parallel.sharded import sharded_coupled_step_fn

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=8.0, Nz=4, dtype=jnp.float64, grid_type="gaussian_islands_tripolar"
    )
    lp = jax.jit(coupled_loop, static_argnames="n")
    s_ref = lp(ccfg, grid, atmos, state, 300.0, 3)

    mesh = make_mesh(8, shape=mesh_shape)
    fn = sharded_coupled_step_fn(ccfg, grid, atmos, mesh, n_inner=3)
    s_sh = fn(shard_state(state, mesh), jnp.float64(300.0))
    for xa, xb in zip(jax.tree_util.tree_leaves(s_ref), jax.tree_util.tree_leaves(s_sh)):
        np.testing.assert_allclose(np.asarray(xa), np.asarray(xb), rtol=1e-8, atol=1e-12)


def test_freezing_limited_ocean_temperature():
    """ClimaOcean's OceanSeaIceModel constructor default: seawater never
    supercools — T is clamped at the salinity-dependent freezing point each
    coupled step, and the bulk fluxes see the limited SST."""
    import dataclasses

    from gb25_tpu.models.seaice import FreezingLimitedOceanTemperature

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=12.0, Nz=4, dtype=jnp.float64
    )
    assert isinstance(ccfg.sea_ice, FreezingLimitedOceanTemperature)

    # supercool a patch of the surface ocean far below freezing
    T = np.asarray(state.tracers["T"]).copy()
    T[5:10, 3:6, :] = -10.0
    S = np.asarray(state.tracers["S"])
    state = state.replace(tracers={**state.tracers, "T": jnp.asarray(T)})

    s = jax.jit(coupled_time_step)(ccfg, grid, atmos, state, 300.0)
    Tn = np.asarray(s.tracers["T"])
    Tf = -ccfg.sea_ice.liquidus.slope * np.asarray(s.tracers["S"])
    assert (Tn >= Tf - 1e-9).all(), "supercooled water survived the limiter"
    # the clamped patch sits exactly at the freezing point
    np.testing.assert_allclose(Tn[5:10, 3:6, :], Tf[5:10, 3:6, :], atol=1e-6)


def test_atmosphere_pre_regrid_matches_gather_mode():
    """on_ocean_grid pre-regridding (regrid-then-lerp) must reproduce the
    per-step gather path (lerp-then-regrid) — both are linear so they agree
    to rounding; the pre-regridded step just drops ~28 gathers per step."""
    from gb25_tpu.grids import simple_latitude_longitude_grid

    grid = simple_latitude_longitude_grid(64, 32, 4, dtype=jnp.float64)
    gat = data_free_atmosphere(grid, dtype=jnp.float64, pre_regrid=False)
    pre = gat.pre_regrid()
    assert pre.on_ocean_grid and not gat.on_ocean_grid
    for t in (0.0, 3600.0, 5000.0, 86000.0):
        a = gat.at_time(jnp.float64(t))
        b = pre.at_time(jnp.float64(t))
        for k in a:
            assert b[k].shape == (64, 32)
            np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                       rtol=1e-12, atol=1e-12)
