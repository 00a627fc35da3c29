"""CATKE closure tests (reference: CATKEVerticalDiffusivity with tracer e,
baroclinic_instability_model.jl:29-30,50-51; less_simple_sharding_problem.jl:90)."""

import jax
import jax.numpy as jnp
import numpy as np

from gb25_tpu.grids import simple_latitude_longitude_grid
from gb25_tpu.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    initial_state,
    loop,
)
from gb25_tpu.models.catke import CATKEVerticalDiffusivity


def _grid():
    return simple_latitude_longitude_grid(16, 12, 10, dtype=jnp.float64)


def test_config_adds_tke_tracer():
    cfg = baroclinic_instability_config(closure=CATKEVerticalDiffusivity())
    assert cfg.tracers == ("T", "S", "e")


def test_catke_runs_stably():
    grid = _grid()
    cfg = baroclinic_instability_config(closure=CATKEVerticalDiffusivity())
    state = baroclinic_instability_state(grid, tracers=cfg.tracers)
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 30)
    assert all(bool(jnp.isfinite(x).all()) for x in jax.tree_util.tree_leaves(s))
    e = np.asarray(s.tracers["e"])
    assert (e >= 0.0).all()


def test_shear_produces_tke_and_mixes():
    """A sheared column produces TKE; an unstable (convective) column mixes
    temperature toward uniformity."""
    grid = _grid()
    cfg = baroclinic_instability_config(
        closure=CATKEVerticalDiffusivity(),
        momentum_advection="none", tracer_advection="none",
    )
    z = grid.z_c_i.reshape(1, 1, -1)
    shape = grid.shape
    # unstable stratification: warm water at the bottom
    T = jnp.broadcast_to(10.0 - 2e-3 * z, shape)
    S = jnp.full(shape, 35.0)
    u = jnp.broadcast_to(0.2 * (1.0 + z / 4000.0) + 0 * z, shape)  # sheared
    state = initial_state(grid, cfg.tracers, jnp.float64).replace(
        u=u, tracers={"T": T, "S": S, "e": jnp.full(shape, 1e-6)}
    )
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 300.0, 50)
    e = np.asarray(s.tracers["e"])
    assert e.max() > 1e-5  # TKE grew from shear + convection
    # convective mixing reduced the vertical T contrast
    T0 = np.asarray(T)
    T1 = np.asarray(s.tracers["T"])
    contrast0 = T0[..., -1].mean() - T0[..., 0].mean()
    contrast1 = T1[..., -1].mean() - T1[..., 0].mean()
    assert abs(contrast1) < abs(contrast0)


def test_stable_column_stays_quiet():
    """Stably stratified, unsheared column: TKE stays at the floor and the
    temperature profile is essentially untouched."""
    grid = _grid()
    cfg = baroclinic_instability_config(
        closure=CATKEVerticalDiffusivity(),
        momentum_advection="none", tracer_advection="none",
    )
    z = grid.z_c_i.reshape(1, 1, -1)
    T = jnp.broadcast_to(10.0 + 2e-3 * z, grid.shape)
    S = jnp.full(grid.shape, 35.0)
    state = initial_state(grid, cfg.tracers, jnp.float64).replace(
        tracers={"T": T, "S": S, "e": jnp.full(grid.shape, 1e-6)}
    )
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 300.0, 50)
    assert float(jnp.abs(s.tracers["T"] - T).max()) < 1e-3
    assert float(s.tracers["e"].max()) < 1e-4


class TestMixedLayerScaling:
    """Validate the CATKE calibration against the physics it targets:
    wind-driven deepening follows the Price /
    Pollard-Rhines-Thompson family h = Ri_c^(1/4) u* sqrt(t/N), convective
    deepening follows the encroachment+entrainment law
    h = sqrt(2(1+2*beta) B0 t)/N. These are scheme-independent ocean
    benchmarks — a closure with wrong magnitudes or signs cannot land in
    the asserted bands."""

    N2 = 1.0e-5

    def _column(self):
        from gb25_tpu.grids import latitude_longitude_grid
        from gb25_tpu.ops.eos import LinearEquationOfState

        grid = latitude_longitude_grid(
            4, 8, 50, latitude=(-2.0, 2.0), longitude=(0.0, 360.0),
            depth=200.0, surface_dz=None, dtype=jnp.float64,
        )
        eos = LinearEquationOfState()
        from gb25_tpu.models.config import ExplicitFreeSurface, HydrostaticConfig

        cfg = HydrostaticConfig(
            tracers=("T", "S", "e"), momentum_advection="none",
            tracer_advection="none", eos=eos,
            free_surface=ExplicitFreeSurface(),
            closure=CATKEVerticalDiffusivity(), coriolis=0.0,
        )
        galpha = eos.g * eos.alpha
        dTdz = self.N2 / galpha
        z = grid.z_c_i.reshape(1, 1, -1)
        T = jnp.broadcast_to(15.0 + dTdz * z, grid.shape)
        state = initial_state(grid, cfg.tracers, jnp.float64).replace(
            tracers={"T": T, "S": jnp.full(grid.shape, 35.0),
                     "e": jnp.full(grid.shape, 1e-6)})
        return grid, cfg, state, galpha

    def _ml_depth(self, grid, T):
        """Mixed-layer base: the deepest level where the local dT/dz has
        collapsed below half the ambient stratification (robust for both the
        sharp wind-mixed interface and the slightly-unstable convective
        boundary layer that threshold criteria misread)."""
        from gb25_tpu.ops.eos import LinearEquationOfState

        eos = LinearEquationOfState()
        ambient = self.N2 / (eos.g * eos.alpha)
        z = np.asarray(grid.z_c_i)
        prof = np.asarray(T)[0, T.shape[1] // 2, :]
        grad = np.diff(prof) / np.diff(z)  # at interior faces, bottom->top
        mixed = np.nonzero(grad < 0.5 * ambient)[0]
        if len(mixed) == 0:
            return 0.0
        return -z[mixed.min()]

    def _run(self, fluxes, hours, dt=600.0):
        from gb25_tpu.models.hydrostatic import time_step

        grid, cfg, state, galpha = self._column()
        step = jax.jit(lambda s: time_step(cfg, grid, s, dt, surface_fluxes=fluxes))
        n = int(hours * 3600 / dt)
        s = state
        for _ in range(n):
            s = step(s)
        assert all(bool(jnp.isfinite(x).all()) for x in jax.tree_util.tree_leaves(s))
        return grid, s, galpha

    def test_wind_mixing_follows_prt_law(self):
        from gb25_tpu.models.catke import surface_tke_flux

        ustar = 0.01  # tau = 0.1 N/m^2
        cl = CATKEVerticalDiffusivity()
        fluxes = {
            "u": jnp.full((4, 8), ustar**2),
            "e": jnp.full((4, 8), float(surface_tke_flux(
                cl, jnp.float64(ustar**2), jnp.float64(0.0)))),
        }
        hours = 12.0
        grid, s, _ = self._run(fluxes, hours)
        h = self._ml_depth(grid, s.tracers["T"])
        N = np.sqrt(self.N2)
        # momentum budget u = u*^2 t / h + bulk-Richardson closure
        # Ri_b = N^2 h^2 / u^2 = Ri_c  =>  h = Ri_c^(1/4) u* sqrt(t/N);
        # Ri_c in [0.25, 1] spans coefficient 0.7-1.0 (PRT 1973 family)
        h_prt = ustar * np.sqrt(hours * 3600.0 / N)
        assert 0.6 * h_prt < h < 1.5 * h_prt, (h, h_prt)
        # the mixed layer is actually mixed: T variance above h/2 is tiny
        z = np.asarray(grid.z_c_i)
        ml = z > -h / 2
        prof = np.asarray(s.tracers["T"])[0, 0, :]
        assert prof[ml].std() < 0.01

    def test_convective_deepening_follows_b0_law(self):
        Q = -500.0  # W/m^2 cooling
        rho0, cp0 = 1020.0, 3991.0
        Tflux = Q / (rho0 * cp0)  # kinematic, positive into the ocean
        fluxes = {"T": jnp.full((4, 8), Tflux)}
        hours = 24.0
        grid, s, galpha = self._run(fluxes, hours)
        B0 = -galpha * Tflux
        h = self._ml_depth(grid, s.tracers["T"])
        beta = 0.2
        h_law = np.sqrt(2.0 * (1.0 + 2.0 * beta) * B0 * hours * 3600.0 / self.N2)
        assert 0.5 * h_law < h < 2.0 * h_law, (h, h_law)
        # TKE is alive in the convective layer, quiet below
        e = np.asarray(s.tracers["e"])[0, 0, :]
        z = np.asarray(grid.z_c_i)
        assert e[z > -h / 2].max() > 1e-5
        assert e[z < -1.8 * h].max() < 1e-5


def test_from_oceananigans_name_mapping():
    """Upstream calibrated digits drop in verbatim via the Julia names
    (ASCII or unicode); unknown parameters fail loudly."""
    c = CATKEVerticalDiffusivity.from_oceananigans(
        Cs=1.131, Cb=0.28, CRi0=0.25, Clo_D=1.18)
    assert c.C_surf == 1.131 and c.C_bot == 0.28
    assert c.Ri_0 == 0.25 and c.C_D_lo == 1.18
    c2 = CATKEVerticalDiffusivity.from_oceananigans(**{"Cˢ": 1.131, "CRiᵟ": 0.5})
    assert c2.C_surf == 1.131 and c2.Ri_delta == 0.5
    import pytest as _pytest
    with _pytest.raises(ValueError, match="no analog"):
        CATKEVerticalDiffusivity.from_oceananigans(Csp=0.14)


def test_column_profile_regression():
    """Golden-profile guard on the CATKE constants:
    combined wind (tau=1e-4 m^2/s^2) + cooling (B0=1e-7 m^2/s^3) column,
    12 h at dt=600 on the N^2=1e-5 stratification. Any change to the
    closure constants or formulation shifts these digits at ~1e-2; the
    physics-law tests above bound the *bands*, this pins the *digits*."""
    import jax

    from gb25_tpu.models.catke import surface_tke_flux
    from gb25_tpu.models.hydrostatic import time_step

    t = TestMixedLayerScaling()
    tau, B0 = 1e-4, 1e-7
    grid, cfg, state, galpha = t._column()
    sh = (grid.Nx, grid.Ny)
    Je = surface_tke_flux(CATKEVerticalDiffusivity(), tau, 0.0)
    fluxes = {"u": jnp.full(sh, tau), "T": jnp.full(sh, -B0 / galpha),
              "e": jnp.full(sh, Je)}
    step = jax.jit(lambda s: time_step(cfg, grid, s, 600.0, surface_fluxes=fluxes))
    s = state
    for _ in range(72):
        s = step(s)
    prof_T = np.asarray(s.tracers["T"])[0, 4, :]
    prof_e = np.asarray(s.tracers["e"])[0, 4, :]
    idx = [49, 45, 40, 35, 30, 20, 10]
    want_T = [14.7871262332, 14.7934685645, 14.7893875891, 14.6604680876,
              14.5237253616, 14.2794819573, 14.035238553]
    want_e = [1.644254e-4, 1.251226e-4, 8.555013e-5, 1.08924e-5, 0.0, 0.0, 0.0]
    np.testing.assert_allclose(prof_T[idx], want_T, atol=5e-7)
    np.testing.assert_allclose(prof_e[idx], want_e, rtol=5e-4, atol=1e-8)
