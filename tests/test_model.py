"""Physics/integration tests for the hydrostatic model (single device).

Adopts the reference's end-to-end quality gates (SURVEY.md section 4):
stability over many steps, tracer-range preservation (WENO), conservation,
and first-step (Euler) vs AB2 behavior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gb25_tpu.grids import simple_latitude_longitude_grid
from gb25_tpu.models import (
    ExplicitFreeSurface,
    SplitExplicitFreeSurface,
    VerticalScalarDiffusivity,
    baroclinic_instability_config,
    baroclinic_instability_state,
    initial_state,
    loop,
    time_step,
)


@pytest.fixture(scope="module")
def small():
    grid = simple_latitude_longitude_grid(24, 12, 6, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid)
    return cfg, grid, state


def test_step_advances_clock(small):
    cfg, grid, state = small
    s = jax.jit(time_step)(cfg, grid, state, 60.0)
    assert int(s.iteration) == 1
    assert float(s.time) == 60.0


def test_all_finite_after_50_steps(small):
    cfg, grid, state = small
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 50)
    for leaf in jax.tree_util.tree_leaves(s):
        assert bool(jnp.isfinite(leaf).all())


def test_tracer_mean_conserved(small):
    """Flux-form advection conserves the tracer volume integral to roundoff
    (up to the linear-free-surface surface flux, which is tiny here)."""
    cfg, grid, state = small
    hy, hz = grid.hy, grid.hz
    vol = grid.azc[:, hy : hy + grid.Ny, :] * grid.dz_c[:, :, hz : hz + grid.Nz]
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 30)
    t0 = float(jnp.sum(state.tracers["S"] * vol))
    t1 = float(jnp.sum(s.tracers["S"] * vol))
    assert abs(t1 - t0) / abs(t0) < 1e-4


def test_v_wall_is_zero(small):
    cfg, grid, state = small
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 10)
    np.testing.assert_allclose(np.asarray(s.v[:, 0, :]), 0.0)


def test_resting_state_stays_resting():
    """No motion, no stratification -> exactly nothing happens."""
    grid = simple_latitude_longitude_grid(16, 8, 4, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    state = initial_state(grid, ("T", "S"), jnp.float64)
    state = state.replace(
        tracers={
            "T": jnp.full(grid.shape, 10.0),
            "S": jnp.full(grid.shape, 35.0),
        }
    )
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 600.0, 5)
    assert float(jnp.abs(s.u).max()) < 1e-12
    assert float(jnp.abs(s.v).max()) < 1e-12
    assert float(jnp.abs(s.eta).max()) < 1e-12


def test_uniform_stratification_neutral():
    """Horizontally-uniform stratification + tiny noise stays tiny over 100
    steps at the reference's operating dt (internal-wave stability)."""
    grid = simple_latitude_longitude_grid(24, 12, 6, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    z = grid.z_c_i.reshape(1, 1, -1)
    T = jnp.broadcast_to(15.0 + 1e-3 * z, grid.shape)
    S = jnp.broadcast_to(35.0 - 5e-4 * z, grid.shape)
    k = jax.random.PRNGKey(1)
    u = 1e-3 * jax.random.normal(k, grid.shape, jnp.float64)
    state = initial_state(grid, ("T", "S"), jnp.float64).replace(
        u=u, tracers={"T": T, "S": S}
    )
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 100)
    assert float(jnp.abs(s.u).max()) < 0.05
    assert float(jnp.abs(s.tracers["T"] - T).max()) < 0.05


def test_explicit_free_surface_gravity_wave():
    """Explicit free surface: an eta bump radiates without blowing up, and
    total eta volume is conserved."""
    grid = simple_latitude_longitude_grid(32, 16, 3, dtype=jnp.float64)
    cfg = baroclinic_instability_config(
        free_surface=ExplicitFreeSurface(), tracer_advection="none",
        momentum_advection="none",
    )
    state = initial_state(grid, ("T", "S"), jnp.float64)
    lam = grid.lam_c_i.reshape(-1, 1)
    phi = grid.phi_c_i.reshape(1, -1)
    eta0 = 0.1 * jnp.exp(-((lam - 180.0) ** 2 + phi**2) / 200.0)
    state = state.replace(
        eta=eta0,
        tracers={"T": jnp.full(grid.shape, 10.0), "S": jnp.full(grid.shape, 35.0)},
    )
    # dt limited by sqrt(gH) ~ 200 m/s; dx_min ~ 240 km -> dt ~ 100 s safe
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 60.0, 100)
    hy = grid.hy
    az = grid.azc[0, hy : hy + grid.Ny, 0]
    v0 = float(jnp.sum(eta0 * az[None, :]))
    v1 = float(jnp.sum(s.eta * az[None, :]))
    assert abs(v1 - v0) < 1e-9 * float(jnp.sum(az)) * 0.1
    assert float(jnp.abs(s.eta).max()) < 0.2
    assert bool(jnp.isfinite(s.u).all())


def test_split_explicit_matches_explicit_short():
    """For a barotropic gravity-wave problem, split-explicit (30 substeps)
    tracks the explicit free surface closely over a short run."""
    grid = simple_latitude_longitude_grid(32, 16, 3, dtype=jnp.float64)
    state = initial_state(grid, ("T", "S"), jnp.float64)
    lam = grid.lam_c_i.reshape(-1, 1)
    phi = grid.phi_c_i.reshape(1, -1)
    eta0 = 0.1 * jnp.exp(-((lam - 180.0) ** 2 + phi**2) / 200.0)
    state = state.replace(
        eta=eta0,
        tracers={"T": jnp.full(grid.shape, 10.0), "S": jnp.full(grid.shape, 35.0)},
    )
    kw = dict(tracer_advection="none", momentum_advection="none")
    cfg_e = baroclinic_instability_config(free_surface=ExplicitFreeSurface(), **kw)
    cfg_s = baroclinic_instability_config(
        free_surface=SplitExplicitFreeSurface(substeps=30), **kw
    )
    dt = 30.0
    se = jax.jit(loop, static_argnames="n")(cfg_e, grid, state, dt, 20)
    ss = jax.jit(loop, static_argnames="n")(cfg_s, grid, state, dt, 20)
    # same wave field to a few percent of the bump amplitude
    err = float(jnp.abs(se.eta - ss.eta).max())
    assert err < 0.02, err


def test_vertical_diffusion_closure():
    """Implicit vertical diffusion smooths a temperature spike stably at
    large dt and conserves the column integral."""
    grid = simple_latitude_longitude_grid(8, 6, 12, dtype=jnp.float64)
    cfg = baroclinic_instability_config(
        closure=VerticalScalarDiffusivity(nu=1e-2, kappa=1e-2),
        tracer_advection="none", momentum_advection="none",
    )
    state = initial_state(grid, ("T", "S"), jnp.float64)
    T = jnp.zeros(grid.shape, jnp.float64).at[:, :, 6].set(1.0)
    state = state.replace(tracers={"T": T, "S": jnp.full(grid.shape, 35.0)})
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 3600.0, 20)
    Tn = s.tracers["T"]
    dz = grid.dz_c[0, 0, grid.hz : grid.hz + grid.Nz]
    col0 = float(jnp.sum(T[0, 0] * dz))
    col1 = float(jnp.sum(Tn[0, 0] * dz))
    assert abs(col1 - col0) / col0 < 1e-12
    assert float(Tn[0, 0, 6]) < 1.0
    assert float(Tn[0, 0, 5]) > 0.0
    assert bool(jnp.isfinite(Tn).all())


def test_baroclinic_instability_develops():
    """The flagship config develops eddy kinetic energy from the unstable
    front (the physics the benchmark is named for) while staying bounded."""
    grid = simple_latitude_longitude_grid(48, 24, 6, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    lp = jax.jit(loop, static_argnames="n")
    s = lp(cfg, grid, state, 300.0, 200)
    ke = float(jnp.mean(s.u**2 + s.v**2) / 2)
    assert np.isfinite(ke)
    assert ke > 1e-6  # flow spun up from the front
    assert float(jnp.abs(s.u).max()) < 10.0  # ... but physically bounded


def test_loop_equals_repeated_steps(small):
    """The fused on-device loop and repeated single steps agree to a few ulp.

    XLA compiles ``step`` and ``loop`` as separate programs and is free to
    fuse/reassociate elementwise chains differently between them, so bitwise
    equality is not guaranteed — but any drift beyond a couple of ulp per
    step would indicate a real divergence (e.g. state-dependent control
    flow), which is what this guards against."""
    cfg, grid, state = small
    step = jax.jit(time_step)
    s1 = state
    for _ in range(4):
        s1 = step(cfg, grid, s1, 120.0)
    s2 = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 4)
    for a, b in zip(jax.tree_util.tree_leaves(s1), jax.tree_util.tree_leaves(s2)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
        else:
            np.testing.assert_array_equal(a, b)


def test_dynamic_dt_no_recompile(small):
    """dt is a traced value (reference traces Δt dynamically,
    timestepping_utils.jl:31): different dt must not retrigger compilation."""
    cfg, grid, state = small
    step = jax.jit(time_step)
    s1 = step(cfg, grid, state, 60.0)
    n0 = step._cache_size()
    s2 = step(cfg, grid, state, 120.0)
    assert step._cache_size() == n0
    assert float(s2.time) == 120.0


def test_buoyancy_tracer_mode():
    """Direct buoyancy-tracer configuration (reference: BuoyancyTracer ->
    tracers=(:b,), baroclinic_instability_model.jl:42-43)."""
    from gb25_tpu.models.config import HydrostaticConfig, SplitExplicitFreeSurface

    grid = simple_latitude_longitude_grid(16, 8, 4, dtype=jnp.float64)
    cfg = HydrostaticConfig(
        tracers=("b",), free_surface=SplitExplicitFreeSurface(substeps=10)
    )
    z = grid.z_c_i.reshape(1, 1, -1)
    b = jnp.broadcast_to(4e-6 * z + 0 * z, grid.shape)
    state = initial_state(grid, ("b",), jnp.float64).replace(tracers={"b": b})
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 10)
    assert all(bool(jnp.isfinite(x).all()) for x in jax.tree_util.tree_leaves(s))


def test_compensated_clock_does_not_absorb_increments():
    """ADVICE r1 (low): an f32 clock at ~1e7 s must still advance by 30 s
    per step (plain f32 accumulation rounds/absorbs the increment)."""
    from gb25_tpu.models.state import advance_clock

    hi = jnp.asarray(2.0**27, jnp.float32)  # ~4.3 sim-years in seconds: ulp = 16 s
    lo = jnp.asarray(0.0, jnp.float32)
    dt = jnp.asarray(30.0, jnp.float32)
    n = 1000
    f = jax.jit(lambda hi, lo: advance_clock(hi, lo, dt))
    plain = hi
    for _ in range(n):
        hi, lo = f(hi, lo)
        plain = plain + dt
    exact = 2.0**27 + 30.0 * n
    err_kahan = abs(float(hi) + float(lo) - exact)
    err_plain = abs(float(plain) - exact)
    assert err_kahan <= 16.0, err_kahan         # within one ulp of the total
    assert err_plain > 1000.0, err_plain        # plain f32: 30 s rounds to 32 s/step


def test_balanced_jet_reduces_adjustment_transient():
    """The thermal-wind-balanced jet
    initializer must start far closer to geostrophic balance than the
    reference's unbalanced T/S front — the 12-step drift of u and eta
    (the geostrophic-adjustment signature whose w-CFL clamped the
    1/4-degree eddy probe's dt) drops by well over 2x.  Exact discrete
    balance is not expected: the initializer integrates the continuum
    thermal-wind relation, not the C-grid stencils."""
    import jax

    from gb25_tpu.models import loop
    from gb25_tpu.models.baroclinic import balanced_jet_state

    grid = simple_latitude_longitude_grid(96, 44, 6, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    lp = jax.jit(loop, static_argnames="n")

    def drift(st):
        s = lp(cfg, grid, st, 600.0, 12)
        return (float(jnp.abs(s.u - st.u).max()),
                float(jnp.abs(s.eta - st.eta).max()))

    du_f, deta_f = drift(baroclinic_instability_state(
        grid, noise_velocity=0.0, dtype=jnp.float64))
    bal = balanced_jet_state(grid, cfg, noise_velocity=0.0, dtype=jnp.float64)
    assert float(jnp.abs(bal.u).max()) > 0.5  # a real jet, not a no-op
    du_b, deta_b = drift(bal)
    assert du_b < 0.5 * du_f, (du_b, du_f)
    assert deta_b < 0.5 * deta_f, (deta_b, deta_f)
