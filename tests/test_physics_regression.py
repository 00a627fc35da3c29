"""Convention-independent physical regression tests.

These assert *signs of physical responses* rather than comparing against a
re-derived formula, so they catch convention bugs (e.g. an inverted
hydrostatic pressure gradient) that formula-sharing differential tests
cannot: the flow must respond to a buoyancy anomaly the way the ocean does.

Physics being pinned down:
  dp/dz = b with p(surface) = 0  =>  a buoyant (b > 0) column carries LOW
  pressure anomaly at depth, so from rest the deep flow accelerates TOWARD
  the column (gravity-current / lock-exchange direction), and a warm column
  under a thermal EOS behaves identically.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gb25_tpu.grids import latitude_longitude_grid
from gb25_tpu.models import ExplicitFreeSurface, time_step
from gb25_tpu.models.config import HydrostaticConfig
from gb25_tpu.models.state import initial_state
from gb25_tpu.ops.eos import LinearEquationOfState

NX, NY, NZ = 32, 8, 6


def _grid():
    return latitude_longitude_grid(
        NX, NY, NZ, latitude=(-20.0, 20.0), longitude=(0.0, 360.0),
        depth=1000.0, surface_dz=None, dtype=jnp.float64,
    )


def _step_from_rest(cfg, grid, tracers):
    state = initial_state(grid, tuple(tracers.keys()), jnp.float64).replace(
        tracers={k: jnp.asarray(v) for k, v in tracers.items()}
    )
    return jax.jit(time_step)(cfg, grid, state, 60.0)


def _lon_centers(grid):
    return np.asarray(grid.lam_c_i)  # (Nx,) interior cell-center longitudes


def test_deep_flow_converges_toward_buoyant_column():
    """Gaussian b > 0 column (uniform in z) at lon=180: after one Euler step
    from rest, deep u points toward the column on both flanks."""
    grid = _grid()
    cfg = HydrostaticConfig(
        tracers=("b",), momentum_advection="vector_invariant",
        tracer_advection="centered2", free_surface=ExplicitFreeSurface(),
        closure=None, coriolis=0.0,
    )
    lon = _lon_centers(grid)
    b_col = 1e-4 * np.exp(-((lon - 180.0) ** 2) / (2 * 30.0**2))  # (Nx,)
    b0 = np.broadcast_to(b_col[:, None, None], (NX, NY, NZ)).copy()

    s1 = _step_from_rest(cfg, grid, {"b": b0})
    u1 = np.asarray(s1.u)[:, NY // 2, 0]  # deepest level, mid latitude

    east = (lon > 190.0) & (lon < 300.0)   # east flank: flow must be westward
    west = (lon > 60.0) & (lon < 170.0)    # west flank: flow must be eastward
    # u lives at the west face of cell i; the face mask inherits the center
    # mask closely enough for these wide flanks
    assert np.all(u1[east] < 0.0), f"east-flank deep u not converging: {u1[east]}"
    assert np.all(u1[west] > 0.0), f"west-flank deep u not converging: {u1[west]}"
    # and the response is nontrivial
    assert np.max(np.abs(u1)) > 1e-8


def test_warm_column_deep_convergence_linear_eos():
    """Same experiment phrased through the EOS: a warm column is buoyant, so
    the deep flow must converge toward it (catches EOS-side sign errors)."""
    grid = _grid()
    eos = LinearEquationOfState()
    cfg = HydrostaticConfig(
        tracers=("T", "S"), momentum_advection="vector_invariant",
        tracer_advection="centered2", eos=eos,
        free_surface=ExplicitFreeSurface(), closure=None,
        coriolis=0.0,
    )
    lon = _lon_centers(grid)
    warm = 2.0 * np.exp(-((lon - 180.0) ** 2) / (2 * 30.0**2))
    T0 = 10.0 + np.broadcast_to(warm[:, None, None], (NX, NY, NZ)).copy()
    S0 = np.full((NX, NY, NZ), 35.0)

    s1 = _step_from_rest(cfg, grid, {"T": T0, "S": S0})
    u1 = np.asarray(s1.u)[:, NY // 2, 0]

    east = (lon > 190.0) & (lon < 300.0)
    west = (lon > 60.0) & (lon < 170.0)
    assert np.all(u1[east] < 0.0)
    assert np.all(u1[west] > 0.0)


def test_hydrostatic_pressure_convention():
    """p must satisfy dp/dz = b with p ~ 0 at the surface: buoyant column =>
    negative p at depth (direct but formula-light check on the operator)."""
    from gb25_tpu.ops.operators import hydrostatic_pressure

    grid = _grid()
    hz, Nz = grid.hz, grid.Nz
    shape = grid.shape_extended if hasattr(grid, "shape_extended") else None
    b = jnp.ones((NX + 2 * grid.hx, NY + 2 * grid.hy, NZ + 2 * hz), jnp.float64) * 1e-3
    p = hydrostatic_pressure(grid, b)
    p_int = np.asarray(p)[grid.hx + 1, grid.hy + 1, hz : hz + Nz]
    # monotonically increasing upward, negative at depth, ~ -0.5*b*dz at top
    assert np.all(np.diff(p_int) > 0)
    assert p_int[0] < 0
    assert p_int[-1] < 0  # cell-center of top cell is below the surface
    zc = np.asarray(grid.z_c)[0, 0, hz : hz + Nz]
    np.testing.assert_allclose(p_int, 1e-3 * zc, rtol=1e-12)


def test_lock_exchange_thermal_direct_shear():
    """Lock exchange: a warm/cold temperature front must drive a
    thermal-direct circulation — deep flow toward the warm side, sheared
    toward the surface (the verify-skill probe, formula-independent of the
    implementation's pressure convention)."""
    import dataclasses

    import jax

    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import baroclinic_instability_config, time_step
    from gb25_tpu.models.state import initial_state

    grid = simple_latitude_longitude_grid(32, 8, 8, dtype=jnp.float32)
    cfg = baroclinic_instability_config()
    state = initial_state(grid)
    T = np.asarray(state.tracers["T"]).copy()
    T[:] = 10.0
    T[grid.hx : grid.hx + 16] = 2.0  # cold west half
    state = dataclasses.replace(
        state, tracers={**state.tracers, "T": jnp.asarray(T)}
    )
    step = jax.jit(time_step)
    for _ in range(10):
        state = step(cfg, grid, state, 60.0)
    u = np.asarray(state.u)
    ym = u.shape[1] // 2
    i = grid.hx + 16  # face between cold (west) and warm (east)
    shear = u[i, ym, 0] - u[i, ym, -1]  # deep minus surface, +x toward warm
    assert shear > 1e-4, f"thermal-direct shear wrong sign/magnitude: {shear}"
