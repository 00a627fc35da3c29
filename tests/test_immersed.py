"""Immersed-bathymetry tests (reference: gaussian_islands ImmersedBoundaryGrid,
model_utils.jl:134-146)."""

import jax
import jax.numpy as jnp
import numpy as np

from gb25_tpu.grids import simple_latitude_longitude_grid
from gb25_tpu.grids.immersed import gaussian_islands_bottom, interior_masks, with_bathymetry
from gb25_tpu.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    loop,
)


def test_gaussian_islands_bathymetry():
    grid = gaussian_islands_bottom(simple_latitude_longitude_grid(48, 24, 8, dtype=jnp.float64))
    assert grid.immersed
    bh = np.asarray(grid.bottom_height)
    # islands rise near sea level around (70E, 55N) and (250E, 55N)
    assert bh.max() > -300.0
    assert bh.min() == float(grid.z_f_i[0])
    i, j = np.unravel_index(bh.argmax(), bh.shape)
    assert abs(float(grid.lam_c_i[i]) - 70) < 10 or abs(float(grid.lam_c_i[i]) - 250) < 10
    assert abs(float(grid.phi_c_i[j]) - 55) < 10
    u_mask, v_mask = (np.asarray(m) for m in interior_masks(grid))
    assert u_mask.min() == 0.0 and u_mask.max() == 1.0


def test_immersed_model_runs_and_freezes_solid_tracers():
    grid = gaussian_islands_bottom(simple_latitude_longitude_grid(48, 24, 8, dtype=jnp.float64))
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    s = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 20)
    assert all(bool(jnp.isfinite(x).all()) for x in jax.tree_util.tree_leaves(s))

    # velocities vanish on solid faces
    u_mask, v_mask = interior_masks(grid)
    np.testing.assert_allclose(np.asarray(s.u * (1 - u_mask)), 0.0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(s.v * (1 - v_mask)), 0.0, atol=1e-14)

    # tracer values inside the bathymetry are frozen (no flux divergence)
    from gb25_tpu.grids.immersed import immersed_masks

    c_mask = grid.interior(immersed_masks(grid)[0])
    solid = np.asarray(c_mask) == 0.0
    assert solid.any()
    T0 = np.asarray(state.tracers["T"])
    T1 = np.asarray(s.tracers["T"])
    np.testing.assert_allclose(T1[solid], T0[solid], rtol=0, atol=1e-12)


def test_flat_bottom_bathymetry_matches_plain_grid():
    """A bathymetry at full depth must reproduce the non-immersed model."""
    plain = simple_latitude_longitude_grid(24, 12, 6, dtype=jnp.float64)
    flat = with_bathymetry(plain, jnp.full((24, 12), float(plain.z_f_i[0])))
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(plain)
    lp = jax.jit(loop, static_argnames="n")
    sa = lp(cfg, plain, state, 120.0, 5)
    sb = lp(cfg, flat, state, 120.0, 5)
    for a, b in zip(jax.tree_util.tree_leaves(sa), jax.tree_util.tree_leaves(sb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-15)


def test_split_explicit_does_not_flux_through_coastlines():
    """ADVICE r1 (medium): the barotropic substeps must not push mass through
    solid faces — eta inside land columns stays exactly zero and the total
    fluid volume (sum eta * Az) is conserved by the substep divergence form."""
    from gb25_tpu.grids import latitude_longitude_grid
    from gb25_tpu.models import time_step
    from gb25_tpu.models.config import HydrostaticConfig, SplitExplicitFreeSurface
    from gb25_tpu.models.state import initial_state
    from gb25_tpu.ops.eos import LinearEquationOfState

    NX, NY, NZ = 24, 16, 6
    grid = latitude_longitude_grid(
        NX, NY, NZ, latitude=(-40.0, 40.0), longitude=(0.0, 360.0),
        depth=1000.0, surface_dz=None, dtype=jnp.float64,
    )
    bottom = np.full((NX, NY), -1000.0)
    bottom[10:14, 6:10] = 0.0  # rectangular island
    bottom[2:4, 11:13] = -100.0  # a shoal (partial column)
    grid = with_bathymetry(grid, bottom)
    land = bottom >= 0.0

    cfg = HydrostaticConfig(
        tracers=("T", "S"), momentum_advection="vector_invariant",
        tracer_advection="centered2", eos=LinearEquationOfState(),
        free_surface=SplitExplicitFreeSurface(substeps=10),
        closure=None,
    )
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal((NX, NY, NZ)) * 1e-2
    v0 = rng.standard_normal((NX, NY, NZ)) * 1e-2
    v0[:, 0, :] = 0.0
    u_mask, v_mask = (np.asarray(m) for m in interior_masks(grid))
    state = initial_state(grid, ("T", "S"), jnp.float64).replace(
        u=jnp.asarray(u0 * u_mask), v=jnp.asarray(v0 * v_mask),
        tracers={"T": jnp.full((NX, NY, NZ), 10.0), "S": jnp.full((NX, NY, NZ), 35.0)},
    )

    az = np.asarray(grid.azc)[:, grid.hy : grid.hy + NY, 0]  # (1 or Nx, Ny)
    az = np.broadcast_to(az, (NX, NY))

    s = state
    for _ in range(3):
        s = jax.jit(time_step)(cfg, grid, s, 60.0)
        eta = np.asarray(s.eta)
        # no mass appears inside land columns
        np.testing.assert_allclose(eta[land], 0.0, atol=1e-15)
        # global volume conservation of the free surface
        assert abs(float((eta * az).sum())) < 1e-6 * float(az.mean())


def test_unmasked_initial_velocities_do_not_leak_eta_onto_land():
    """The step masks the *prognostic* velocities itself (reference:
    mask_immersed_model_fields!, precompile.jl:34) — an initial condition
    with noise on land (e.g. baroclinic_instability_state, which seeds
    noise everywhere) must not flux mass into land columns on step 1."""
    from gb25_tpu.grids.immersed import immersed_masks
    from gb25_tpu.models import time_step

    grid = simple_latitude_longitude_grid(48, 24, 8, dtype=jnp.float64)
    bottom = np.full((48, 24), -4000.0)
    bottom[20:26, 10:14] = 0.0  # rectangular island
    grid = with_bathymetry(grid, bottom)

    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid)  # noise on land NOT masked
    assert float(np.abs(np.asarray(state.u)).max()) > 0.0

    s = state
    step = jax.jit(time_step)
    for _ in range(3):
        s = step(cfg, grid, s, 60.0)

    land = np.asarray(grid.interior(immersed_masks(grid)[0]))[:, :, -1] == 0
    assert land.sum() == 24
    eta = np.asarray(s.eta)
    np.testing.assert_array_equal(eta[land], 0.0)
