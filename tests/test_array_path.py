"""Two runs of the same physics on the array path must agree: the sharded or
force-comm step against the serial step (tripolar with CATKE, the non-fold
grid, restoring, k-epsilon, the coupled step on an islands grid with its
surface fluxes), and the coupled loop against repeated coupled steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gb25_tpu.grids import simple_latitude_longitude_grid, tripolar_grid
from gb25_tpu.models import baroclinic_instability_config, baroclinic_instability_state, loop, time_step
from gb25_tpu.models.catke import CATKEVerticalDiffusivity
from gb25_tpu.models.coupled import coupled_loop, coupled_time_step, data_free_ocean_climate_model
from gb25_tpu.models.keps import TKEDissipationVerticalDiffusivity
from gb25_tpu.parallel import make_mesh, shard_state, sharded_step_fn
from gb25_tpu.parallel.sharded import sharded_coupled_step_fn

TOL = dict(rtol=1e-8, atol=1e-12)  # float64: reassociation only


def _needs(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")


def _assert_states_close(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for xa, xb in zip(la, lb):
        np.testing.assert_allclose(np.asarray(xb), np.asarray(xa), **TOL)


def _serial(cfg, grid, state, n, dt=60.0, **kw):
    s = state
    step = jax.jit(lambda s: time_step(cfg, grid, s, dt, **kw))
    for _ in range(n):
        s = step(s)
    return s


def _catke(grid):
    cfg = baroclinic_instability_config(closure=CATKEVerticalDiffusivity())
    return cfg, baroclinic_instability_state(grid, noise_velocity=1e-3, tracers=cfg.tracers)


def test_force_comm_tripolar_catke_matches_serial():
    """Tripolar fold + CATKE: the decomposed program (identity exchanges,
    distributed fold, blocked barotropic) on a 1x1 mesh equals the serial
    loop."""
    grid = tripolar_grid(48, 32, 8, dtype=jnp.float64)
    cfg, state = _catke(grid)
    ref = jax.jit(loop, static_argnames="n")(cfg, grid, state, 60.0, 2)
    mesh = make_mesh(1, shape=(1, 1))
    fn = sharded_step_fn(cfg, grid, mesh, n_inner=2, force_comm=True)
    _assert_states_close(ref, fn(shard_state(state, mesh), jnp.float64(60.0)))


def test_sharded_catke_nonfold_matches_serial():
    """CATKE on the lat-lon (non-fold) grid split over 2x1 devices."""
    _needs(2)
    grid = simple_latitude_longitude_grid(64, 32, 8, dtype=jnp.float64)
    cfg, state = _catke(grid)
    ref = _serial(cfg, grid, state, 2)
    mesh = make_mesh(2, shape=(2, 1))
    fn = sharded_step_fn(cfg, grid, mesh)
    s = shard_state(state, mesh)
    for _ in range(2):
        s = fn(s, jnp.float64(60.0))
    _assert_states_close(ref, s)


def test_sharded_restoring_matches_serial():
    """Tracer restoring toward a full 3-D target, sliced per shard."""
    _needs(4)
    grid = simple_latitude_longitude_grid(32, 16, 4, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    restoring = {"T": (jnp.full(grid.shape, 20.0, jnp.float64), jnp.float64(1e-4))}
    ref = _serial(cfg, grid, state, 2, restoring=restoring)
    mesh = make_mesh(4, shape=(2, 2))
    fn = sharded_step_fn(cfg, grid, mesh, restoring=restoring)
    s = shard_state(state, mesh)
    for _ in range(2):
        s = fn(s, jnp.float64(60.0))
    _assert_states_close(ref, s)
    # the restoring moved T toward the target
    plain = _serial(cfg, grid, state, 2)
    t_i = lambda st: np.asarray(st.tracers["T"])
    assert np.abs(t_i(ref) - 20.0).mean() < np.abs(t_i(plain) - 20.0).mean()


def test_sharded_keps_matches_serial():
    """The k-epsilon closure (tracers e and eps) split over 2x2 devices."""
    _needs(4)
    grid = simple_latitude_longitude_grid(32, 16, 8, dtype=jnp.float64)
    cfg = baroclinic_instability_config(closure=TKEDissipationVerticalDiffusivity())
    state = baroclinic_instability_state(grid, noise_velocity=1e-3, tracers=cfg.tracers)
    ref = _serial(cfg, grid, state, 2, dt=120.0)
    mesh = make_mesh(4, shape=(2, 2))
    fn = sharded_step_fn(cfg, grid, mesh)
    s = shard_state(state, mesh)
    for _ in range(2):
        s = fn(s, jnp.float64(120.0))
    _assert_states_close(ref, s)


def _islands(dtype=jnp.float64):
    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=8.0, Nz=4, dtype=dtype, grid_type="gaussian_islands_tripolar")
    assert grid.immersed and grid.north_fold
    return ccfg, grid, atmos, state


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_sharded_coupled_islands_matches_serial(mesh_shape):
    """The coupled step (air-sea surface fluxes into the barotropic and
    tracer integrals, immersed island masks, tripolar fold) decomposed over
    a force-comm 1x1 mesh and over 2x2 devices equals the serial loop."""
    n = mesh_shape[0] * mesh_shape[1]
    _needs(n)
    ccfg, grid, atmos, state = _islands()
    ref = jax.jit(coupled_loop, static_argnames="n")(ccfg, grid, atmos, state, 300.0, 2)
    mesh = make_mesh(n, shape=mesh_shape)
    fn = sharded_coupled_step_fn(ccfg, grid, atmos, mesh, n_inner=2, force_comm=n == 1)
    _assert_states_close(ref, fn(shard_state(state, mesh), jnp.float64(300.0)))


def test_coupled_loop_matches_repeated_steps():
    """``coupled_loop`` (one on-device loop, premasked state) equals the
    same number of ``coupled_time_step`` calls on the islands tripolar grid."""
    ccfg, grid, atmos, state = _islands()
    looped = jax.jit(coupled_loop, static_argnames="n")(ccfg, grid, atmos, state, 300.0, 3)
    step = jax.jit(lambda s: coupled_time_step(ccfg, grid, atmos, s, 300.0))
    s = state
    for _ in range(3):
        s = step(s)
    _assert_states_close(s, looped)
    # the wind stress spun up surface currents
    assert float(jnp.abs(looped.u[:, :, -1]).max()) > 0
