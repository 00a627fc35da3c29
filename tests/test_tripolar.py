"""Tripolar grid tests: coordinate construction, metric consistency, north
fold exchange, and model integration (reference: TripolarGrid +
gaussian_islands, model_utils.jl:134-146)."""

import jax
import jax.numpy as jnp
import numpy as np

from gb25_tpu.grids import tripolar_grid
from gb25_tpu.grids.tripolar import extend_field_tripolar, fold_ghosts_north
from gb25_tpu.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    loop,
)

NX, NY, NZ = 48, 32, 4


def _grid(dtype=jnp.float64):
    return tripolar_grid(NX, NY, NZ, dtype=dtype)


class TestConstruction:
    def test_basic_properties(self):
        g = _grid()
        assert g.north_fold and g.x_periodic
        assert g.shape == (NX, NY, NZ)
        # pole snapped near 70E
        lam_p = (g.pole_index + 0.5) * 360.0 / NX
        assert abs(lam_p - 70.0) < 360.0 / NX

    def test_metrics_positive_and_finite(self):
        g = _grid()
        for name in ("dxc", "dxf", "dyc", "dyf", "azc", "azf"):
            m = np.asarray(getattr(g, name))
            assert np.isfinite(m).all(), name
            assert (m > 0).all(), name

    def test_southern_band_matches_latlon(self):
        """Below the pole latitude the grid is plain lat-lon."""
        g = _grid()
        phi = np.asarray(g.phi2_c)
        # southern rows: constant latitude along x
        assert np.ptp(phi[:, 0]) < 1e-9
        assert np.ptp(phi[:, 5]) < 1e-9
        assert phi[0, 0] > -80.0 and phi[0, 0] < -75.0

    def test_cap_reaches_seam(self):
        g = _grid()
        phi = np.asarray(g.phi2_c)
        lam = np.asarray(g.lam2_c)
        # northern rows are genuinely 2-D (latitude varies along x)
        assert np.ptp(phi[:, -1]) > 1.0
        # all latitudes stay on the sphere and north of the band
        assert phi.max() <= 90.0 + 1e-9
        assert np.isfinite(lam).all()

    def test_total_area_approximates_band(self):
        g = _grid()
        hx, hy = g.hx, g.hy
        az = np.asarray(g.azc)[hx : hx + NX, hy : hy + NY, 0]
        # seam row is duplicated (T-pivot): count it at half weight
        area = az[:, :-1].sum() + 0.5 * az[:, -1].sum()
        from gb25_tpu.grids import EARTH_RADIUS

        exact = 2 * np.pi * EARTH_RADIUS**2 * (1 + np.sin(np.deg2rad(80.0)))
        assert abs(area - exact) / exact < 0.05

    def test_fold_mirror_of_metrics(self):
        """Ghost metric rows equal the folded interior rows."""
        g = _grid()
        hx, hy = g.hx, g.hy
        az = np.asarray(g.azc)[hx : hx + NX, :, 0]
        p = g.pole_index
        fold = np.roll(az[::-1, :], (2 * p + 1) % NX, axis=0)
        np.testing.assert_allclose(az[:, hy + NY], fold[:, hy + NY - 2], rtol=1e-12)


class TestFoldExchange:
    def test_center_fold_roundtrip(self):
        g = _grid()
        rng = np.random.default_rng(0)
        a = jnp.asarray(rng.standard_normal((NX, NY, 2)))
        gh = fold_ghosts_north(a, 2, "c", g.pole_index)
        # ghost row Ny+m equals a(fold(i), Ny-2-m... here P=Ny-1: row P-m)
        p = g.pole_index
        fold_idx = [(2 * p - i) % NX for i in range(NX)]
        np.testing.assert_allclose(
            np.asarray(gh[:, 0]), np.asarray(a)[fold_idx, NY - 2], rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(gh[:, 1]), np.asarray(a)[fold_idx, NY - 3], rtol=1e-12
        )

    def test_u_fold_sign_and_offset(self):
        g = _grid()
        rng = np.random.default_rng(1)
        a = jnp.asarray(rng.standard_normal((NX, NY, 1)))
        gh = fold_ghosts_north(a, 1, "u", g.pole_index)
        p = g.pole_index
        fold_idx = [(2 * p + 1 - i) % NX for i in range(NX)]
        np.testing.assert_allclose(
            np.asarray(gh[:, 0]), -np.asarray(a)[fold_idx, NY - 2], rtol=1e-12
        )

    def test_v_fold_rows(self):
        g = _grid()
        rng = np.random.default_rng(2)
        a = jnp.asarray(rng.standard_normal((NX, NY, 1)))
        gh = fold_ghosts_north(a, 2, "v", g.pole_index)
        p = g.pole_index
        fold_idx = [(2 * p - i) % NX for i in range(NX)]
        # ghost v face Ny+m maps to face 2Ny-1-(Ny+m) = Ny-1-m, sign flipped
        np.testing.assert_allclose(
            np.asarray(gh[:, 0]), -np.asarray(a)[fold_idx, NY - 1], rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(gh[:, 1]), -np.asarray(a)[fold_idx, NY - 2], rtol=1e-12
        )

    def test_extended_field_shape(self):
        g = _grid()
        a = jnp.ones((NX, NY))
        e = extend_field_tripolar(g, a, "c", g.hx, g.hy)
        assert e.shape == (NX + 2 * g.hx, NY + 2 * g.hy)


class TestModelOnTripolar:
    def test_symmetric_field_fold_consistency(self):
        """A fold-symmetric tracer stays fold-symmetric through a step."""
        g = _grid()
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(g, noise_velocity=0.0)
        s = jax.jit(lambda c, gg, st, dt: loop(c, gg, st, dt, 3), static_argnums=())(
            cfg, g, state, 60.0
        )
        T = np.asarray(s.tracers["T"])
        p = g.pole_index
        fold_idx = [(2 * p - i) % NX for i in range(NX)]
        np.testing.assert_allclose(
            T[:, NY - 1], T[fold_idx, NY - 1], rtol=1e-7, atol=1e-10
        )

    def test_baroclinic_on_tripolar_stable(self):
        """Small dt: the pole-adjacent cells are tiny (they belong on land in
        any physical configuration — cf. the reference's Δt=1 s benchmark
        setting for the sharded tripolar runs)."""
        g = _grid()
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(g, noise_velocity=1e-3)
        s = jax.jit(loop, static_argnames="n")(cfg, g, state, 5.0, 30)
        assert all(bool(jnp.isfinite(x).all()) for x in jax.tree_util.tree_leaves(s))
        assert float(jnp.abs(s.u).max()) < 5.0

    def test_gaussian_islands_tripolar(self):
        from gb25_tpu.grids.immersed import gaussian_islands_bottom

        g = gaussian_islands_bottom(_grid())
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(g, noise_velocity=1e-3)
        s = jax.jit(loop, static_argnames="n")(cfg, g, state, 5.0, 10)
        assert all(bool(jnp.isfinite(x).all()) for x in jax.tree_util.tree_leaves(s))


class TestDistributedFold:
    """Distributed north-fold exchange: sharded tripolar == single device
    (SURVEY.md hard part (a))."""

    def _run(self, mesh_shape, steps=3, dt=5.0):
        import pytest

        if len(jax.devices()) < mesh_shape[0] * mesh_shape[1]:
            pytest.skip("needs more virtual devices")
        from gb25_tpu.parallel import make_mesh, shard_state
        from gb25_tpu.parallel.sharded import sharded_step_fn

        g = tripolar_grid(NX, NY, NZ, dtype=jnp.float64)
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(g, noise_velocity=1e-3)

        s_ref = state
        step = jax.jit(loop, static_argnames="n")
        s_ref = step(cfg, g, s_ref, dt, steps)

        mesh = make_mesh(mesh_shape[0] * mesh_shape[1], shape=mesh_shape)
        fn = sharded_step_fn(cfg, g, mesh, n_inner=steps)
        s_sh = fn(shard_state(state, mesh), jnp.float64(dt))
        for a, b in zip(jax.tree_util.tree_leaves(s_ref), jax.tree_util.tree_leaves(s_sh)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)

    def test_mesh_4x2(self):
        self._run((4, 2))

    def test_mesh_2x2(self):
        self._run((2, 2))

    def test_mesh_1x2(self):
        self._run((1, 2))

    def test_mesh_8x1(self):
        self._run((8, 1))

    def test_no_gather_in_tripolar_hlo(self):
        """The distributed fold must also compile to collective-permutes only
        (the reference CI's communication-pattern gate)."""
        import pytest

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gb25_tpu.parallel import make_mesh, shard_state
        from gb25_tpu.parallel.sharded import sharded_step_fn

        g = tripolar_grid(NX, NY, NZ, dtype=jnp.float32)
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(g)
        mesh = make_mesh(8, shape=(4, 2))
        fn = sharded_step_fn(cfg, g, mesh)
        hlo = fn.lower(shard_state(state, mesh), jnp.float32(5.0)).compile().as_text()
        for bad in ("all-gather", "all-reduce", "all-to-all"):
            assert bad not in hlo, f"forbidden collective {bad}"
        assert "collective-permute" in hlo


class TestSliverTiles:
    """Deep-Ry meshes where the top rank row's tile is
    shorter than the fold strip must either work (nyl > halo) or raise."""

    def test_mesh_2x4_matches_serial(self):
        # NY=32, Ry=4 -> nyl=8 > halo=4: supported and must be exact
        TestDistributedFold()._run((2, 4))

    def test_mesh_1x8_sliver_raises(self):
        import pytest

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gb25_tpu.parallel import make_mesh, shard_state
        from gb25_tpu.parallel.sharded import sharded_step_fn

        # NY=32, Ry=8 -> nyl=4 == halo: the fold strip (halo+1 rows) does not
        # fit in the top rank row's tile -> explicit trace-time error
        g = tripolar_grid(NX, NY, NZ, dtype=jnp.float64)
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(g, noise_velocity=1e-3)
        mesh = make_mesh(8, shape=(1, 8))
        fn = sharded_step_fn(cfg, g, mesh)
        with pytest.raises(ValueError, match="north fold needs ny_local"):
            fn(shard_state(state, mesh), jnp.float64(5.0))

    def test_mesh_1x8_tall_grid_matches_serial(self):
        import pytest

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from gb25_tpu.parallel import make_mesh, shard_state
        from gb25_tpu.parallel.sharded import sharded_step_fn

        # taller grid: Ry=8 with nyl=6 (the free-surface wide exchange uses
        # width halo+1 = 5, so the fold strip needs ny_local >= 6)
        g = tripolar_grid(32, 48, NZ, dtype=jnp.float64)
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(g, noise_velocity=1e-3)
        step = jax.jit(loop, static_argnames="n")
        s_ref = step(cfg, g, state, 5.0, 3)

        mesh = make_mesh(8, shape=(1, 8))
        fn = sharded_step_fn(cfg, g, mesh, n_inner=3)
        s_sh = fn(shard_state(state, mesh), jnp.float64(5.0))
        for a, b in zip(jax.tree_util.tree_leaves(s_ref), jax.tree_util.tree_leaves(s_sh)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)
