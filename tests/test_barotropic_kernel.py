"""The blocked split-explicit barotropic solve: the exchange width is exact
and blocking agrees with an exchange every substep."""

import jax.numpy as jnp
import numpy as np

from gb25_tpu.grids import simple_latitude_longitude_grid
from gb25_tpu.models import baroclinic_instability_config, baroclinic_instability_state
from gb25_tpu.models.free_surface import barotropic_substep


def _per_block_setup():
    grid = simple_latitude_longitude_grid(64, 32, 8, dtype=jnp.float32)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    rng = np.random.default_rng(5)
    state = state.replace(
        eta=jnp.asarray(rng.standard_normal((64, 32)) * 1e-3, jnp.float32)
    )
    rng = np.random.default_rng(7)
    Gu = jnp.asarray(rng.standard_normal(state.u.shape) * 1e-6, state.u.dtype)
    Gv = jnp.asarray(rng.standard_normal(state.v.shape) * 1e-6, state.v.dtype)
    W = min(grid.hx, grid.hy, grid.Nx - 1, grid.Ny - 1)
    return cfg, grid, state, Gu, Gv, W


def _run_per_block(cfg, grid, state, Gu, Gv, blk, monkeypatch):
    monkeypatch.setenv("GB25_BAROTROPIC_BLOCK", str(blk))
    r = barotropic_substep(cfg, grid, state, state.u, state.v, Gu, Gv, 60.0)
    return [np.asarray(a) for a in r]


def test_per_block_width_is_exact(monkeypatch):
    """A width-W halo exchange supports exactly W FB substeps: each substep
    consumes ONE ghost ring (eta reads U one ring out; the new U reads the
    just-updated eta at the same ring — the two half-steps are sequentially
    dependent, so they advance the invalid front by one ring total, not two).

    Proof by NaN-poisoning: garbage in the outermost ring (i.e. a width W-1
    exchange) must stay out of the interior for W-1 substeps per block and
    reach it on the W-th."""
    import gb25_tpu.models.free_surface as fsm

    cfg, grid, state, Gu, Gv, W = _per_block_setup()
    real_extend2 = fsm._extend2

    def poisoned(g, a, kind, comm, h=1):
        e = real_extend2(g, a, kind, comm, h)
        if h == W:  # static fields (H: h=W+1, metrics) stay valid
            e = e.at[0, :].set(jnp.nan).at[-1, :].set(jnp.nan)
            e = e.at[:, 0].set(jnp.nan).at[:, -1].set(jnp.nan)
        return e

    monkeypatch.setattr(fsm, "_extend2", poisoned)
    clean = _run_per_block(cfg, grid, state, Gu, Gv, W - 1, monkeypatch)
    assert not any(np.isnan(a).any() for a in clean)
    dirty = _run_per_block(cfg, grid, state, Gu, Gv, W, monkeypatch)
    assert all(np.isnan(a).any() for a in dirty)


def test_per_block_agrees_with_every_substep(monkeypatch):
    """Blocked exchange vs exchange-every-substep: identical up to the
    bounded wall-ghost drift.  Physical-wall ghost rows evolve in-block with
    their own (latitude-asymmetric) metrics instead of being re-mirrored
    each substep, so near-wall values drift at roundoff scale (~1e-9 abs
    here) until the next exchange re-imposes the BC; x-periodic and
    shard-interface ghosts evolve bitwise-exactly (their halo arithmetic is
    the neighbor's own).  The drift is re-zeroed every exchange, so it does
    not accumulate beyond one block."""
    cfg, grid, state, Gu, Gv, W = _per_block_setup()
    gold = _run_per_block(cfg, grid, state, Gu, Gv, 1, monkeypatch)
    blocked = _run_per_block(cfg, grid, state, Gu, Gv, W, monkeypatch)
    for b, g in zip(blocked, gold):
        np.testing.assert_allclose(b, g, atol=2e-8, rtol=1e-6)
    # the u component never touches a wall ghost: bitwise equal
    np.testing.assert_array_equal(blocked[1], gold[1])
