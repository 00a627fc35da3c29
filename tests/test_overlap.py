"""Interior/boundary tendency split: the comm/compute overlap design.

Reference analog: Oceananigans computes boundary-strip tendencies, fires the
halo communication, and computes interior tendencies underneath
(``complete_communication_and_compute_buffer!``,
/root/reference/src/precompile.jl:52-73); the reference ablates it via
``optimize_communications``. Here the split is tested three ways:

1. exactness: split == monolithic tendencies (same exchanged data);
2. independence: NaN-poisoning every exchanged halo cell leaves the core
   region's tendencies untouched — the HLO-level proof that the core
   computation carries no data dependence on the ppermutes, which is
   precisely what lets XLA's latency-hiding scheduler overlap them;
3. end-to-end: sharded step with the split ON matches the serial model, and
   the ablation flag (overlap_split=False) also matches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gb25_tpu.grids import simple_latitude_longitude_grid
from gb25_tpu.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    loop,
)
from gb25_tpu.models.hydrostatic import split_tendency_math, tendency_math
from gb25_tpu.ops.halos import extend_field
from gb25_tpu.ops.operators import coriolis_ff

NX, NY, NZ = 48, 24, 6


def _setup(dtype=jnp.float64):
    grid = simple_latitude_longitude_grid(NX, NY, NZ, dtype=dtype)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    f_ff = coriolis_ff(grid, cfg.coriolis).astype(dtype)
    return grid, cfg, state, ue, ve, tr_e, f_ff


def test_split_matches_monolithic():
    grid, cfg, state, ue, ve, tr_e, f_ff = _setup()
    Gu_e, Gv_e, Gtr_e = tendency_math(cfg, grid, f_ff, ue, ve, tr_e)
    # single device: the "local" extension IS the exchanged extension
    Gu, Gv, Gtr = split_tendency_math(cfg, grid, f_ff, ue, ve, tr_e, ue, ve, tr_e)
    np.testing.assert_allclose(np.asarray(Gu), np.asarray(grid.interior(Gu_e)),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(Gv), np.asarray(grid.interior(Gv_e)),
                               rtol=1e-12, atol=1e-15)
    for k in Gtr:
        np.testing.assert_allclose(np.asarray(Gtr[k]), np.asarray(grid.interior(Gtr_e[k])),
                                   rtol=1e-12, atol=1e-15)


def test_core_is_independent_of_exchanged_halos():
    """Poison the exchanged extension's halo band with NaN: the core region
    (>= one halo width from every tile edge) must be bit-identical — i.e.
    the core tendencies' dependency cone contains no exchanged data."""
    grid, cfg, state, ue, ve, tr_e, f_ff = _setup()
    hx, hy = grid.hx, grid.hy

    def poison(a):
        m = np.ones(a.shape, bool)
        m[hx:-hx, hy:-hy, :] = False  # interior stays
        return jnp.where(jnp.asarray(m), jnp.nan, a)

    ue_p, ve_p = poison(ue), poison(ve)
    tr_p = {k: poison(v) for k, v in tr_e.items()}

    Gu0, Gv0, Gtr0 = split_tendency_math(cfg, grid, f_ff, ue, ve, tr_e, ue, ve, tr_e)
    Gu1, Gv1, Gtr1 = split_tendency_math(cfg, grid, f_ff, ue_p, ve_p, tr_p, ue, ve, tr_e)

    core = (slice(hx, NX - hx), slice(hy, NY - hy))
    for a, b in [(Gu0, Gu1), (Gv0, Gv1)] + [(Gtr0[k], Gtr1[k]) for k in Gtr0]:
        a, b = np.asarray(a), np.asarray(b)
        # strips got NaN (proves the poison reached them)...
        assert np.isnan(b[0]).any() and np.isnan(b[-1]).any()
        # ...but the core is untouched
        np.testing.assert_array_equal(a[core], b[core])


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("overlap", [True, False])
def test_sharded_split_matches_serial(overlap):
    from gb25_tpu.parallel import make_mesh, shard_state
    from gb25_tpu.parallel.sharded import sharded_step_fn

    grid = simple_latitude_longitude_grid(64, 32, 6, dtype=jnp.float64)
    cfg = dataclasses.replace(baroclinic_instability_config(), overlap_split=overlap)
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)

    s_ref = jax.jit(loop, static_argnames="n")(cfg, grid, state, 60.0, 3)
    mesh = make_mesh(8, shape=(4, 2))
    fn = sharded_step_fn(cfg, grid, mesh, n_inner=3)
    s_sh = fn(shard_state(state, mesh), jnp.float64(60.0))
    for a, b in zip(jax.tree_util.tree_leaves(s_ref), jax.tree_util.tree_leaves(s_sh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)


class _StubComm:
    """Stands in for MeshComm outside shard_map: extends halos either with
    the serial BC fill (faithful) or with NaN (poisoned exchange)."""

    Rx = Ry = 1

    def __init__(self, poison=False):
        self.poison = poison

    def x_offset(self, nx_local):
        return jnp.int32(0)

    def y_offset(self, ny_local):
        return jnp.int32(0)

    def extend_xy(self, a, hx, hy, xmodes, ymodes):
        from gb25_tpu.ops.halos import extend_axis

        a = extend_axis(a, hx, 0, *xmodes)
        a = extend_axis(a, hy, 1, *ymodes)
        if self.poison:
            m = np.ones(a.shape, bool)
            m[hx:-hx, hy:-hy] = False
            a = jnp.where(jnp.asarray(m), jnp.nan, a)
        return a


def test_compute_tendencies_core_independent_of_exchange():
    """With overlap_split under a comm, compute_tendencies builds the core
    from the LOCAL extension: NaN-poisoning every exchanged halo cell leaves
    the core of every tendency untouched (bitwise), while the boundary
    strips (the only consumers of exchanged data) do see the poison."""
    from gb25_tpu.models.hydrostatic import compute_tendencies

    grid = simple_latitude_longitude_grid(64, 32, 8, dtype=jnp.float32)
    cfg = dataclasses.replace(baroclinic_instability_config(), overlap_split=True)
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    hx, hy = grid.hx, grid.hy

    outs = {}
    for tag, poison in [("clean", False), ("poisoned", True)]:
        Gu, Gv, _, Gtr, _ = compute_tendencies(
            cfg, grid, state, comm=_StubComm(poison=poison))
        outs[tag] = [np.asarray(f) for f in [Gu, Gv] + [Gtr[k] for k in sorted(Gtr)]]

    core = (slice(hx, 64 - hx), slice(hy, 32 - hy))
    for a, b in zip(outs["clean"], outs["poisoned"]):
        assert np.isnan(b[0]).any() and np.isnan(b[-1]).any(), \
            "poison never reached the boundary strips"
        np.testing.assert_array_equal(a[core], b[core])
        assert not np.isnan(a).any()
