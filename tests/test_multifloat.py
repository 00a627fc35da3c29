"""Two-limb emulated precision (MultiFloatOptions limbs=2 analog).

Reference capability: /root/reference/src/arg_parsing.jl:99-107 maps
--limbs/--target-float-type to Reactant.MultiFloatOptions.  Here:
``compute_dtype="f32x2"`` runs the tendency physics in double-single
arithmetic (emulated ~f64 from f32 limbs) and
``"bf16x2"`` in paired-bf16 limbs.  The tests pin the accuracy ordering
bf16 << bf16x2 < f32 << f32x2 against an f64 run of the same physics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gb25_tpu.ops.multifloat import TwoFloat, mf_sqrt

# ----- arithmetic micro-tests -----


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 10.0, shape).astype(np.float32)


def test_f32x2_arithmetic_matches_f64():
    a64 = _rand((64,), 0).astype(np.float64) * np.pi
    b64 = _rand((64,), 1).astype(np.float64) * np.e
    a = TwoFloat.from_array(a64, jnp.float32)
    b = TwoFloat.from_array(b64, jnp.float32)
    for op, ref in [
        (lambda x, y: x + y, a64 + b64),
        (lambda x, y: x - y, a64 - b64),
        (lambda x, y: x * y, a64 * b64),
        (lambda x, y: x / y, a64 / b64),
    ]:
        got = np.asarray(op(a, b).hi, np.float64) + np.asarray(op(a, b).lo, np.float64)
        rel = np.max(np.abs(got - ref) / np.abs(ref))
        assert rel < 1e-12, rel
    s = mf_sqrt(a)
    got = np.asarray(s.hi, np.float64) + np.asarray(s.lo, np.float64)
    rel = np.max(np.abs(got - np.sqrt(a64)) / np.sqrt(a64))
    assert rel < 1e-12, rel


def test_f32x2_rescues_catastrophic_cancellation():
    # (x + big) - big loses all of x in f32, none of it in f32x2
    x64 = np.float64(np.pi) * 1e-4
    big = np.float64(1.0e4)
    f32 = (np.float32(x64) + np.float32(big)) - np.float32(big)
    dd = (TwoFloat.from_array(np.float32(x64)) + big) - big
    got = float(dd.hi) + float(dd.lo)
    assert abs(f32 - x64) / x64 > 1e-4  # f32 visibly loses bits
    assert abs(got - float(np.float32(x64))) / x64 < 1e-7  # f32x2 keeps them


def test_bf16x2_beats_bf16():
    a64 = _rand((256,), 2).astype(np.float64)
    b64 = _rand((256,), 3).astype(np.float64)
    ref = a64 * b64 + a64 / b64 - b64
    a16 = jnp.asarray(a64, jnp.bfloat16)
    b16 = jnp.asarray(b64, jnp.bfloat16)
    got16 = np.asarray(a16 * b16 + a16 / b16 - b16, np.float64)
    a2 = TwoFloat.from_array(a64, jnp.bfloat16)
    b2 = TwoFloat.from_array(b64, jnp.bfloat16)
    r2 = a2 * b2 + a2 / b2 - b2
    got2 = np.asarray(r2.hi, np.float64) + np.asarray(r2.lo, np.float64)
    err16 = np.max(np.abs(got16 - ref) / np.abs(ref))
    err2 = np.max(np.abs(got2 - ref) / np.abs(ref))
    assert err2 < err16 / 20, (err2, err16)
    assert err2 < 1e-3


def test_twofloat_jit_and_tree():
    a = TwoFloat.from_array(np.linspace(1.0, 2.0, 16, dtype=np.float64))

    @jax.jit
    def f(x):
        return x * x + 1.0

    out = f(a)
    assert isinstance(out, TwoFloat)
    ref = np.linspace(1.0, 2.0, 16) ** 2 + 1.0
    got = np.asarray(out.hi, np.float64) + np.asarray(out.lo, np.float64)
    assert np.max(np.abs(got - ref)) < 1e-13


# ----- tendency-physics differential -----


def _tendency_setup():
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import (
        baroclinic_instability_config,
        baroclinic_instability_state,
    )
    from gb25_tpu.ops.halos import extend_field
    from gb25_tpu.ops.operators import coriolis_ff

    grid64 = simple_latitude_longitude_grid(24, 16, 8, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid64, noise_velocity=1e-3)
    ue = extend_field(grid64, state.u, "u")
    ve = extend_field(grid64, state.v, "v")
    tr_e = {k: extend_field(grid64, c, "c") for k, c in state.tracers.items()}
    f_ff = coriolis_ff(grid64, cfg.coriolis)
    # all paths consume the exact same f32-representable values
    r32 = lambda x: x.astype(jnp.float32).astype(jnp.float64)
    ue, ve = r32(ue), r32(ve)
    tr_e = {k: r32(v) for k, v in tr_e.items()}
    f_ff = r32(f_ff)
    return cfg, grid64, f_ff, ue, ve, tr_e


def _run_tendency(cfg, grid, f_ff, ue, ve, tr_e, mode):
    """mode: 'f64' | 'f32' | 'bf16' | 'f32x2' | 'bf16x2'."""
    from gb25_tpu.models.hydrostatic import tendency_math
    from gb25_tpu.ops.multifloat import unwrap_compute, wrap_compute

    if mode == "f64":
        conv = lambda x: x
        gconv = lambda x: x
    elif mode in ("f32", "bf16"):
        dt = jnp.float32 if mode == "f32" else jnp.bfloat16
        conv = lambda x: x.astype(dt)
        gconv = conv
    else:
        conv = lambda x: wrap_compute(x.astype(jnp.float32), mode)
        gconv = lambda x: wrap_compute(np.asarray(x, np.float64), mode)
    grid_c = jax.tree_util.tree_map(
        lambda x: gconv(x) if jnp.issubdtype(x.dtype, jnp.floating) else x, grid
    )
    Gu, Gv, Gtr = tendency_math(
        cfg, grid_c, conv(f_ff), conv(ue), conv(ve),
        {k: conv(v) for k, v in tr_e.items()},
    )
    out = [Gu, Gv] + [Gtr[k] for k in sorted(Gtr)]
    h = grid.halo
    crop = lambda a: a[h[0]: -h[0], h[1]: -h[1], h[2]: -h[2]]
    return [crop(np.asarray(unwrap_compute(x, jnp.float64), np.float64)) for x in out]


def _err(got, ref):
    return max(
        np.max(np.abs(g - r)) / (np.max(np.abs(r)) + 1e-300)
        for g, r in zip(got, ref)
    )


def test_tendency_precision_ladder():
    cfg, grid, f_ff, ue, ve, tr_e = _tendency_setup()
    ref = _run_tendency(cfg, grid, f_ff, ue, ve, tr_e, "f64")
    errs = {m: _err(_run_tendency(cfg, grid, f_ff, ue, ve, tr_e, m), ref)
            for m in ("f32", "bf16", "f32x2", "bf16x2")}
    # the ladder: f32x2 (emulated f64) << f32, bf16x2 << bf16.  The absolute
    # floors are set by WENO upwind-branch selection at near-zero advecting
    # velocities (a different rounding path may flip a face's upwind side),
    # not by the limb arithmetic itself (measured: f32x2 3.6e-8 vs f32
    # 2.7e-5 vs bf16x2 4.2e-3 vs bf16 2.0 on this configuration).
    assert errs["f32x2"] < errs["f32"] / 100, errs
    assert errs["f32x2"] < 1e-7, errs
    assert errs["bf16x2"] < errs["bf16"] / 50, errs
    assert errs["bf16x2"] < 1e-2, errs


def test_full_step_runs_f32x2():
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import (
        baroclinic_instability_config,
        baroclinic_instability_state,
        time_step,
    )

    grid = simple_latitude_longitude_grid(16, 12, 6, dtype=jnp.float32)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    s32 = jax.jit(lambda s: time_step(cfg, grid, s, jnp.float32(60.0)))(state)
    cfg2 = dataclasses.replace(cfg, compute_dtype="f32x2")
    s2 = jax.jit(lambda s: time_step(cfg2, grid, s, jnp.float32(60.0)))(state)
    for a, b in zip(jax.tree_util.tree_leaves(s32), jax.tree_util.tree_leaves(s2)):
        assert np.isfinite(np.asarray(b)).all()
        np.testing.assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64),
            rtol=2e-4, atol=1e-7,
        )
