"""The Pallas-Triton Thomas kernel (ops/thomas_triton.py) in interpret mode,
against the ``lax.scan`` Thomas (ops/tridiagonal.py) and against
``scipy.linalg.solve_banded`` in float64; and the choice of solver by the
platform the program is lowered for."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import solve_banded

from gb25_tpu.ops import thomas_triton
from gb25_tpu.ops.thomas_triton import thomas_solve
from gb25_tpu.ops.tridiagonal import implicit_vertical_diffusion, scan_vertical_diffusion

DT = 600.0
# column shapes whose column count is not a multiple of the kernel's block
COLUMNS = {2: (37, 5), 7: (43, 13), 64: (19, 17)}
TOL_SCAN = {jnp.float32: dict(rtol=1e-5, atol=1e-7), jnp.float64: dict(rtol=1e-12, atol=1e-14)}
TOL_EXACT = {jnp.float32: dict(rtol=1e-4, atol=1e-5), jnp.float64: dict(rtol=1e-10, atol=1e-12)}


def _problem(X, Y, Z, nf, dtype, damped, seed=0, zero_faces=False):
    rng = np.random.default_rng(seed)
    fields = [rng.standard_normal((X, Y, Z)) for _ in range(nf)]
    kappa = rng.uniform(0.0, 1e-1, (X, Y, Z))
    if zero_faces:
        # immersed columns: every face of every third column is solid, and
        # one face in the middle of every column
        kappa[::3] = 0.0
        kappa[:, :, Z // 2] = 0.0
    damping = rng.uniform(0.0, 1e-3, (X, Y, Z)) if damped else None
    dzc = rng.uniform(5.0, 50.0, Z)
    dzf = rng.uniform(5.0, 50.0, Z)
    return fields, kappa, damping, dzc, dzf


def _exact(field, kappa, damping, dzc, dzf):
    """The backward-Euler system solved per column in float64 by LAPACK."""
    X, Y, Z = field.shape
    lam = DT * kappa / (dzc * dzf)
    lam[..., 0] = 0.0
    mu = np.zeros_like(lam)
    mu[..., :-1] = DT * kappa[..., 1:] / (dzc[:-1] * dzf[1:])
    diag = 1.0 + lam + mu + (DT * damping if damping is not None else 0.0)
    out = np.empty_like(field)
    for i in range(X):
        for j in range(Y):
            ab = np.zeros((3, Z))
            ab[0, 1:] = -mu[i, j, :-1]
            ab[1] = diag[i, j]
            ab[2, :-1] = -lam[i, j, 1:]
            out[i, j] = solve_banded((1, 1), ab, field[i, j])
    return out


def _check(Z, nf, dtype, damped, zero_faces=False):
    X, Y = COLUMNS[Z]
    fields, kappa, damping, dzc, dzf = _problem(X, Y, Z, nf, dtype, damped,
                                                zero_faces=zero_faces)
    cast = lambda a: None if a is None else jnp.asarray(a, dtype)
    dzc_j, dzf_j = cast(dzc).reshape(1, 1, Z), cast(dzf).reshape(1, 1, Z)
    got = thomas_solve([cast(f) for f in fields], cast(kappa), DT, dzc_j, dzf_j,
                       cast(damping), interpret=True)
    assert len(got) == nf
    for g, f in zip(got, fields):
        assert g.shape == (X, Y, Z) and g.dtype == dtype
        want = scan_vertical_diffusion(cast(f), cast(kappa), DT, dzc_j, dzf_j, cast(damping))
        np.testing.assert_allclose(np.asarray(g), np.asarray(want), **TOL_SCAN[dtype])
        np.testing.assert_allclose(np.asarray(g), _exact(f, kappa, damping, dzc, dzf),
                                   **TOL_EXACT[dtype])
    return got, fields, damping


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("Z", [2, 7, 64])
def test_kernel_matches_scan_and_lapack(Z, nf, damped, dtype):
    _check(Z, nf, damped=damped, dtype=dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64], ids=["f32", "f64"])
def test_immersed_zero_faces(dtype):
    """kappa = 0 on solid faces decouples the levels: a column with every
    face solid is only damped, x = f / (1 + dt * damping)."""
    got, fields, damping = _check(7, 2, dtype, damped=True, zero_faces=True)
    for g, f in zip(got, fields):
        want = f[::3] / (1.0 + DT * damping[::3])
        np.testing.assert_allclose(np.asarray(g)[::3], want, **TOL_EXACT[dtype])


def test_padding_columns_are_masked():
    """Columns past the last full block are neither read nor written: the
    result for a column does not depend on how many columns follow it."""
    X, Y, Z = 1, thomas_triton.BLOCK_COLUMNS + 3, 7
    fields, kappa, _, dzc, dzf = _problem(X, Y, Z, 1, jnp.float32, False, seed=3)
    args = lambda sl: ([jnp.asarray(fields[0][:, sl], jnp.float32)],
                       jnp.asarray(kappa[:, sl], jnp.float32), DT,
                       jnp.asarray(dzc, jnp.float32), jnp.asarray(dzf, jnp.float32))
    full = thomas_solve(*args(slice(None)), interpret=True)[0]
    head = thomas_solve(*args(slice(0, 5)), interpret=True)[0]
    np.testing.assert_array_equal(np.asarray(full)[:, :5], np.asarray(head))
    assert np.isfinite(np.asarray(full)).all()


def test_broadcast_kappa_and_flat_spacings():
    """kappa broadcastable to the field and (Z,)-shaped spacings give the
    same answer as the full-shape, (1, 1, Z) forms."""
    X, Y, Z = 9, 4, 7
    fields, _, _, dzc, dzf = _problem(X, Y, Z, 2, jnp.float64, False, seed=5)
    kap1 = np.linspace(0.0, 1e-1, Z).reshape(1, 1, Z)
    fs = [jnp.asarray(f) for f in fields]
    a = thomas_solve(fs, jnp.asarray(kap1), DT, jnp.asarray(dzc), jnp.asarray(dzf),
                     interpret=True)
    b = thomas_solve(fs, jnp.broadcast_to(jnp.asarray(kap1), (X, Y, Z)), DT,
                     jnp.asarray(dzc).reshape(1, 1, Z), jnp.asarray(dzf).reshape(1, 1, Z),
                     interpret=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _lowered_text(platform):
    Z = 7
    fields, kappa, _, dzc, dzf = _problem(8, 4, Z, 2, jnp.float32, False)
    fs = tuple(jnp.asarray(f, jnp.float32) for f in fields)
    dzc, dzf = jnp.asarray(dzc, jnp.float32), jnp.asarray(dzf, jnp.float32)
    fn = jax.jit(lambda f, k: implicit_vertical_diffusion(f, k, DT, dzc, dzf))
    return fn.trace(fs, jnp.asarray(kappa, jnp.float32)).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,triton", [("cuda", True), ("cpu", False)])
def test_solver_chosen_by_platform(platform, triton):
    """One program, lowered for CUDA, calls the Triton kernel; lowered for
    the CPU, it is the scan."""
    assert ("triton" in _lowered_text(platform)) == triton


def test_selector_returns_the_scan_on_cpu():
    """On the CPU ``implicit_vertical_diffusion`` is the scan, bitwise, for
    one field and for a tuple of fields sharing kappa."""
    Z = 7
    fields, kappa, damping, dzc, dzf = _problem(8, 4, Z, 2, jnp.float32, True)
    f0, f1 = (jnp.asarray(f, jnp.float32) for f in fields)
    k, d = jnp.asarray(kappa, jnp.float32), jnp.asarray(damping, jnp.float32)
    dzc, dzf = jnp.asarray(dzc, jnp.float32), jnp.asarray(dzf, jnp.float32)
    one = implicit_vertical_diffusion(f0, k, DT, dzc, dzf, d)
    pair = implicit_vertical_diffusion((f0, f1), k, DT, dzc, dzf, d)
    assert isinstance(pair, tuple) and len(pair) == 2
    for got, f in [(one, f0), (pair[0], f0), (pair[1], f1)]:
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(scan_vertical_diffusion(f, k, DT, dzc, dzf, d)))


def _sharded_solve(check_vma, interpret):
    from functools import partial

    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((2, 2), ("x", "y"))
    X, Y, Z = 16, 12, 7
    fields, kappa, _, dzc, dzf = _problem(X, Y, Z, 2, jnp.float32, False, seed=9)
    fs = tuple(jnp.asarray(f, jnp.float32) for f in fields)
    k = jnp.asarray(kappa, jnp.float32)
    dzc, dzf = jnp.asarray(dzc, jnp.float32), jnp.asarray(dzf, jnp.float32)
    spec = P("x", "y")

    @partial(jax.shard_map, mesh=mesh, in_specs=((spec, spec), spec),
             out_specs=(spec, spec), check_vma=check_vma)
    def solve(f, kap):
        return thomas_solve(f, kap, DT, dzc, dzf, interpret=interpret)

    ref = [scan_vertical_diffusion(f, k, DT, dzc, dzf) for f in fs]
    return jax.jit(solve), (fs, k), ref


def test_kernel_under_shard_map():
    """Each shard of a 2x2 mesh solves its own columns. (The Pallas
    interpreter cannot follow varying mesh axes, so this value check runs
    with ``check_vma=False``; the next test lowers the same call with the
    check on.)"""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    fn, args, ref = _sharded_solve(check_vma=False, interpret=True)
    for g, r in zip(fn(*args), ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), **TOL_SCAN[jnp.float32])


def test_kernel_lowers_for_cuda_under_shard_map():
    """Inside ``shard_map`` with the varying-axes check on (the sharded
    climate step), the kernel's operands and outputs vary over the mesh
    axes like the fields, and the program lowers for CUDA to a Triton call."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    fn, args, _ = _sharded_solve(check_vma=True, interpret=False)
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text
