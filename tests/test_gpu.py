"""Tests that need an NVIDIA GPU. They skip elsewhere; ``chip_smoke.py``
runs them on the card, in its own process (``pytest -m gpu``)."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these on the card")


def _problem(shape, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    Z = shape[-1]
    # velocity-scale fields (m/s), as the climate step solves them
    fields = tuple(jnp.asarray(1e-2 * rng.standard_normal(shape), jnp.float32)
                   for _ in range(2))
    kappa = jnp.asarray(rng.uniform(0.0, 1e-1, shape), jnp.float32)
    dzc = jnp.asarray(rng.uniform(5.0, 50.0, (1, 1, Z)), jnp.float32)
    dzf = jnp.asarray(rng.uniform(5.0, 50.0, (1, 1, Z)), jnp.float32)
    return fields, kappa, dzc, dzf


def test_thomas_kernel_matches_scan_on_gpu(gpu):
    import jax

    from gb25_tpu.ops.thomas_triton import thomas_solve
    from gb25_tpu.ops.tridiagonal import scan_vertical_diffusion

    fields, kappa, dzc, dzf = _problem((300, 130, 64))
    got = jax.jit(lambda f, k: thomas_solve(f, k, 600.0, dzc, dzf))(fields, kappa)
    for g, f in zip(got, fields):
        want = jax.jit(lambda x, k: scan_vertical_diffusion(x, k, 600.0, dzc, dzf))(f, kappa)
        np.testing.assert_allclose(np.asarray(g), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_implicit_diffusion_runs_the_triton_kernel_on_gpu(gpu):
    import jax

    from gb25_tpu.ops.tridiagonal import implicit_vertical_diffusion

    fields, kappa, dzc, dzf = _problem((64, 32, 16))
    fn = jax.jit(lambda f, k: implicit_vertical_diffusion(f, k, 600.0, dzc, dzf))
    assert "__gpu$xla.gpu.triton" in fn.lower(fields, kappa).compile().as_text()
