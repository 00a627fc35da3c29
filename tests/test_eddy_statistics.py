"""Eddy-statistics validation (reference analog: the eddy field the
baroclinic-instability visualization renders and the published GB25 runs'
eddy-resolving behavior; SURVEY.md section 4 "physics regression" strategy).

Cheap invariants run here; the full growth-vs-Eady comparison is the probe
``scripts/probes/eddy_statistics.py`` (too slow for unit CI at resolutions
that resolve the deformation radius)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np

from gb25_tpu.grids import simple_latitude_longitude_grid
from gb25_tpu.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    loop,
)
from gb25_tpu.utils.diagnostics import (
    eddy_mean_kinetic_energy,
    total_kinetic_energy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe():
    spec = importlib.util.spec_from_file_location(
        "eddy_statistics",
        os.path.join(REPO, "scripts", "probes", "eddy_statistics.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eke_mke_pythagorean_identity():
    """Zonal-mean Reynolds decomposition is exact: (EKE + MKE) * volume
    equals the volume-integrated KE, because sum_x u^2 = Nx*[u]^2 + sum_x u'^2
    identically on the x-uniform lat-lon grid."""
    grid = simple_latitude_longitude_grid(24, 12, 8, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    state = jax.jit(loop, static_argnames="n")(cfg, grid, state, 120.0, 5)

    eke, mke = eddy_mean_kinetic_energy(grid, state)
    assert float(eke) > 0 and float(mke) >= 0

    hy, hz = grid.hy, grid.hz
    az = grid.azc[:, hy : hy + grid.Ny, :]
    dz = grid.dz_c[:, :, hz : hz + grid.Nz]
    vol = float(jnp.sum(az * dz)) * grid.Nx
    ke_total = float(total_kinetic_energy(grid, state))
    np.testing.assert_allclose((float(eke) + float(mke)) * vol, ke_total,
                               rtol=1e-12)


def test_fit_growth_recovers_synthetic_rate():
    """The exponential-window fitter recovers sigma from EKE ~ exp(2 s t)."""
    mod = _probe()
    sigma = 2.5e-6
    t = np.linspace(0.0, 12 * 86400.0, 40)
    # adjustment transient (decaying) followed by clean exponential growth
    eke = 1e-7 * np.exp(-t / 2e5) + 1e-9 * np.exp(2 * sigma * t)
    sfit, r2, (i0, i1) = mod.fit_growth(t, eke)
    assert i1 > i0
    np.testing.assert_allclose(sfit, sigma, rtol=0.15)
    assert r2 > 0.95


import pytest


@pytest.mark.skipif(
    not int(os.environ.get("GB25_EDDY_TEST", "0")),
    reason="~8 min CPU integration; the 1/4-degree eddy run is queued in "
           "ROADMAP.md (Reach 8) — set GB25_EDDY_TEST=1 to re-run",
)
def test_eke_growth_vs_eady_band():
    """20-day 1-degree integration: EKE must grow by well over noise level
    and the fitted growth rate must land in a generous physical band around
    the Eady estimate (coarse grids under-resolve the deformation radius, so
    the measured rate falls below it; measured ratio ~0.38 at 1 degree)."""
    mod = _probe()
    out = mod.run(nx=360, ny=160, nz=8, dt=900.0, steps=1920, chunk=96)
    assert out["eke_growth_factor"] > 3.0
    assert out["fit_r2"] > 0.9
    assert 0.1 < out["sigma_ratio"] < 1.2


def test_eady_estimate_from_initial_front():
    """sigma_Eady from the benchmark initial condition: positive, finite,
    and on the observed mid-latitude scale (e-folding of days-to-weeks)."""
    mod = _probe()
    grid = simple_latitude_longitude_grid(48, 24, 8, dtype=jnp.float64)
    cfg = baroclinic_instability_config()
    state = baroclinic_instability_state(grid)
    sigma, M2, N2 = mod.eady_growth_rate(grid, state, cfg.eos)
    assert np.isfinite(sigma) and sigma > 0
    assert N2 > 0 and M2 > 0
    efold_days = 1.0 / sigma / 86400.0
    assert 1.0 < efold_days < 60.0
