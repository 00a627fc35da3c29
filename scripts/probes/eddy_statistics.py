"""Eddy-statistics validation: baroclinic-instability growth vs linear theory.

Integrates the flagship baroclinic-instability configuration (the same model
bench.py times; reference /root/reference/src/baroclinic_instability_model.jl)
long enough for the seeded noise to organize into growing baroclinic eddies,
records the volume-mean eddy kinetic energy EKE(t) per chunk, fits the
exponential window, and compares the measured growth rate against the Eady
estimate computed from the *initial* buoyancy field:

    sigma_Eady = 0.31 * M^2 / N        (Eady 1949; Vallis GFD eq. 9.36 form
                                        with thermal-wind shear Lambda = M^2/f)

where N^2 = horizontally-averaged d(b)/dz and M^2 = max |d(b)/dy| at
mid-depth.  During the linear phase EKE ~ exp(2 sigma t), so the fitted
log-EKE slope is 2*sigma_fit.

The coarse grids runnable here under-resolve the deformation radius, so
sigma_fit lands below sigma_Eady; the probe reports the ratio and the test
(tests/test_eddy_statistics.py) asserts a generous physical band rather than
equality.

Usage (the validated configuration, 1 degree, 20 days; its earlier result
and the rerun queued for the GPU are in ROADMAP.md):
    python scripts/probes/eddy_statistics.py --nx 360 --ny 160 --nz 8 \
        --dt 900 --steps 1920 --chunk 96
Prints one JSON line with the series, the fit, and the Eady estimate.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 3)[0])


def eady_growth_rate(grid, state, eos):
    """sigma_Eady = 0.31 M^2 / N from the (interior) initial T/S fields."""
    T = np.asarray(state.tracers["T"], np.float64)
    S = np.asarray(state.tracers["S"], np.float64)
    z = np.asarray(grid.z_c_i, np.float64).reshape(1, 1, -1)
    b = np.asarray(eos.buoyancy(T, S, z), np.float64)

    hy, hz = grid.hy, grid.hz
    dz = np.asarray(grid.dz_c, np.float64).reshape(-1)[hz : hz + grid.Nz]
    dy = np.asarray(grid.dyc, np.float64)[0, hy : hy + grid.Ny, 0]

    # N^2: horizontal-mean stratification, averaged over interior z faces
    bz = np.diff(b, axis=2) / (0.5 * (dz[1:] + dz[:-1]))
    N2 = float(np.mean(bz))
    # M^2: strongest meridional buoyancy gradient at mid-depth (front core)
    kmid = grid.Nz // 2
    by = np.diff(b[:, :, kmid], axis=1) / (0.5 * (dy[1:] + dy[:-1]))
    M2 = float(np.max(np.abs(by)))
    if N2 <= 0:
        return float("nan"), M2, N2
    return 0.31 * M2 / np.sqrt(N2), M2, N2


def fit_growth(times, eke):
    """Exponential-window fit of the linear instability phase.

    The EKE series has three regimes: a geostrophic-adjustment transient
    (decaying), exponential growth, and saturation.  Fit log EKE only on the
    clean growth segment — after EKE has rebounded to 2x its post-adjustment
    minimum (transient decayed) and before it reaches 60% of its peak
    (saturation flattening).  Returns (sigma_fit, r2, (i0, i1))."""
    eke = np.asarray(eke, np.float64)
    times = np.asarray(times, np.float64)
    imin = int(np.argmin(eke))
    tail = eke[imin:]
    peak = float(tail.max())
    lo, hi = 2.0 * float(eke[imin]), 0.6 * peak
    sel = np.nonzero((np.arange(len(eke)) >= imin) & (eke >= lo) & (eke <= hi))[0]
    if sel.size >= 4:
        i0, i1 = int(sel[0]), int(sel[-1])
    else:  # degenerate series (no adjustment dip, or too few samples)
        i0, i1 = imin, len(eke) - 1
    if i1 - i0 < 3:
        i0, i1 = 0, len(eke) - 1
    t, y = times[i0 : i1 + 1], np.log(eke[i0 : i1 + 1])
    A = np.stack([t, np.ones_like(t)], axis=1)
    coef, res, *_ = np.linalg.lstsq(A, y, rcond=None)
    yhat = A @ coef
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return float(coef[0]) / 2.0, r2, (i0, i1)  # EKE ~ exp(2 sigma t)


def run(nx, ny, nz, dt, steps, chunk, dtype="float32", seed=42,
        closure="none", init="front", noise=1e-3):
    import jax
    import jax.numpy as jnp

    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import loop
    from gb25_tpu.models.baroclinic import (
        balanced_jet_state,
        baroclinic_instability_config,
        baroclinic_instability_state,
    )
    from gb25_tpu.utils.diagnostics import eddy_mean_kinetic_energy

    grid = simple_latitude_longitude_grid(nx, ny, nz, dtype=jnp.dtype(dtype))
    # closure choice mirrors the reference's constructor options
    # (/root/reference/src/baroclinic_instability_model.jl:29-31): "none"
    # matches its default; long eddy-resolving integrations need a vertical
    # closure once eddies sharpen fronts to the grid scale (measured round
    # 4: at 1/4 degree the closure-free run NaNs at saturation, day ~8,
    # after 7 days of clean exponential growth), so the validation runs
    # "catke" — the closure the climate configuration uses anyway.
    kwargs = {}
    if closure == "catke":
        from gb25_tpu.models.catke import CATKEVerticalDiffusivity

        kwargs["closure"] = CATKEVerticalDiffusivity()
    elif closure == "scalar":
        from gb25_tpu.models.config import VerticalScalarDiffusivity

        kwargs["closure"] = VerticalScalarDiffusivity()
    cfg = baroclinic_instability_config(**kwargs)
    if init == "balanced":
        # thermal-wind-balanced jet: no geostrophic-adjustment transient,
        # so the fit window starts clean and dt is not clamped by the
        # transient's w-CFL.  Small seed noise buys
        # more e-foldings of clean linear growth before saturation.
        state = balanced_jet_state(grid, cfg, seed=seed, tracers=cfg.tracers,
                                   noise_velocity=noise)
    else:
        state = baroclinic_instability_state(grid, seed=seed,
                                             tracers=cfg.tracers,
                                             noise_velocity=noise)
    sigma_eady, M2, N2 = eady_growth_rate(grid, state, cfg.eos)

    lp = jax.jit(loop, static_argnames="n")
    dke = jax.jit(eddy_mean_kinetic_energy)

    times, ekes, mkes = [], [], []
    dt_a = jnp.asarray(dt, grid.dtype)
    for _ in range(steps // chunk):
        state = lp(cfg, grid, state, dt_a, chunk)
        eke, mke = dke(grid, state)
        times.append(float(state.time))
        ekes.append(float(eke))
        mkes.append(float(mke))
        if not np.isfinite(ekes[-1]):
            break

    # a closure-free run that NaNs at saturation leaves one non-finite
    # tail sample — drop it so the fit sees only the physical series
    while ekes and not np.isfinite(ekes[-1]):
        times.pop(), ekes.pop(), mkes.pop()
    sigma_fit, r2, window = fit_growth(times, ekes)
    try:  # HBM footprint evidence
        from gb25_tpu.utils.profiling import allocator_stats

        alloc = {k: (v if not isinstance(v, dict) else
                     {kk: vv for kk, vv in v.items()
                      if "bytes" in kk or "peak" in kk})
                 for k, v in (allocator_stats() or {}).items()}
    except Exception:
        alloc = None
    return {
        "allocator": alloc,
        "nx": nx, "ny": ny, "nz": nz, "dt": dt, "steps": steps,
        "times_days": [t / 86400.0 for t in times],
        "eke": ekes, "mke": mkes,
        "sigma_eady_per_s": sigma_eady, "M2": M2, "N2": N2,
        "sigma_fit_per_s": sigma_fit, "fit_r2": r2, "fit_window": window,
        "sigma_ratio": sigma_fit / sigma_eady if sigma_eady else None,
        "eke_growth_factor": (max(ekes) / min(ekes)) if ekes else None,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=180)
    p.add_argument("--ny", type=int, default=88)
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--dt", type=float, default=600.0)
    p.add_argument("--steps", type=int, default=1440)
    p.add_argument("--closure", default="none",
                   choices=["none", "scalar", "catke"])
    p.add_argument("--init", default="front", choices=["front", "balanced"],
                   help="front = unbalanced T/S front (reference init); "
                        "balanced = thermal-wind-balanced jet (no "
                        "adjustment transient)")
    p.add_argument("--chunk", type=int, default=60)
    p.add_argument("--noise", type=float, default=1e-3,
                   help="seed velocity noise amplitude (m/s)")
    p.add_argument("--dtype", default="float32")
    args = p.parse_args()

    from gb25_tpu.utils.env import preamble

    preamble()
    out = run(args.nx, args.ny, args.nz, args.dt, args.steps, args.chunk,
              args.dtype, closure=args.closure, init=args.init,
              noise=args.noise)
    out["init"] = args.init
    print(json.dumps(out))


if __name__ == "__main__":
    main()
