"""Flagship benchmark setup: the baroclinic-instability ocean model.

Reference: ``GordonBell25.baroclinic_instability_model``
(/root/reference/src/baroclinic_instability_model.jl:17-85) — a
HydrostaticFreeSurfaceModel with SplitExplicitFreeSurface(substeps=30),
TEOS10 seawater buoyancy, spherical Coriolis, WENO vector-invariant momentum
+ WENO-5 tracer advection on the simple lat-lon grid; initial conditions
T = (30 + 1e-3 z) smooth_step(phi), S = -5e-3 z (+ optional noise)
(/root/reference/src/model_utils.jl:83-110), and the random ~1e-3 velocity
seeding used by the correctness scripts
(/root/reference/correctness/correctness_baroclinic_instability_simulation_run.jl).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gb25_tpu.grids import simple_latitude_longitude_grid
from gb25_tpu.models.config import HydrostaticConfig, SplitExplicitFreeSurface
from gb25_tpu.models.state import HydrostaticState, initial_state


def smooth_step(phi):
    """(1 - tanh((|phi| - 40) / 5)) / 2 (reference model_utils.jl:83-87)."""
    return (1.0 - jnp.tanh((jnp.abs(phi) - 40.0) / 5.0)) / 2.0


def baroclinic_instability_config(
    free_surface=None,
    closure=None,
    momentum_advection="weno_vector_invariant",
    tracer_advection="weno5",
    eos=None,
) -> HydrostaticConfig:
    from gb25_tpu.ops.eos import TEOS10EquationOfState
    from gb25_tpu.models.catke import CATKEVerticalDiffusivity
    from gb25_tpu.models.keps import TKEDissipationVerticalDiffusivity

    # reference: tracers chosen from buoyancy type, +e for CATKE, +e,eps for
    # k-epsilon (baroclinic_instability_model.jl:42-57)
    tracers = ("T", "S")
    if isinstance(closure, CATKEVerticalDiffusivity):
        tracers = tracers + ("e",)
    elif isinstance(closure, TKEDissipationVerticalDiffusivity):
        tracers = tracers + ("e", "eps")

    return HydrostaticConfig(
        tracers=tracers,
        momentum_advection=momentum_advection,
        tracer_advection=tracer_advection,
        eos=eos or TEOS10EquationOfState(),
        free_surface=free_surface or SplitExplicitFreeSurface(substeps=30),
        closure=closure,
    )


def baroclinic_instability_state(
    grid, noise_velocity=1e-3, noise_tracer=0.0, seed=42, dtype=None,
    tracers=("T", "S"),
) -> HydrostaticState:
    """Initial state on the given grid (analytic T/S + optional noise)."""
    dtype = dtype or grid.dtype
    state = initial_state(grid, tracers=tracers, dtype=dtype)

    # curvilinear grids carry true 2-D latitudes; lat-lon grids a 1-D profile
    phi2 = getattr(grid, "phi2_c", None)
    if phi2 is not None:
        phi = phi2[:, :, None].astype(dtype)
    else:
        phi = grid.phi_c_i.reshape(1, -1, 1).astype(dtype)
    z = grid.z_c_i.reshape(1, 1, -1).astype(dtype)
    shape = grid.shape

    T = jnp.broadcast_to((30.0 + 1e-3 * z) * smooth_step(phi), shape)
    S = jnp.broadcast_to(-5e-3 * z + 0.0 * phi, shape)

    key = jax.random.PRNGKey(seed)
    ku, kv, kt, ks = jax.random.split(key, 4)
    u = jnp.zeros(shape, dtype)
    v = jnp.zeros(shape, dtype)
    if noise_velocity:
        u = noise_velocity * jax.random.normal(ku, shape, dtype)
        v = noise_velocity * jax.random.normal(kv, shape, dtype)
        v = v.at[:, 0, :].set(0.0)  # southern wall face
    if noise_tracer:
        T = T + noise_tracer * jax.random.uniform(kt, shape, dtype)
        S = S + noise_tracer * jax.random.uniform(ks, shape, dtype)

    new_tracers = dict(state.tracers)
    new_tracers["T"] = T.astype(dtype)
    new_tracers["S"] = S.astype(dtype)
    if "e" in new_tracers:  # seed TKE at its floor
        new_tracers["e"] = jnp.full(shape, 1e-6, dtype)
    if "eps" in new_tracers:
        new_tracers["eps"] = jnp.full(shape, 1e-9, dtype)
    return state.replace(u=u, v=v, tracers=new_tracers)


def balanced_jet_state(
    grid, cfg=None, noise_velocity=1e-3, seed=42, dtype=None,
    tracers=("T", "S"),
) -> HydrostaticState:
    """Thermal-wind-balanced baroclinic jet (round-5 eddy-probe initializer).

    Same analytic T/S front as ``baroclinic_instability_state``, but the
    zonal velocity starts in thermal-wind balance with the front and the
    free surface is set so the bottom flow vanishes:

        p(y,z) = g eta(y) - int_z^0 b dz',    u_g = -(1/f) dp/dy,
        u(-H) = 0  =>  g eta(y) = int_{-H}^0 b dz' (demeaned),
                       u(y,z) = -(1/f) d/dy int_{-H}^z b dz'.

    This removes the geostrophic-adjustment transient of the unbalanced
    init — the transient's w-CFL clamped the eddy probe to dt <= 60 s at
    1/4 degree and contaminated the growth-rate fit window (ROADMAP.md,
    eddy-saturation validation).  ``1/f`` is clamped at |phi| = 10
    deg (the front lives at |phi| ~ 40 deg, where the buoyancy gradient —
    and hence u — is concentrated; near the equator the analytic front is
    flat so the clamped residual is negligible)."""
    import numpy as np

    from gb25_tpu.grids.latlon import EARTH_RADIUS
    from gb25_tpu.models.config import EARTH_ROTATION_RATE

    dtype = dtype or grid.dtype
    cfg = cfg or baroclinic_instability_config()
    state = baroclinic_instability_state(
        grid, noise_velocity=0.0, seed=seed, dtype=dtype, tracers=tracers)

    # balance arithmetic in f64 numpy (init-time only)
    phi_c = np.asarray(grid.phi_c_i, np.float64)          # (Ny,)
    z_c = np.asarray(grid.z_c_i, np.float64)              # (Nz,)
    hz = grid.hz
    dz = np.asarray(grid.dz_c, np.float64).reshape(-1)[hz : hz + grid.Nz]
    T = np.asarray(state.tracers["T"], np.float64)[0]     # (Ny, Nz): x-indep
    S = np.asarray(state.tracers["S"], np.float64)[0]
    b = np.asarray(cfg.eos.buoyancy(T, S, z_c.reshape(1, -1)), np.float64)

    # int_{-H}^{z_k} b dz' at cell centers (midpoint rule)
    B = np.cumsum(b * dz.reshape(1, -1), axis=1)          # (Ny, Nz)
    y_c = EARTH_RADIUS * np.deg2rad(phi_c)
    dBdy = np.gradient(B, y_c, axis=0)

    f = 2.0 * EARTH_ROTATION_RATE * np.sin(np.deg2rad(phi_c))
    f_min = 2.0 * EARTH_ROTATION_RATE * np.sin(np.deg2rad(10.0))
    f_cl = np.where(np.abs(f) < f_min, np.where(f < 0, -f_min, f_min), f)

    u2 = -dBdy / f_cl.reshape(-1, 1)                      # (Ny, Nz)
    eta1 = (B[:, -1] - B[:, -1].mean()) / 9.80665         # (Ny,)

    u = jnp.broadcast_to(jnp.asarray(u2, dtype)[None], grid.shape)
    eta = jnp.broadcast_to(jnp.asarray(eta1, dtype)[None], grid.shape[:2])
    if noise_velocity:
        key = jax.random.PRNGKey(seed)
        ku, kv = jax.random.split(key)
        u = u + noise_velocity * jax.random.normal(ku, grid.shape, dtype)
        v = noise_velocity * jax.random.normal(kv, grid.shape, dtype)
        v = v.at[:, 0, :].set(0.0)
    else:
        v = jnp.zeros(grid.shape, dtype)
    return state.replace(u=u, v=v, eta=eta)


def baroclinic_instability_model(
    Nx, Ny, Nz, halo=(4, 4, 4), dtype=jnp.float32, **config_kw
):
    """Grid + config + initial state for the flagship benchmark."""
    grid = simple_latitude_longitude_grid(Nx, Ny, Nz, halo=halo, dtype=dtype)
    cfg = baroclinic_instability_config(**config_kw)
    state = baroclinic_instability_state(grid)
    return cfg, grid, state
