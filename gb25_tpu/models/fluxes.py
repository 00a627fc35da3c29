"""Air-sea turbulent fluxes: Monin-Obukhov similarity with fixed iterations.

Reference capability: ``SimilarityTheoryFluxes(solver_stop_criteria =
FixedIterations(5))`` + ``Radiation(arch)`` + ``ComponentInterfaces``
(/root/reference/src/data_free_ocean_climate_model.jl:61-66). The fixed
iteration count is what makes the solver trace-friendly (one unrolled/fori
loop, no data-dependent convergence test) — the very property the reference
relies on for Reactant tracing; here it maps to a ``lax.fori_loop``.

Implements a COARE-style bulk algorithm: roughness via Charnock + smooth-flow
viscous term, Businger-Dyer stability functions, gustiness floor; plus
surface radiation balance (shortwave albedo, graybody longwave emission).
All element-wise over (Nx, Ny): XLA fuses them into a few kernels.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax import lax

from gb25_tpu.models.config import static_pytree

VON_KARMAN = 0.4
GRAVITY = 9.80665


@static_pytree
@dataclasses.dataclass(frozen=True)
class SimilarityTheoryFluxes:
    iterations: int = 5          # FixedIterations(5)
    charnock: float = 0.011
    gustiness: float = 0.5       # minimum wind speed scale [m/s]
    measurement_height: float = 10.0
    rho_air: float = 1.225
    cp_air: float = 1004.0
    latent_heat: float = 2.5e6


@static_pytree
@dataclasses.dataclass(frozen=True)
class Radiation:
    """Reference: Radiation(arch) — ocean albedo + emissivity + SB constant."""

    ocean_albedo: float = 0.03
    ocean_emissivity: float = 0.97
    stefan_boltzmann: float = 5.670374419e-8


def saturation_specific_humidity(T, p):
    """Over seawater (98% of pure-water saturation), T in K, p in Pa."""
    Tc = T - 273.15
    es = 611.2 * jnp.exp(17.67 * Tc / jnp.maximum(Tc + 243.5, 1.0))  # Pa
    return 0.98 * 0.622 * es / jnp.maximum(p - 0.378 * es, 1e3)


def _psi_m(zeta):
    """Businger-Dyer momentum stability function."""
    zeta = jnp.clip(zeta, -10.0, 10.0)
    x = (1.0 - 16.0 * jnp.minimum(zeta, 0.0)) ** 0.25
    unstable = (
        2.0 * jnp.log((1.0 + x) / 2.0)
        + jnp.log((1.0 + x * x) / 2.0)
        - 2.0 * jnp.arctan(x)
        + jnp.pi / 2.0
    )
    stable = -5.0 * zeta
    return jnp.where(zeta < 0.0, unstable, stable)


def _psi_h(zeta):
    """Businger-Dyer scalar stability function."""
    zeta = jnp.clip(zeta, -10.0, 10.0)
    x = (1.0 - 16.0 * jnp.minimum(zeta, 0.0)) ** 0.25
    unstable = 2.0 * jnp.log((1.0 + x * x) / 2.0)
    stable = -5.0 * zeta
    return jnp.where(zeta < 0.0, unstable, stable)


def similarity_fluxes(cfg: SimilarityTheoryFluxes, atmos, To_K, uo, vo):
    """Turbulent fluxes from regridded atmosphere fields + ocean surface state.

    atmos: dict with Ta (K), ua, va, qa, pa on ocean centers (Nx, Ny).
    To_K: ocean surface temperature (K); uo, vo: surface currents at centers.
    Returns dict: tau_x, tau_y [N/m^2], Q_sensible, Q_latent [W/m^2,
    positive = ocean heating], evaporation [kg/m^2/s].
    """
    kappa = VON_KARMAN
    h = cfg.measurement_height
    nu_air = 1.5e-5

    du = atmos["ua"] - uo
    dv = atmos["va"] - vo
    qs = saturation_specific_humidity(To_K, atmos["pa"])
    dtheta = atmos["Ta"] - To_K
    dq = atmos["qa"] - qs
    Tv = atmos["Ta"] * (1.0 + 0.61 * atmos["qa"])

    U = jnp.sqrt(du * du + dv * dv + cfg.gustiness**2)

    def body(_, carry):
        ustar, tstar, qstar = carry
        ustar = jnp.maximum(ustar, 1e-4)
        # Obukhov length
        bstar = (GRAVITY / Tv) * (tstar + 0.61 * Tv * qstar / (1.0 + 0.61 * atmos["qa"]))
        Linv = kappa * bstar / (ustar * ustar)
        zeta = jnp.clip(h * Linv, -10.0, 10.0)
        # roughness lengths (Charnock + smooth)
        z0 = cfg.charnock * ustar * ustar / GRAVITY + 0.11 * nu_air / ustar
        z0 = jnp.clip(z0, 1e-8, 1.0)
        z0t = jnp.clip(0.4 * nu_air / ustar, 1e-9, 1e-2)
        lnm = jnp.log(h / z0) - _psi_m(zeta) + _psi_m(z0 / h * zeta)
        lnh = jnp.log(h / z0t) - _psi_h(zeta) + _psi_h(z0t / h * zeta)
        ustar_new = kappa * U / jnp.maximum(lnm, 1.0)
        tstar_new = kappa * dtheta / jnp.maximum(lnh, 1.0)
        qstar_new = kappa * dq / jnp.maximum(lnh, 1.0)
        return (ustar_new, tstar_new, qstar_new)

    # neutral first guess
    ustar0 = kappa * U / jnp.log(h / 1e-4)
    init = (ustar0, jnp.zeros_like(U), jnp.zeros_like(U))
    ustar, tstar, qstar = lax.fori_loop(0, cfg.iterations, body, init)

    rho = cfg.rho_air
    tau = rho * ustar * ustar
    tau_x = tau * du / U
    tau_y = tau * dv / U
    Q_sens = rho * cfg.cp_air * ustar * tstar
    evap = -rho * ustar * qstar  # positive = ocean loses water
    Q_lat = -cfg.latent_heat * evap
    return {
        "tau_x": tau_x, "tau_y": tau_y,
        "Q_sensible": Q_sens, "Q_latent": Q_lat,
        "evaporation": evap,
        "u_star": ustar,
    }


def radiative_fluxes(rad: Radiation, atmos, To_K):
    """Net radiative heating of the ocean surface [W/m^2, positive = heating]."""
    sw = (1.0 - rad.ocean_albedo) * atmos["Qsw"]
    lw = rad.ocean_emissivity * (atmos["Qlw"] - rad.stefan_boltzmann * To_K**4)
    return sw + lw
