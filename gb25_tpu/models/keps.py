"""k-epsilon vertical mixing closure (prognostic TKE + dissipation).

Reference capability: ``TKEDissipationVerticalDiffusivity`` — adds tracers
``e`` (TKE) and ``eps`` (dissipation), carries diffusivities (kappa_u,
kappa_c, kappa_e, kappa_eps) solved vertically-implicitly
(/root/reference/src/baroclinic_instability_model.jl:52-54;
src/correctness.jl:60-76 lists the k-epsilon diffusivity fields).

Standard two-equation closure (Rodi 1987 constants):
    de/dt   = P + B - eps
    deps/dt = (eps/e) (C1 P + C3 B - C2 eps)
    kappa_u = C_mu e^2 / eps;  kappa_c = kappa_u / sigma_c; etc.
All element-wise per column; the implicit diffusion reuses the batched
Thomas scan.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from gb25_tpu.models.config import static_pytree


@static_pytree
@dataclasses.dataclass(frozen=True)
class TKEDissipationVerticalDiffusivity:
    """k-epsilon closure. Adds tracers ``e`` [m^2/s^2] and ``eps`` [m^2/s^3]."""

    C_mu: float = 0.09
    C_eps1: float = 1.44
    C_eps2: float = 1.92
    C_eps3_stable: float = -0.63
    C_eps3_unstable: float = 1.0
    sigma_c: float = 1.0     # Prandtl number for tracers
    sigma_k: float = 1.0     # Schmidt number for e
    sigma_eps: float = 1.3   # Schmidt number for eps
    e_min: float = 1e-7
    eps_min: float = 1e-10
    kappa_max: float = 10.0

    @property
    def tracer_names(self):
        return ("e", "eps")


def keps_diffusivities(closure, grid, ue, ve, be, ee, epse):
    """Diffusivities + (G_e, G_eps) sources from extended fields."""
    return keps_math(closure, ue, ve, be, ee, epse, grid.dz_f)


def keps_math(closure, ue, ve, be, ee, epse, dzf):
    """The k-epsilon formulation as a pure function of halo-extended
    (X, Y, Z) arrays, like ``catke_math``."""
    from gb25_tpu.ops.stencils import dz_f as d_zf, i_f, ix_c, iy_c, iz_c
    N2 = d_zf(be) / dzf
    dudz = d_zf(ue) / dzf
    dvdz = d_zf(ve) / dzf
    S2 = ix_c(dudz * dudz) + iy_c(dvdz * dvdz)  # at z-faces (tracer columns)

    e_pos = jnp.maximum(ee, closure.e_min)
    eps_pos = jnp.maximum(epse, closure.eps_min)

    kap_u_c = jnp.minimum(closure.C_mu * e_pos * e_pos / eps_pos, closure.kappa_max)
    kap_u = i_f(kap_u_c, "z")
    kap_c = kap_u / closure.sigma_c
    kap_e = kap_u / closure.sigma_k
    kap_eps = kap_u / closure.sigma_eps

    P = iz_c(kap_u * S2)   # shear production at centers
    B = -iz_c(kap_c * N2)  # buoyancy flux at centers
    G_e = P + B - eps_pos

    C3 = jnp.where(B > 0.0, closure.C_eps3_unstable, closure.C_eps3_stable)
    G_eps = (eps_pos / e_pos) * (
        closure.C_eps1 * P + C3 * B - closure.C_eps2 * eps_pos
    )
    return kap_u, kap_c, kap_e, kap_eps, G_e, G_eps
