"""Seawater equations of state (pure JAX).

Reference capability: GB-25 uses ``SeawaterBuoyancy`` with
``SeawaterPolynomials.TEOS10EquationOfState`` — the 55-term Boussinesq
polynomial fit of TEOS-10 (Roquet, Madec, McDougall & Barker, 2015,
"Accurate polynomial expressions for the density and specific volume of
seawater using the TEOS-10 standard", Ocean Modelling) — see
/root/reference/src/baroclinic_instability_model.jl:24-27.

This module implements the published ``polyTEOS10_bsq`` polynomial directly
(public-standard coefficients, as used by NEMO/GSW), evaluated with reduced
variables and grouped by powers of depth so XLA emits a short fused chain of
FMA-friendly element-wise ops on the VPU.

Conventions: S = absolute salinity [g/kg], T = conservative temperature
[deg C], z = height [m] (negative below the surface). Density in kg/m^3.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

# --- polyTEOS10_bsq reduction constants ---
_SAU = 40.0 * 35.16504 / 35.0
_CTU = 40.0
_ZU = 1.0e4
_DELTAS = 32.0

# Vertical reference profile r0(z) = sum R0k * zz^(k+1), zz = -z/Zu
_R0 = (
    4.6494977072e01,
    -5.2099962525e00,
    2.2601900708e-01,
    6.4326772569e-02,
    1.5616995503e-02,
    -1.7243708991e-03,
)

# Anomaly coefficients EOS[i][j][k] for ss^i tt^j zz^k, flattened as
# (i, j, k, coeff). ss = sqrt((S + deltaS)/SAu), tt = T/CTu.
_EOS = (
    (0, 0, 0, 8.0189615746e02),
    (1, 0, 0, 8.6672408165e02),
    (2, 0, 0, -1.7864682637e03),
    (3, 0, 0, 2.0375295546e03),
    (4, 0, 0, -1.2849161071e03),
    (5, 0, 0, 4.3227585684e02),
    (6, 0, 0, -6.0579916612e01),
    (0, 1, 0, 2.6010145068e01),
    (1, 1, 0, -6.5281885265e01),
    (2, 1, 0, 8.1770425108e01),
    (3, 1, 0, -5.6888046321e01),
    (4, 1, 0, 1.7681814114e01),
    (5, 1, 0, -1.9193502195e00),
    (0, 2, 0, -3.7074170417e01),
    (1, 2, 0, 6.1548258127e01),
    (2, 2, 0, -6.0362551501e01),
    (3, 2, 0, 2.9130021253e01),
    (4, 2, 0, -5.4723692739e00),
    (0, 3, 0, 2.1661789529e01),
    (1, 3, 0, -3.3449108469e01),
    (2, 3, 0, 1.9717078466e01),
    (3, 3, 0, -3.1742946532e00),
    (0, 4, 0, -8.3627885467e00),
    (1, 4, 0, 1.1311538584e01),
    (2, 4, 0, -5.3563304045e00),
    (0, 5, 0, 5.4048723791e-01),
    (1, 5, 0, 4.8169980163e-01),
    (0, 6, 0, -1.9083568888e-01),
    (0, 0, 1, 1.9681925209e01),
    (1, 0, 1, -4.2549998214e01),
    (2, 0, 1, 5.0774768218e01),
    (3, 0, 1, -3.0938076334e01),
    (4, 0, 1, 6.6051753097e00),
    (0, 1, 1, -1.3336301113e01),
    (1, 1, 1, -4.4870114575e00),
    (2, 1, 1, 5.0042598061e00),
    (3, 1, 1, -6.5399043664e-01),
    (0, 2, 1, 6.7080479603e00),
    (1, 2, 1, 3.5063081279e00),
    (2, 2, 1, -1.8795372996e00),
    (0, 3, 1, -2.4649669534e00),
    (1, 3, 1, -5.5077101279e-01),
    (0, 4, 1, 5.5927935970e-01),
    (0, 0, 2, 2.0660924175e00),
    (1, 0, 2, -4.9527603989e00),
    (2, 0, 2, 2.5019633244e00),
    (0, 1, 2, 2.0564311499e00),
    (1, 1, 2, -2.1311365518e-01),
    (0, 2, 2, -1.2419983026e00),
    (0, 0, 3, -2.3342758797e-02),
    (1, 0, 3, -1.8507636718e-02),
    (0, 1, 3, 3.7969820455e-01),
)


def _horner_2d(ss, tt, coeffs_k):
    """Evaluate sum c_ij ss^i tt^j for one power of zz, Horner in tt."""
    # group by j
    by_j = {}
    for i, j, c in coeffs_k:
        by_j.setdefault(j, []).append((i, c))
    jmax = max(by_j)
    out = None
    for j in range(jmax, -1, -1):
        poly_s = 0.0
        if j in by_j:
            # Horner in ss
            imax = max(i for i, _ in by_j[j])
            cs = {i: c for i, c in by_j[j]}
            acc = cs.get(imax, 0.0)
            for i in range(imax - 1, -1, -1):
                acc = acc * ss + cs.get(i, 0.0)
            poly_s = acc
        out = poly_s if out is None else out * tt + poly_s
    return out


def rho_anomaly_teos10(S, T, z):
    """In-situ Boussinesq density r'(S,T,z) [kg/m^3] (without the vertical
    reference profile r0). polyTEOS10_bsq 'rdot'."""
    from gb25_tpu.ops.multifloat import mf_sqrt

    ss = mf_sqrt((S + _DELTAS) / _SAU)
    tt = T / _CTU
    zz = -z / _ZU
    by_k = {}
    for i, j, k, c in _EOS:
        by_k.setdefault(k, []).append((i, j, c))
    out = None
    for k in range(max(by_k), -1, -1):
        term = _horner_2d(ss, tt, by_k[k])
        out = term if out is None else out * zz + term
    return out


def rho_vertical_reference(z):
    """r0(z): depth-only part of polyTEOS10_bsq density."""
    zz = -z / _ZU
    acc = _R0[-1]
    for c in _R0[-2::-1]:
        acc = acc * zz + c
    return acc * zz


def rho_teos10(S, T, z):
    """Total Boussinesq in-situ density rho = r0(z) + r'(S,T,z) [kg/m^3]."""
    return rho_vertical_reference(z) + rho_anomaly_teos10(S, T, z)


@partial(jax.tree_util.register_dataclass, data_fields=[], meta_fields=["rho0", "g"])
@dataclasses.dataclass(frozen=True)
class TEOS10EquationOfState:
    """Buoyancy from the TEOS-10 polynomial: b = -g (rho' - (rho0 - 1000))/rho0.

    Depth-only terms (r0) are omitted — they are dynamically inert (their
    horizontal pressure gradient vanishes) and dropping them preserves f32
    precision, which matters since the model runs in bf16/f32.
    """

    rho0: float = 1020.0
    g: float = 9.80665

    def buoyancy(self, T, S, z):
        rprime = rho_anomaly_teos10(S, T, z)
        return -self.g * (rprime - self.rho0) / self.rho0


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[],
    meta_fields=["alpha", "beta", "T0", "S0", "g"],
)
@dataclasses.dataclass(frozen=True)
class LinearEquationOfState:
    """b = g (alpha (T - T0) - beta (S - S0))."""

    alpha: float = 1.67e-4
    beta: float = 7.80e-4
    T0: float = 10.0
    S0: float = 35.0
    g: float = 9.80665

    def buoyancy(self, T, S, z):
        return self.g * (self.alpha * (T - self.T0) - self.beta * (S - self.S0))
