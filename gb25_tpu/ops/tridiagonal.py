"""Column-wise tridiagonal solves for vertically-implicit diffusion.

Reference capability: ``VerticalScalarDiffusivity(VerticallyImplicitTimeDiscretization())``
and the implicit halves of CATKE/k-epsilon closures
(/root/reference/src/baroclinic_instability_model.jl:29-31). The reference
solves batched tridiagonal systems per column on GPU. Here the plain
reference is the Thomas algorithm as a ``lax.scan`` over the (small) z extent
with whole (x, y) slabs per level; on a CUDA device the same recurrence runs
as one Pallas-Triton kernel over blocks of columns (ops/thomas_triton.py).
``implicit_vertical_diffusion`` chooses between them by platform alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve_tridiagonal(a, b, c, d):
    """Solve tridiagonal systems along the LAST axis.

    a: subdiagonal   (same shape as d; a[..., 0] ignored)
    b: diagonal
    c: superdiagonal (c[..., -1] ignored)
    d: right-hand side
    Returns x with b x + a x_{k-1} + c x_{k+1} = d per column.
    """
    a = jnp.moveaxis(jnp.broadcast_to(a, d.shape), -1, 0)
    b = jnp.moveaxis(jnp.broadcast_to(b, d.shape), -1, 0)
    c = jnp.moveaxis(jnp.broadcast_to(c, d.shape), -1, 0)
    dd = jnp.moveaxis(d, -1, 0)

    # Forward elimination: c'_k = c_k / (b_k - a_k c'_{k-1});
    # d'_k = (d_k - a_k d'_{k-1}) / (b_k - a_k c'_{k-1})
    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        ak, bk, ck, dk = inp
        denom = bk - ak * cp_prev
        cp = ck / denom
        dp = (dk - ak * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(dd[0])
    (_, _), (cps, dps) = jax.lax.scan(fwd, (zeros, zeros), (a, b, c, dd))

    # Back substitution: x_k = d'_k - c'_k x_{k+1}
    def bwd(x_next, inp):
        cp, dp = inp
        x = dp - cp * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, zeros, (cps, dps), reverse=True)
    return jnp.moveaxis(xs, 0, -1)


def implicit_vertical_diffusion(field, kappa_face, dt, dz_c, dz_f, damping=None):
    """Backward-Euler vertical diffusion solve on interior-only arrays.

    Solves (I + dt*damping - dt d/dz kappa d/dz) psi_new = psi with zero-flux
    top/bottom. ``damping`` (optional, per-cell rate >= 0, 1/s) adds a linear
    implicit decay term — used for the stiff TKE dissipation in CATKE/k-eps
    (explicit e^{3/2} dissipation overshoots at long dt; treating it as an
    implicit linearized decay lam = C_D sqrt(e)/ell is the standard cure and
    what the reference's closures do).

    field:      (Nx, Ny, Nz) interior array, or a tuple of such arrays that
                share ``kappa_face``/``damping`` (a tuple is returned)
    kappa_face: diffusivity at z-faces, broadcastable to (Nx, Ny, Nz);
                entry k is the *bottom* face of cell k; the flux through the
                bottom of cell 0 and the (virtual) top face are zero.
    dz_c:       (1, 1, Nz) cell thicknesses (interior)
    dz_f:       (1, 1, Nz) center-to-center spacings at bottom faces (interior)

    The solver is chosen when the program is lowered, by the platform it is
    lowered for: the Triton kernel on CUDA, the scan everywhere else.
    """
    from gb25_tpu.ops.thomas_triton import thomas_solve

    single = not isinstance(field, (tuple, list))
    fields = (field,) if single else tuple(field)
    out = jax.lax.platform_dependent(
        cuda=lambda: thomas_solve(fields, kappa_face, dt, dz_c, dz_f, damping),
        default=lambda: tuple(
            scan_vertical_diffusion(f, kappa_face, dt, dz_c, dz_f, damping)
            for f in fields),
    )
    return out[0] if single else tuple(out)


def scan_vertical_diffusion(field, kappa_face, dt, dz_c, dz_f, damping=None):
    """The plain reference: ``implicit_vertical_diffusion`` for one field as
    a ``lax.scan`` Thomas solve."""
    Nz = field.shape[-1]
    kap = jnp.broadcast_to(kappa_face, field.shape)
    dzc = jnp.broadcast_to(dz_c, field.shape)
    dzf = jnp.broadcast_to(dz_f, field.shape)

    # lower-face coupling lam_k = dt * kappa_k / (dz_c[k] * dz_f[k])
    lam = dt * kap / (dzc * dzf)
    lam = lam.at[..., 0].set(0.0)  # no flux through the sea floor
    # upper-face coupling mu_k = dt * kappa_{k+1} / (dz_c[k] * dz_f[k+1])
    kap_up = jnp.concatenate([kap[..., 1:], jnp.zeros_like(kap[..., :1])], axis=-1)
    dzf_up = jnp.concatenate([dzf[..., 1:], jnp.ones_like(dzf[..., :1])], axis=-1)
    mu = dt * kap_up / (dzc * dzf_up)
    mu = mu.at[..., Nz - 1].set(0.0)  # no flux through the surface

    a = -lam
    c = -mu
    b = 1.0 + lam + mu
    if damping is not None:
        b = b + dt * damping
    return solve_tridiagonal(a, b, c, field)
