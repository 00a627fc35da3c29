"""WENO-5 (Jiang & Shu) upwind reconstruction on halo-extended arrays.

Reference capability: GB-25's benchmark model uses ``WENO(order=5)`` tracer
advection and ``WENOVectorInvariant(order=5)`` momentum advection
(/root/reference/src/baroclinic_instability_model.jl:38-39). Here the 5th
order weighted-ENO reconstruction is written as shape-preserving shifted
arithmetic over the extended arrays — a handful of fused VPU element-wise ops
per direction, which XLA fuses into the surrounding tendency computation.

Two alignments cover the staggered grid:
  - ``align="face"``  : reconstruct at face ``i`` (between cells i-1 and i)
                        from cell-centered data (tracer fluxes);
  - ``align="center"``: reconstruct at center ``j`` (between faces j and j+1)
                        from face-centered data (vorticity in the
                        vector-invariant momentum scheme).

Each returns the pair (biased-from-below, biased-from-above); callers select
by the sign of the advecting velocity.
"""

from __future__ import annotations

import jax.numpy as jnp

from gb25_tpu.ops.multifloat import mf_where
from gb25_tpu.ops.stencils import sm, sp


def _positive(vel):
    """Upwind sign test, compared at f32 for bf16 velocities."""
    if getattr(vel, "dtype", None) == jnp.bfloat16:
        vel = vel.astype(jnp.float32)
    return vel > 0.0

# Optimal linear weights for the downwind->upwind candidate stencils.
_G0, _G1, _G2 = 0.1, 0.6, 0.3
_C13 = 13.0 / 12.0


def _weno5_from_shifts(m2, m1, s0, p1, p2, eps):
    """WENO-5 reconstruction at the point half a cell *right* of ``s0``'s
    sample, from the 5 upwind-ordered samples (m2 farthest upwind).

    The nonlinear weights are evaluated division-free up to a single final
    divide: with t_i = (b_i + eps)^2, the weighted sum
    (sum g_i q_i / t_i) / (sum g_i / t_i) is multiplied through by
    t0 t1 t2, leaving one division instead of four.  Range safety in f32: t_i >= eps^2 = 1e-12, so the
    pairwise products (>= 1e-24) and the denominator (>= g_i eps^4 ~ 1e-25)
    stay far above the f32 flush-to-zero threshold (~1e-38).  Upper bound:
    t_i ~ (sample jump)^4, so the pairwise products grow like jump^8 and
    overflow f32 (inf -> NaN weights) once |jump| exceeds ~6e4 field units —
    the per-stencil-divide form stayed finite to far larger magnitudes.
    Oceanic fields (|u| < 1e2, |T| < 1e2) sit ~3 orders below the bound.

    Factored algebra (default; kill switch GB25_WENO_FACTORED=0): the
    candidate polynomials and smoothness indicators are rebuilt from the
    four first differences d1..d4 of the samples — e.g.
    q0 = s0 + (5 d2 - 2 d1)/6 and beta0 = C13 (d2-d1)^2 + 1/4 (X0+2 d2)^2 —
    saving ~14 flops per reconstruction point with no extra shifts or
    selects (a precomputed-shared-field variant was measured SLOWER: the
    shifted reads cost more than the arithmetic they saved).  Values agree
    with the textbook form to reassociation roundoff, not bitwise."""
    sixth = 1.0 / 6.0  # multiply, not divide
    if not _use_factored():
        q0 = (2.0 * m2 - 7.0 * m1 + 11.0 * s0) * sixth
        q1 = (-m1 + 5.0 * s0 + 2.0 * p1) * sixth
        q2 = (2.0 * s0 + 5.0 * p1 - p2) * sixth
        b0 = _C13 * (m2 - 2.0 * m1 + s0) ** 2 + 0.25 * (m2 - 4.0 * m1 + 3.0 * s0) ** 2
        b1 = _C13 * (m1 - 2.0 * s0 + p1) ** 2 + 0.25 * (m1 - p1) ** 2
        b2 = _C13 * (s0 - 2.0 * p1 + p2) ** 2 + 0.25 * (3.0 * s0 - 4.0 * p1 + p2) ** 2
    else:
        d1 = m1 - m2
        d2 = s0 - m1
        d3 = p1 - s0
        d4 = p2 - p1
        q0 = s0 + (5.0 * d2 - 2.0 * d1) * sixth
        q1 = s0 + (d2 + 2.0 * d3) * sixth
        q2 = s0 + (4.0 * d3 - d4) * sixth
        x0 = d2 - d1                 # m2 - 2 m1 + s0
        x1 = d3 - d2                 # m1 - 2 s0 + p1
        x2 = d4 - d3                 # s0 - 2 p1 + p2
        y1 = d2 + d3                 # p1 - m1 (squared, sign-free)
        b0 = _C13 * x0 * x0 + 0.25 * (x0 + 2.0 * d2) ** 2
        b1 = _C13 * x1 * x1 + 0.25 * y1 * y1
        b2 = _C13 * x2 * x2 + 0.25 * (x2 - 2.0 * d3) ** 2
    t0 = (b0 + eps) ** 2
    t1 = (b1 + eps) ** 2
    t2 = (b2 + eps) ** 2
    w0 = _G0 * (t1 * t2)
    w1 = _G1 * (t0 * t2)
    w2 = _G2 * (t0 * t1)
    return (w0 * q0 + w1 * q1 + w2 * q2) / (w0 + w1 + w2)


def _use_factored() -> bool:
    import os

    return bool(int(os.environ.get("GB25_WENO_FACTORED", "1")))


def weno5(a, axis: str, align: str = "face", eps: float = 1e-6):
    """Return ``(from_below, from_above)`` WENO-5 reconstructions.

    ``from_below`` is the upwind reconstruction when the advecting velocity is
    positive (flow from smaller indices), ``from_above`` when negative.

    align="face":   output index i sits between data[i-1] and data[i].
    align="center": output index j sits between data[j] and data[j+1].
    """
    # Offset of the data sample immediately *below* the reconstruction point.
    lo = 1 if align == "face" else 0  # data index = out_index - lo

    def at(off):
        # data value at out_index - lo + off
        k = off - lo
        return sp(a, axis, k) if k >= 0 else sm(a, axis, -k)

    below = _weno5_from_shifts(at(-2), at(-1), at(0), at(1), at(2), eps)
    above = _weno5_from_shifts(at(3), at(2), at(1), at(0), at(-1), eps)
    return below, above


def weno5_upwind(a, vel, axis: str, align: str = "face", eps: float = 1e-6):
    """Upwind WENO-5 reconstruction of ``a`` at the location of ``vel``.

    ``vel`` must already live at the reconstruction points (faces for
    align="face", centers for align="center").

    Select-then-reconstruct: the upwind choice commutes with the (pointwise)
    reconstruction, so the five stencil *samples* are selected by the wind
    direction first and ONE reconstruction runs — bitwise identical to
    reconstructing both sides and selecting, at ~55 instead of ~110 flops
    per face.
    """
    lo = 1 if align == "face" else 0

    def at(off):
        k = off - lo
        return sp(a, axis, k) if k >= 0 else sm(a, axis, -k)

    pos = _positive(vel)
    # below-ordering (m2..p2) vs the mirrored above-ordering (p3..m1)
    m2 = mf_where(pos, at(-2), at(3))
    m1 = mf_where(pos, at(-1), at(2))
    s0 = mf_where(pos, at(0), at(1))
    p1 = mf_where(pos, at(1), at(0))
    p2 = mf_where(pos, at(2), at(-1))
    return _weno5_from_shifts(m2, m1, s0, p1, p2, eps)


def centered2(a, axis: str, align: str = "face"):
    """2nd-order centered reconstruction with the same alignment conventions."""
    if align == "face":
        return 0.5 * (a + sm(a, axis))
    return 0.5 * (a + sp(a, axis))


def upwind1(a, vel, axis: str, align: str = "face"):
    """1st-order upwind (donor cell) reconstruction."""
    if align == "face":
        below, above = sm(a, axis), a
    else:
        below, above = a, sp(a, axis)
    return mf_where(_positive(vel), below, above)
