"""Batched Thomas solve for the implicit vertical diffusion: a Pallas kernel
for NVIDIA GPUs through Triton (``backend="triton"``).

As a ``lax.scan`` (ops/tridiagonal.py) each solve is 2 x Nz dependent steps
over thin (X, Y) slabs. Here one program solves a block of whole columns:

- **Layout.** The kernel works on level-major (Z, X*Y) arrays, so one
  level of a block of columns is a contiguous, coalesced load. Program
  ``i`` owns columns [i*BLOCK_COLUMNS, (i+1)*BLOCK_COLUMNS); columns past
  the end of the last block are masked. The wrapper transposes the
  (X, Y, Z) fields in and the solutions out; XLA fuses those transposes
  into neighbouring ops where it can. (Loading a level straight from the
  (X, Y, Z) layout is a stride-Z gather: measured 5x slower than the scan
  on an H100, see PERF.md.)
- **Sweeps.** A ``fori_loop`` walks z upwards carrying the previous level's
  c' and d' (and kappa of the face above) in registers; c' and d' of every
  level are written to memory (c' to a scratch output, d' into the
  solution). A second ``fori_loop`` walks down and overwrites d' with x.
- **Shared elimination.** Fields with the same kappa (u with v, T with S)
  solve in one call: c' is computed once, only d' and x repeat per field.

The arithmetic is the scan's, in the same order, so the two agree to
rounding (FMA contraction and division rounding may differ on the GPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Columns per program and warps per program (two columns per thread).
BLOCK_COLUMNS = 256
NUM_WARPS = 4


def _vary_like(arrays, vma):
    """Under ``shard_map`` every operand and output of the call must vary
    over the same mesh axes as the fields."""
    if not vma:
        return arrays
    return [jax.lax.pcast(a, tuple(set(vma) - set(jax.typeof(a).vma)), to="varying")
            for a in arrays]


def thomas_solve(fields, kappa, dt, dz_c, dz_f, damping=None, interpret=False):
    """Solve (1 + dt*damping + lam_k + mu_k) x_k - lam_k x_{k-1} - mu_k x_{k+1}
    = field_k per column, with lam_k = dt kappa_k / (dz_c[k] dz_f[k]) (zero
    at k = 0: no flux through the floor) and mu_k = dt kappa_{k+1} /
    (dz_c[k] dz_f[k+1]) (zero at the top: no flux through the surface).

    fields:  tuple of (X, Y, Z) arrays sharing ``kappa`` (and ``damping``)
    kappa:   (X, Y, Z) diffusivity at bottom faces
    damping: optional (X, Y, Z) linear decay rate
    dz_c, dz_f: vertical spacings, Z values each (any shape of that size)
    Returns a tuple of solutions, one per field.
    """
    fields = tuple(fields)
    nf = len(fields)
    shape = fields[0].shape
    dtype = fields[0].dtype
    Z = shape[-1]
    C = fields[0].size // Z
    dzc = jnp.reshape(dz_c, (Z,)).astype(dtype)
    dzf = jnp.reshape(dz_f, (Z,)).astype(dtype)
    # dz products of the lower and upper face couplings (the upper one is
    # unused at the top level, where mu = 0)
    p_lo = dzc * dzf
    p_up = jnp.concatenate([dzc[:-1] * dzf[1:], jnp.ones((1,), dtype)])
    dt_v = jnp.reshape(jnp.asarray(dt, dtype), (1,))
    has_damping = damping is not None

    def levels(a):  # (X, Y, Z) -> (Z, X*Y)
        return jnp.reshape(jnp.broadcast_to(a, shape).astype(dtype), (C, Z)).T

    def kernel(*refs):
        dt_ref, plo_ref, pup_ref, k_ref = refs[:4]
        d_ref = refs[4] if has_damping else None
        f_refs = refs[4 + has_damping : 4 + has_damping + nf]
        x_refs = refs[4 + has_damping + nf : 4 + has_damping + 2 * nf]
        cp_ref = refs[-1]

        c0 = pl.program_id(0) * BLOCK_COLUMNS  # not readable inside fori_loop
        live = c0 + jnp.arange(BLOCK_COLUMNS, dtype=jnp.int32) < C
        dtv = plgpu.load(dt_ref.at[pl.ds(jnp.int32(0), 1)])

        def level(ref, k):
            return plgpu.load(ref.at[k, pl.ds(c0, BLOCK_COLUMNS)],
                              mask=live, other=0.0)

        def put(ref, k, val):
            plgpu.store(ref.at[k, pl.ds(c0, BLOCK_COLUMNS)], val, mask=live)

        def forward(k, carry):
            kap, cp_prev, dp_prev = carry
            kap_up = jnp.where(k + 1 < Z, level(k_ref, jnp.minimum(k + 1, Z - 1)), 0.0)
            lam = jnp.where(k > 0, dtv * kap / plgpu.load(plo_ref.at[pl.ds(k, 1)]), 0.0)
            mu = dtv * kap_up / plgpu.load(pup_ref.at[pl.ds(k, 1)])
            b = 1.0 + lam + mu
            if has_damping:
                b = b + dtv * level(d_ref, k)
            denom = b + lam * cp_prev
            cp = -mu / denom
            put(cp_ref, k, cp)
            dps = []
            for n in range(nf):
                dp = (level(f_refs[n], k) + lam * dp_prev[n]) / denom
                put(x_refs[n], k, dp)
                dps.append(dp)
            return kap_up, cp, tuple(dps)

        def backward(j, x_next):
            k = Z - 1 - j
            cp = level(cp_ref, k)
            xs = []
            for n in range(nf):
                x = level(x_refs[n], k) - cp * x_next[n]
                put(x_refs[n], k, x)
                xs.append(x)
            return tuple(xs)

        zero = jnp.zeros((BLOCK_COLUMNS,), dtype)
        jax.lax.fori_loop(jnp.int32(0), jnp.int32(Z), forward,
                          (level(k_ref, jnp.int32(0)), zero, (zero,) * nf))
        jax.lax.fori_loop(jnp.int32(0), jnp.int32(Z), backward, (zero,) * nf)

    operands = [dt_v, p_lo, p_up, levels(kappa)]
    if has_damping:
        operands.append(levels(damping))
    operands += [levels(f) for f in fields]
    vma = set()
    for f in fields:
        vma |= set(getattr(jax.typeof(f), "vma", ()))
    operands = _vary_like(operands, vma)
    out_shape = jax.ShapeDtypeStruct((Z, C), dtype, vma=vma) if vma else \
        jax.ShapeDtypeStruct((Z, C), dtype)
    outs = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(C, BLOCK_COLUMNS),),
        out_shape=[out_shape] * (nf + 1),  # the solutions, then c'
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="thomas_solve",
    )(*operands)
    return tuple(jnp.reshape(x.T, shape) for x in outs[:nf])
