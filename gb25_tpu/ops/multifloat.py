"""Multi-limb floating-point emulation (MultiFloatOptions analog).

Reference capability: GB-25 maps ``--limbs/--target-float-type`` to
``Reactant.MultiFloatOptions`` so tendency compute can run at an emulated
precision different from the storage precision
(/root/reference/src/arg_parsing.jl:99-107).  The analog here is a
two-limb ("double-double" style) value type carried through the *same*
tendency physics (``tendency_math`` et al.) via operator overloading:

- ``f32x2``  — true double-single arithmetic (error-free transforms: Knuth
  two-sum, Dekker split two-prod).  Float64 runs at a fraction of the
  float32 rate on most accelerators; this emulates ~2^-48 relative
  precision from f32 hardware ops — the interesting
  direction for an ocean model whose reference runs Float64 on CPU/GPU.
- ``bf16x2`` — paired-bf16 storage limbs; each operation promotes the pair
  to f32 (exact: the limbs are non-overlapping, <= 17 mantissa bits total),
  computes in f32, and re-splits on store, giving ~2^-16 relative precision.
  This is a storage/parity format (same bytes as f32); it exists to
  mirror the reference's limbs=2 low-precision experiments.

The limb arrays form a JAX pytree, so ``TwoFloat`` values flow through
``jit``/``shard_map``/``scan`` unchanged.  The handful of non-operator
array functions the tendency cone uses (where/roll/concatenate/...) are
dispatched through the ``mf_*`` helpers below, which are transparent for
plain arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SPLIT_CONST = {jnp.dtype(jnp.float32): 4097.0}  # 2^12 + 1 (Dekker split)


def _two_sum(a, b):
    """Knuth two-sum: s + err == a + b exactly (branch-free)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _quick_two_sum(a, b):
    """Fast two-sum, requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Dekker split of an f32 into two non-overlapping 12-bit halves."""
    c = _SPLIT_CONST[jnp.dtype(jnp.float32)] * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + err == a * b exactly (Dekker, no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


@jax.tree_util.register_pytree_node_class
class TwoFloat:
    """A value represented as the unevaluated sum ``hi + lo`` of two limbs.

    ``hi`` carries the leading bits, ``lo`` the rounding remainder;
    the limbs never overlap (|lo| <= ulp(hi)/2).
    """

    __array_priority__ = 100  # our __r*__ wins over np/jnp operands

    def __init__(self, hi, lo):
        self.hi = hi
        self.lo = lo

    # --- pytree protocol ---
    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # --- construction / extraction ---
    @staticmethod
    def from_array(x, limb_dtype=jnp.float32):
        """Split ``x`` into two limbs.  float64 *numpy* inputs (trace-time
        grid metrics) are split in numpy so the lo limb keeps the extra bits
        even when JAX x64 is disabled."""
        import numpy as np

        limb = jnp.dtype(limb_dtype)
        if isinstance(x, (float, int)):
            x = np.float64(x)
        if (
            isinstance(x, (np.ndarray, np.floating))
            and np.asarray(x).dtype == np.float64
            and limb == jnp.float32
        ):
            x = np.asarray(x)
            hi = x.astype(np.float32)
            lo = (x - hi).astype(np.float32)
            return TwoFloat(jnp.asarray(hi), jnp.asarray(lo))
        if getattr(x, "dtype", None) == jnp.float64 and limb == jnp.float32:
            # traced f64 JAX array (jax_enable_x64): split in-graph so the
            # lo limb keeps the extra bits instead of a silent downcast
            hi = x.astype(jnp.float32)
            lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
            return TwoFloat(hi, lo)
        xw = jnp.asarray(x, jnp.float32)
        hi = xw.astype(limb)
        lo = (xw - hi.astype(jnp.float32)).astype(limb)
        return TwoFloat(hi, lo)

    def to_array(self, dtype=jnp.float32):
        return (self.hi.astype(jnp.float32) + self.lo.astype(jnp.float32)).astype(dtype)

    # --- metadata ---
    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    @property
    def dtype(self):
        return self.hi.dtype

    def _is_bf16(self):
        return self.hi.dtype == jnp.bfloat16

    def _f32pair(self):
        return self.hi.astype(jnp.float32), self.lo.astype(jnp.float32)

    @staticmethod
    def _restore(hi32, lo32, bf16):
        """Renormalize an (hi, err) f32 pair into the output limb format."""
        if bf16:
            s = hi32 + lo32
            h = s.astype(jnp.bfloat16)
            return TwoFloat(h, (s - h.astype(jnp.float32)).astype(jnp.bfloat16))
        h, l = _quick_two_sum(hi32, lo32)
        return TwoFloat(h, l)

    def _coerce(self, other):
        if isinstance(other, TwoFloat):
            return other
        return TwoFloat.from_array(other, self.hi.dtype)

    # --- arithmetic ---
    def __add__(self, other):
        o = self._coerce(other)
        bf = self._is_bf16()
        ah, al = self._f32pair()
        bh, bl = o._f32pair()
        if bf:
            return TwoFloat._restore((ah + al) + (bh + bl),
                                     jnp.zeros_like(ah), True)
        s, e = _two_sum(ah, bh)
        e = e + (al + bl)
        return TwoFloat._restore(s, e, False)

    __radd__ = __add__

    def __neg__(self):
        return TwoFloat(-self.hi, -self.lo)

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        o = self._coerce(other)
        bf = self._is_bf16()
        ah, al = self._f32pair()
        bh, bl = o._f32pair()
        if bf:
            # limb pairs are exact in f32: one f32 multiply is the whole op
            return TwoFloat._restore((ah + al) * (bh + bl),
                                     jnp.zeros_like(ah), True)
        p, e = _two_prod(ah, bh)
        e = e + (ah * bl + al * bh)
        return TwoFloat._restore(p, e, False)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        bf = self._is_bf16()
        ah, al = self._f32pair()
        bh, bl = o._f32pair()
        if bf:
            return TwoFloat._restore((ah + al) / (bh + bl),
                                     jnp.zeros_like(ah), True)
        q1 = ah / bh
        # r = self - q1 * o, computed exactly to leading order
        p, pe = _two_prod(q1, bh)
        rh = ((ah - p) - pe) + al - q1 * bl
        q2 = rh / bh
        return TwoFloat._restore(q1, q2, False)

    def __rtruediv__(self, other):
        return self._coerce(other) / self

    def __pow__(self, n):
        if n == 2:
            return self * self
        out = self
        for _ in range(int(n) - 1):
            out = out * self
        return out

    # --- comparisons (on the evaluated value; results are plain bools) ---
    def _val(self):
        return self.hi.astype(jnp.float32) + self.lo.astype(jnp.float32)

    def _cmp_other(self, other):
        if isinstance(other, TwoFloat):
            return other._val()
        return other

    def __gt__(self, other):
        return self._val() > self._cmp_other(other)

    def __lt__(self, other):
        return self._val() < self._cmp_other(other)

    def __ge__(self, other):
        return self._val() >= self._cmp_other(other)

    def __le__(self, other):
        return self._val() <= self._cmp_other(other)

    # --- indexing / shaping ---
    def __getitem__(self, idx):
        return TwoFloat(self.hi[idx], self.lo[idx])

    def astype(self, dtype):
        return self.to_array(dtype)

    def reshape(self, *shape):
        return TwoFloat(self.hi.reshape(*shape), self.lo.reshape(*shape))


def _limbwise(f):
    def apply(a, *args, **kw):
        return TwoFloat(f(a.hi, *args, **kw), f(a.lo, *args, **kw))

    return apply


def is_twofloat(x):
    return isinstance(x, TwoFloat)


# --- dispatched array functions (transparent for plain arrays) ---

def mf_roll(a, shift, axis):
    if is_twofloat(a):
        return _limbwise(jnp.roll)(a, shift, axis=axis)
    return jnp.roll(a, shift, axis=axis)


def mf_where(cond, a, b):
    if is_twofloat(a) or is_twofloat(b):
        if not is_twofloat(a):
            a = b._coerce(a)
        if not is_twofloat(b):
            b = a._coerce(b)
        return TwoFloat(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))
    return jnp.where(cond, a, b)


def mf_zeros_like(a):
    if is_twofloat(a):
        return TwoFloat(jnp.zeros_like(a.hi), jnp.zeros_like(a.lo))
    return jnp.zeros_like(a)


def mf_concatenate(arrs, axis):
    if any(is_twofloat(a) for a in arrs):
        arrs = [a if is_twofloat(a) else TwoFloat.from_array(a) for a in arrs]
        return TwoFloat(
            jnp.concatenate([a.hi for a in arrs], axis=axis),
            jnp.concatenate([a.lo for a in arrs], axis=axis),
        )
    return jnp.concatenate(arrs, axis=axis)


def _dd_scan_add(x, y):
    """Double-single addition as an associative-scan combiner on limb pairs."""
    s, e = _two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return _quick_two_sum(s, e)


def mf_cumsum(a, axis):
    """Cumulative sum.  f32 limbs: a double-single associative scan, so the
    partial sums keep ~2^-48 relative error (limb-wise f32 cumsums would
    re-round every partial sum to f32 and cap the whole pipeline at f32
    quality).  bf16 limbs: promoted f32 cumsum, renormalized."""
    if is_twofloat(a):
        if a._is_bf16():
            hi = jnp.cumsum(a.hi.astype(jnp.float32), axis=axis)
            lo = jnp.cumsum(a.lo.astype(jnp.float32), axis=axis)
            return TwoFloat._restore(hi, lo, True)
        hi, lo = jax.lax.associative_scan(_dd_scan_add, (a.hi, a.lo), axis=axis)
        return TwoFloat(hi, lo)
    return jnp.cumsum(a, axis=axis)


def mf_sum(a, axis=None, keepdims=False):
    """Reduction at two-limb precision (via the double-single scan)."""
    if is_twofloat(a):
        if axis is None:  # full reduction: successive single-axis scans
            r = a
            for ax in reversed(range(a.ndim)):
                r = mf_sum(r, axis=ax, keepdims=keepdims)
            return r
        c = mf_cumsum(a, axis)
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(-1, None) if keepdims else -1
        return c[tuple(idx)]
    return jnp.sum(a, axis=axis, keepdims=keepdims)


def mf_sqrt(a):
    if is_twofloat(a):
        if a._is_bf16():
            return TwoFloat._restore(jnp.sqrt(a._val()), jnp.zeros_like(a.hi,
                                     dtype=jnp.float32), True)
        y = jnp.sqrt(a.hi)
        # one Newton step in double-single: y + (a - y^2) / (2 y)
        p, pe = _two_prod(y, y)
        r = ((a.hi - p) - pe) + a.lo
        return TwoFloat._restore(y, r / (2.0 * y), False)
    return jnp.sqrt(a)


def mf_broadcast_to(a, shape):
    if is_twofloat(a):
        return TwoFloat(jnp.broadcast_to(a.hi, shape), jnp.broadcast_to(a.lo, shape))
    return jnp.broadcast_to(a, shape)


def wrap_compute(x, compute_dtype):
    """Wrap an array (or pass through) for the configured multifloat mode."""
    limb = jnp.bfloat16 if compute_dtype == "bf16x2" else jnp.float32
    return TwoFloat.from_array(x, limb)


def unwrap_compute(x, dtype):
    return x.to_array(dtype) if is_twofloat(x) else x.astype(dtype)
