"""Shape-preserving staggered-grid stencil primitives.

All operators act on *halo-extended* ``(X, Y, Z)`` arrays and preserve shape:
shifts are ``jnp.roll`` (XLA lowers these to cheap slice+concat; inside
``shard_map`` they are purely local because halos were materialized first).
Values within ``r`` cells of the extended edge are garbage after a stencil of
radius ``r`` — the model tracks the halo budget and crops to the interior at
the end of each stage, exactly like the reference's halo discipline
(reference: Oceananigans operators + fill_halo_regions!; see
/root/reference/src/precompile.jl:31-42 for the stage structure).

Index convention (matches gb25_tpu.grids):
  - face ``i`` is the *west/south/bottom* face of cell ``i``;
  - ``_f`` suffix: result lives on faces (center -> face operations);
  - ``_c`` suffix: result lives on centers (face -> center operations).
"""

from __future__ import annotations

import jax.numpy as jnp

from gb25_tpu.ops.multifloat import mf_roll

_AXIS = {"x": 0, "y": 1, "z": 2}  # named axis -> array dimension


def sm(a, axis, n=1):
    """Value at index ``i - n`` along axis (shift 'minus')."""
    if n == 0:
        return a
    return mf_roll(a, n, axis=_AXIS[axis])


def sp(a, axis, n=1):
    """Value at index ``i + n`` along axis (shift 'plus')."""
    if n == 0:
        return a
    return mf_roll(a, -n, axis=_AXIS[axis])


# --- differences ---
def d_f(a, axis):
    """center -> face difference: out[i] = a[i] - a[i-1]."""
    return a - sm(a, axis)


def d_c(a, axis):
    """face -> center difference: out[i] = a[i+1] - a[i]."""
    return sp(a, axis) - a


# --- interpolations (2nd order) ---
def i_f(a, axis):
    """center -> face interpolation: out[i] = (a[i] + a[i-1]) / 2."""
    return 0.5 * (a + sm(a, axis))


def i_c(a, axis):
    """face -> center interpolation: out[i] = (a[i+1] + a[i]) / 2."""
    return 0.5 * (sp(a, axis) + a)


# Axis-specific conveniences
def dx_f(a):
    return d_f(a, "x")


def dx_c(a):
    return d_c(a, "x")


def dy_f(a):
    return d_f(a, "y")


def dy_c(a):
    return d_c(a, "y")


def dz_f(a):
    return d_f(a, "z")


def dz_c(a):
    return d_c(a, "z")


def ix_f(a):
    return i_f(a, "x")


def ix_c(a):
    return i_c(a, "x")


def iy_f(a):
    return i_f(a, "y")


def iy_c(a):
    return i_c(a, "y")


def iz_f(a):
    return i_f(a, "z")


def iz_c(a):
    return i_c(a, "z")
