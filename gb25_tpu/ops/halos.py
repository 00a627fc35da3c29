"""Functional halo extension (the reference's ``fill_halo_regions!``).

Fields are stored interior-only; each stage extends them with ``h`` ghost
cells per side. Single-device: ghosts come from boundary conditions (wrap /
mirror / anti-mirror / zero-gradient). Distributed: the same ghost-block
construction is reused by ``gb25_tpu.parallel.halo`` where interior-neighbor
blocks arrive via ``lax.ppermute`` instead (reference behavior:
Oceananigans distributed fill_halo_regions! with communication buffers,
/root/reference/src/precompile.jl:35,40).

Boundary condition modes per axis side:
  - ``wrap``            periodic
  - ``mirror``          symmetric reflection about a boundary lying *between*
                        samples (free-slip tangential velocity, no-flux tracer)
  - ``antimirror_face`` antisymmetric reflection for wall-normal velocity whose
                        first/virtual-last sample sits *on* the wall (v = 0 at
                        the wall, v(-j) = -v(+j))
  - ``zerograd``        replicate edge value
  - ``zero``            zeros
"""

from __future__ import annotations

import jax.numpy as jnp


def _take(a, sl, axis):
    idx = [slice(None)] * a.ndim
    idx[axis] = sl
    return a[tuple(idx)]


def _flip(a, axis):
    return jnp.flip(a, axis=axis)


def ghost_blocks(a, h: int, axis: int, lo_mode: str, hi_mode: str):
    """Return (lo_block, hi_block) ghost slabs of width ``h`` along ``axis``."""
    if lo_mode == "wrap":
        lo = _take(a, slice(-h, None), axis)
    elif lo_mode == "mirror":
        lo = _flip(_take(a, slice(0, h), axis), axis)
    elif lo_mode == "antimirror_face":
        # a[0] is on the wall; ghosts -1..-h are -a[1..h]
        lo = -_flip(_take(a, slice(1, h + 1), axis), axis)
    elif lo_mode == "zerograd":
        lo = jnp.repeat(_take(a, slice(0, 1), axis), h, axis=axis)
    elif lo_mode == "zero":
        shape = list(a.shape)
        shape[axis] = h
        lo = jnp.zeros(shape, a.dtype)
    else:  # pragma: no cover
        raise ValueError(f"unknown lo_mode {lo_mode}")

    if hi_mode == "wrap":
        hi = _take(a, slice(0, h), axis)
    elif hi_mode == "mirror":
        hi = _flip(_take(a, slice(-h, None), axis), axis)
    elif hi_mode == "antimirror_face":
        # the wall is the *virtual* face N (not stored): ghosts are
        # [0 (wall), -a[N-1], -a[N-2], ...]
        shape = list(a.shape)
        shape[axis] = 1
        wall = jnp.zeros(shape, a.dtype)
        if h > 1:
            tail = -_flip(_take(a, slice(-(h - 1), None), axis), axis)
            hi = jnp.concatenate([wall, tail], axis=axis)
        else:
            hi = wall
    elif hi_mode == "zerograd":
        hi = jnp.repeat(_take(a, slice(-1, None), axis), h, axis=axis)
    elif hi_mode == "zero":
        shape = list(a.shape)
        shape[axis] = h
        hi = jnp.zeros(shape, a.dtype)
    else:  # pragma: no cover
        raise ValueError(f"unknown hi_mode {hi_mode}")
    return lo, hi


def extend_axis(a, h: int, axis: int, lo_mode: str, hi_mode: str):
    if h == 0:
        return a
    lo, hi = ghost_blocks(a, h, axis, lo_mode, hi_mode)
    return jnp.concatenate([lo, a, hi], axis=axis)


# Boundary-condition tables per field kind for a (periodic-x, bounded-y,
# bounded-z) domain. (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi)
FIELD_BCS = {
    # tracers & other cell-centered scalars: no-flux walls
    "c": (("wrap", "wrap"), ("mirror", "mirror"), ("zerograd", "zerograd")),
    # zonal velocity (x-face, y-center): free-slip at y walls
    "u": (("wrap", "wrap"), ("mirror", "mirror"), ("zerograd", "zerograd")),
    # meridional velocity (y-face): impenetrable walls
    "v": (("wrap", "wrap"), ("antimirror_face", "antimirror_face"), ("zerograd", "zerograd")),
    # vertical velocity (z-face): w=0 below bottom, zero-gradient above surface
    "w": (("wrap", "wrap"), ("mirror", "mirror"), ("zero", "zerograd")),
}


def extend_field(grid, a, kind: str, comm=None):
    """Extend an interior ``(Nx, Ny, Nz)`` field to ``(Nx+2hx, Ny+2hy, Nz+2hz)``.

    ``comm`` is None on a single device; a ``parallel.halo.MeshComm`` swaps the
    x/y ghost construction for ppermute exchanges (same z handling).
    """
    (xlo, xhi), (ylo, yhi), (zlo, zhi) = FIELD_BCS[kind]
    if getattr(grid, "north_fold", False):
        if comm is not None:
            a = comm.extend_xy_fold(a, grid.hx, grid.hy, kind)
        else:
            from gb25_tpu.grids.tripolar import extend_field_tripolar

            a = extend_field_tripolar(grid, a, kind, grid.hx, grid.hy)
        return extend_axis(a, grid.hz, 2, zlo, zhi)
    if comm is not None:
        a = comm.extend_xy(a, grid.hx, grid.hy, (xlo, xhi), (ylo, yhi))
        return extend_axis(a, grid.hz, 2, zlo, zhi)
    return _extend_3d_fast(a, grid.halo, (xlo, xhi), (ylo, yhi), (zlo, zhi))


def _extend_3d_fast(a, halo, xmodes, ymodes, zmodes):
    """Single-device 3-D extension as ONE pad (one materialization) plus thin
    ghost-slab writes (XLA performs the updates in place), instead of three
    concat chains — ~3x less memory traffic on the hot path."""
    hx, hy, hz = halo
    Nx, Ny, Nz = a.shape
    e = jnp.pad(a, ((hx, hx), (hy, hy), (hz, hz)))
    if hx:
        lo, hi = ghost_blocks(e[hx : hx + Nx], hx, 0, *xmodes)
        e = e.at[:hx].set(lo)
        e = e.at[hx + Nx :].set(hi)
    if hy:
        lo, hi = ghost_blocks(e[:, hy : hy + Ny], hy, 1, *ymodes)
        e = e.at[:, :hy].set(lo)
        e = e.at[:, hy + Ny :].set(hi)
    if hz:
        lo, hi = ghost_blocks(e[:, :, hz : hz + Nz], hz, 2, *zmodes)
        e = e.at[:, :, :hz].set(lo)
        e = e.at[:, :, hz + Nz :].set(hi)
    return e


def extend2(grid, a, kind: str, comm=None, h: int = 1):
    """Extend a 2-D field with an arbitrary (small) halo width ``h`` — used by
    the barotropic substep loop, which only needs width-1 halos per substep."""
    (xlo, xhi), (ylo, yhi), _ = FIELD_BCS[kind]
    if getattr(grid, "north_fold", False):
        if comm is not None:
            return comm.extend_xy_fold(a, h, h, kind)
        from gb25_tpu.grids.tripolar import extend_field_tripolar

        return extend_field_tripolar(grid, a, kind, h, h)
    if comm is not None:
        return comm.extend_xy(a, h, h, (xlo, xhi), (ylo, yhi))
    a = extend_axis(a, h, 0, xlo, xhi)
    a = extend_axis(a, h, 1, ylo, yhi)
    return a


def extend_field_xy(grid, a, kind: str, comm=None):
    """Extend a 2-D ``(Nx, Ny)`` field (e.g. free surface) in x and y only."""
    (xlo, xhi), (ylo, yhi), _ = FIELD_BCS[kind]
    if getattr(grid, "north_fold", False):
        if comm is not None:
            return comm.extend_xy_fold(a, grid.hx, grid.hy, kind)
        from gb25_tpu.grids.tripolar import extend_field_tripolar

        return extend_field_tripolar(grid, a, kind, grid.hx, grid.hy)
    if comm is not None:
        return comm.extend_xy(a, grid.hx, grid.hy, (xlo, xhi), (ylo, yhi))
    a = extend_axis(a, grid.hx, 0, xlo, xhi)
    a = extend_axis(a, grid.hy, 1, ylo, yhi)
    return a
