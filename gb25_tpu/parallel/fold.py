"""Distributed tripolar north-fold halo exchange.

SURVEY.md hard part (a): the reference obtains the tripolar north fold from
Oceananigans + Shardy propagation; here the permute pattern is explicit.

Geometry: the T-pivot fold maps global center column i to (2p - i) mod Nx.
A destination tile [ix*nxl, (ix+1)*nxl) therefore needs a *reversed*
contiguous source range starting at  start(ix) = (2p + 1 - (ix+1)*nxl) mod Nx,
which straddles at most two x-ranks with a *constant* split offset
r = (2p + 1) mod nxl. The exchange is two ``lax.ppermute`` shifts of the top
(h+1) rows along the "x" axis (every y-row of ranks executes the same
permute; only the northernmost row consumes the result), followed by a local
stitch + reverse + sign.

x-face quantities (u) fold with offset 2p + 1 - i, i.e. the same pattern with
start+1 / r_u = (r + 1) mod nxl.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _fold_perms(Rx, nxl, p, face):
    """Static permutes + split offset for the fold exchange."""
    Nx = Rx * nxl
    shift = 2 * p + (2 if face else 1)  # start(ix) + nxl = shift - ix*nxl
    r = shift % nxl
    perm0, perm1 = [], []
    for ix in range(Rx):
        start = (shift - (ix + 1) * nxl) % Nx
        s0 = start // nxl
        s1 = (s0 + 1) % Rx
        perm0.append((s0, ix))
        perm1.append((s1, ix))
    return perm0, perm1, r


def fold_exchange_strips(comm, a, h, faces=("c", "u")):
    """Return {face: strip}: the fold-source top rows ((h+1) rows, nxl
    columns) regathered for this rank's fold range, for center-folded ("c")
    and/or face-folded ("u") quantities. Valid only on the top rank row;
    other rank rows receive their own rotated garbage (unused).

    ``faces`` selects which alignments to build — every field consumes
    exactly one, and each costs 2 ppermutes on the critical path, so
    callers pass the one they need (halves the fold collectives)."""
    nxl = a.shape[0]
    nyl = a.shape[1]
    if nyl < h + 1:
        # the fold sources h+1 top rows from the top rank row's own tile; a
        # sliver tile (nyl <= halo) would silently wrap the slice — the rows would have to come from the next rank row down,
        # which this exchange does not implement
        raise ValueError(
            f"tripolar north fold needs ny_local >= halo+1 ({h + 1}), got "
            f"{nyl}: reduce Ry (or the halo) so the top rank row holds the "
            f"full fold strip"
        )
    # strip rows: local rows nyl-1-h .. nyl-1 (P-h .. P)
    strip = a[:, nyl - 1 - h :, ...]

    Rx, p = comm.Rx, comm.pole_index
    out = {}
    for face, key in ((False, "c"), (True, "u")):
        if key not in faces:
            continue
        perm0, perm1, r = _fold_perms(Rx, nxl, p, face)
        if Rx == 1:
            got0 = got1 = strip
        else:
            got0 = lax.ppermute(strip, comm.x_axis, perm0)
            got1 = lax.ppermute(strip, comm.x_axis, perm1)
        # ascending global order: cols [r, nxl) from s0 then [0, r) from s1
        stitched = jnp.concatenate([got0[r:], got1[:r]], axis=0) if r else got0
        out[key] = stitched[::-1]  # reversed -> indexed by local dest column
    return out


def fold_ghosts_north_dist(comm, a, h, kind):
    """Ghost rows beyond the seam for one field on the top rank row.

    Matches grids.tripolar.fold_ghosts_north: centers/w/eta ghost(:, P+m) =
    +src(fold, P-m); u: -src(fold_u, P-m); v (faces): -src(fold, P-m+1).
    """
    nyl = a.shape[1]
    face = "u" if kind == "u" else "c"
    src = fold_exchange_strips(comm, a, h, faces=(face,))[face]
    # strip rows: index t in [0, h] corresponds to source row P-h+t
    sign = -1.0 if kind in ("u", "v") else 1.0
    if kind == "v":
        # ghost j = nyl-1+m  (m>=1) -> source row P - m + 1 = t = h - m + 1
        rows = [src[:, h - m + 1, ...] for m in range(1, h + 1)]
    else:
        rows = [src[:, h - m, ...] for m in range(1, h + 1)]
    return sign * jnp.stack(rows, axis=1)


def north_fold_projection_dist(comm, grid, u, v, eta, tracers):
    """Distributed T-pivot seam projection (top rank row only)."""
    iy = lax.axis_index(comm.y_axis)
    is_top = iy == comm.Ry - 1
    P = grid.Ny - 1

    def project(field, kind):
        face = "u" if kind == "u" else "c"
        s = -1.0 if kind == "u" else 1.0
        mirror = fold_exchange_strips(comm, field, 0, faces=(face,))[face][:, 0, ...]
        old = field[:, P, ...]
        newrow = 0.5 * (old + s * mirror)
        # select on the thin ROW, not the full array: a full-array where
        # costs two reads + a write per field on every step
        return field.at[:, P, ...].set(jnp.where(is_top, newrow, old))

    u = project(u, "u")
    eta = project(eta, "c")
    tracers = {k: project(c, "c") for k, c in tracers.items()}
    return u, v, eta, tracers
