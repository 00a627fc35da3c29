"""Distributed halo exchange via ``lax.ppermute`` under ``shard_map``.

Reference behavior reimplemented: Oceananigans'
distributed ``fill_halo_regions!`` posts NCCL send/recvs between neighbor
ranks of the 2-D process grid (SURVEY.md section 2d; the reference CI asserts
the compiled program contains *only* collective-permute communication,
/root/reference/.github/workflows/CompileOrRun.yml:129-151). Here each
extension along a mesh axis is a pair of ``lax.ppermute`` neighbor shifts of
width-h edge strips; global-boundary ranks substitute the local physical
boundary-condition ghost blocks instead.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax import lax

from gb25_tpu.ops.halos import ghost_blocks


def _take(a, sl, axis):
    idx = [slice(None)] * a.ndim
    idx[axis] = sl
    return a[tuple(idx)]


@dataclasses.dataclass(frozen=True)
class MeshComm:
    """Halo-exchange context for one device of an ("x", "y") mesh.

    Only meaningful inside ``shard_map``; arrays passed to its methods are
    per-device local tiles.
    """

    Rx: int
    Ry: int
    x_axis: str = "x"
    y_axis: str = "y"
    x_periodic: bool = True
    y_periodic: bool = False
    # tripolar north fold (grids.tripolar): pole center index of the fold map
    north_fold: bool = False
    pole_index: int = 0
    # force_ring: keep the ring/ppermute exchange structure even on axes with
    # a single rank (identity permutes; BC blocks still substitute at walls).
    # Purpose: measuring the decomposed (comm != None) code path on ONE
    # device (GB25_FORCE_COMM) — a 1x1 mesh then runs the exact program a
    # production tile runs (localize, W-wide extends, overlap strip stitch)
    # instead of routing to the serial path.
    force_ring: bool = False

    def x_offset(self, nx_local):
        return lax.axis_index(self.x_axis) * nx_local

    def y_offset(self, ny_local):
        return lax.axis_index(self.y_axis) * ny_local

    def exchange_strips(self, send_dn, send_up, axis_name, R, periodic,
                        bc_lo, bc_hi):
        """Ring-exchange the given edge strips; return the (lo, hi) ghost
        blocks this rank should install.  ``send_dn``/``send_up`` are my
        low/high edge strips (sent to the neighbors below/above);
        ``bc_lo``/``bc_hi`` are the local physical-boundary ghost blocks
        substituted at global-edge ranks (for periodic axes pass the wrap
        blocks, i.e. bc_lo = my high strip)."""
        if R == 1 and not self.force_ring:
            return bc_lo, bc_hi
        if periodic:
            # R == 1 (force_ring): identity permutes — receiving your own
            # opposite strip IS the periodic wrap, so values match serial
            perm_up = [(r, (r + 1) % R) for r in range(R)]
            perm_dn = [(r, (r - 1) % R) for r in range(R)]
        else:
            perm_up = [(r, r + 1) for r in range(R - 1)]
            perm_dn = [(r, r - 1) for r in range(1, R)]
        recv_lo = lax.ppermute(send_up, axis_name, perm_up)  # from rank below
        recv_hi = lax.ppermute(send_dn, axis_name, perm_dn)  # from rank above
        if not periodic:
            # global-edge ranks use the physical boundary condition instead
            idx = lax.axis_index(axis_name)
            recv_lo = jnp.where(idx == 0, bc_lo, recv_lo)
            recv_hi = jnp.where(idx == R - 1, bc_hi, recv_hi)
        return recv_lo, recv_hi

    def _exchange_axis(self, a, h, axis, axis_name, R, periodic, modes):
        if R > 1 and h > a.shape[axis]:
            raise ValueError(
                f"halo width {h} exceeds local tile extent {a.shape[axis]} "
                f"along axis {axis}: use a smaller halo or fewer ranks"
            )
        lo_mode, hi_mode = modes
        send_up = _take(a, slice(-h, None), axis)   # my top strip -> neighbor above
        send_dn = _take(a, slice(0, h), axis)       # my bottom strip -> neighbor below
        if R == 1 and not self.force_ring:
            bc_lo, bc_hi = ghost_blocks(a, h, axis, lo_mode, hi_mode)
        elif periodic:
            bc_lo = bc_hi = None  # unused: every rank has ring neighbors
        else:
            bc_lo, bc_hi = ghost_blocks(a, h, axis, lo_mode, hi_mode)
        recv_lo, recv_hi = self.exchange_strips(
            send_dn, send_up, axis_name, R, periodic, bc_lo, bc_hi)
        return jnp.concatenate([recv_lo, a, recv_hi], axis=axis)

    def extend_xy(self, a, hx, hy, xmodes, ymodes):
        if hx:
            a = self._exchange_axis(a, hx, 0, self.x_axis, self.Rx, self.x_periodic, xmodes)
        if hy:
            a = self._exchange_axis(a, hy, 1, self.y_axis, self.Ry, self.y_periodic, ymodes)
        return a

    def extend_xy_fold(self, a, hx, hy, kind):
        """Tripolar extension: south wall / neighbor rows / north-fold rows in
        y (fold exchanged across the top rank row), then the periodic x ring.
        Mirrors the single-device order in grids.tripolar so corners agree."""
        from gb25_tpu.ops.halos import FIELD_BCS, ghost_blocks
        from gb25_tpu.parallel.fold import fold_ghosts_north_dist

        (xlo, xhi), (ylo, _), _ = FIELD_BCS[kind]
        if hy:
            R = self.Ry
            fold_hi = fold_ghosts_north_dist(self, a, hy, kind)
            if R == 1 and not self.force_ring:
                lo, _ = ghost_blocks(a, hy, 1, ylo, "zerograd")
                hi = fold_hi
            else:
                send_up = _take(a, slice(-hy, None), 1)
                send_dn = _take(a, slice(0, hy), 1)
                recv_lo = lax.ppermute(
                    send_up, self.y_axis, [(r, r + 1) for r in range(R - 1)]
                )
                recv_hi = lax.ppermute(
                    send_dn, self.y_axis, [(r, r - 1) for r in range(1, R)]
                )
                idx = lax.axis_index(self.y_axis)
                bc_lo, _ = ghost_blocks(a, hy, 1, ylo, "zerograd")
                lo = jnp.where(idx == 0, bc_lo, recv_lo)
                hi = jnp.where(idx == R - 1, fold_hi, recv_hi)
            a = jnp.concatenate([lo, a, hi], axis=1)
        if hx:
            a = self._exchange_axis(a, hx, 0, self.x_axis, self.Rx, True, (xlo, xhi))
        return a
