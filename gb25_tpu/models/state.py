"""Prognostic model state as a pytree.

The reference's model object holds prognostic fields u, v, tracers, eta,
AB2 tendency history G^n / G^- and a clock (SURVEY.md section 2b;
/root/reference/src/correctness.jl:41-47). Here that is a frozen dataclass of
arrays — the whole time step is a pure function ``State -> State`` and the
entire pytree lives sharded on device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["u", "v", "eta", "tracers", "Gu", "Gv", "Geta", "Gtracers",
                 "time", "time_lo", "iteration"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class HydrostaticState:
    u: jax.Array            # (Nx, Ny, Nz) zonal velocity at (f,c,c)
    v: jax.Array            # (Nx, Ny, Nz) meridional velocity at (c,f,c)
    eta: jax.Array          # (Nx, Ny)    free surface at (c,c)
    tracers: dict           # name -> (Nx, Ny, Nz) at (c,c,c)
    Gu: jax.Array           # previous tendencies (AB2 history)
    Gv: jax.Array
    Geta: jax.Array         # previous free-surface tendency (explicit FS only)
    Gtracers: dict
    time: jax.Array         # scalar, seconds (compensated: see ``time_lo``)
    time_lo: jax.Array      # Kahan compensation for the clock accumulation
    iteration: jax.Array    # scalar int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def advance_clock(time, time_lo, dt):
    """Compensated (Kahan) clock accumulation.

    The reference keeps a float64 clock; in a float32 state a plain f32
    ``time + dt`` stops advancing once time ~ 1e6-1e7 s (the 30 s increment
    falls below one ulp). Kahan summation carries the rounding error in a
    second f32 scalar, so the accumulated clock error stays O(ulp(total))
    independent of the step count — increments are never absorbed.
    XLA does not reassociate floating-point ops, so the compensation
    arithmetic survives compilation (ADVICE r1 low finding).
    """
    y = dt - time_lo
    t = time + y
    lo = (t - time) - y
    return t, lo


def initial_state(grid, tracers=("T", "S"), dtype=None) -> HydrostaticState:
    dtype = dtype or grid.dtype
    shape = grid.shape
    z3 = jnp.zeros(shape, dtype)
    return HydrostaticState(
        u=z3, v=z3, eta=jnp.zeros(shape[:2], dtype),
        tracers={name: z3 for name in tracers},
        Gu=z3, Gv=z3, Geta=jnp.zeros(shape[:2], dtype),
        Gtracers={name: z3 for name in tracers},
        time=jnp.zeros((), dtype),
        time_lo=jnp.zeros((), dtype),
        iteration=jnp.zeros((), jnp.int32),
    )
