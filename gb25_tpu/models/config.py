"""Model configuration dataclasses.

All configs are frozen dataclasses registered as *leafless* pytrees (metadata
only), so a configured model step can be passed straight through ``jax.jit``
— changing a config triggers a recompile, exactly like the reference's
compile-time model structure (Reactant recompiles per model configuration).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax

from gb25_tpu.ops.eos import TEOS10EquationOfState

EARTH_ROTATION_RATE = 7.292115e-5  # rad/s (Oceananigans' default)


def static_pytree(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    return partial(jax.tree_util.register_dataclass, data_fields=[], meta_fields=fields)(cls)


@static_pytree
@dataclasses.dataclass(frozen=True)
class ExplicitFreeSurface:
    """Forward free surface evolved with the model AB2 step (reference analog:
    ``ExplicitFreeSurface`` used in sharding/simple_sharding_problem.jl:83)."""

    gravitational_acceleration: float = 9.80665


@static_pytree
@dataclasses.dataclass(frozen=True)
class SplitExplicitFreeSurface:
    """Barotropic substepping with time filtering (reference analog:
    ``SplitExplicitFreeSurface(substeps=30)``,
    /root/reference/src/baroclinic_instability_model.jl:22).

    ``substeps`` forward-backward substeps integrate the barotropic system
    over the window [t, t + 2*dt]; the prognostic state is replaced by the
    weighted average. ``averaging`` is "parabolic" (w ~ tau (2 - tau)) or
    "flat".

    ``exchange_width``: halo width W of the blocked substep exchange
    (models.free_surface; None = the grid halo).  Each width-W exchange
    supports W substeps, so W = substeps runs the whole solve with ONE
    (2-D, cheap) exchange round — the decomposed-path production setting.
    Serial and distributed runs must use the SAME
    value for serial-vs-sharded bitwise agreement, which the config knob
    guarantees; tiles narrower than W+1 shrink it locally (warned).
    """

    substeps: int = 30
    gravitational_acceleration: float = 9.80665
    averaging: str = "parabolic"
    exchange_width: int | None = None


@static_pytree
@dataclasses.dataclass(frozen=True)
class VerticalScalarDiffusivity:
    """Vertically-implicit constant diffusivity closure (reference analog:
    ``VerticalScalarDiffusivity(VerticallyImplicitTimeDiscretization(), kappa=1e-5, nu=1e-4)``,
    /root/reference/src/baroclinic_instability_model.jl:31)."""

    nu: float = 1.0e-4     # momentum viscosity [m^2/s]
    kappa: float = 1.0e-5  # tracer diffusivity [m^2/s]


@static_pytree
@dataclasses.dataclass(frozen=True)
class HorizontalScalarDiffusivity:
    """Explicit horizontal Laplacian diffusion (optional stabilizer)."""

    nu: float = 0.0
    kappa: float = 0.0


@dataclasses.dataclass(frozen=True)
class HydrostaticConfig:
    """Static configuration of the hydrostatic free-surface model.

    Mirrors the reference model constructor surface
    (/root/reference/src/baroclinic_instability_model.jl:17-70): free surface,
    buoyancy/EOS, Coriolis, advection schemes, closure, tracer set.
    """

    tracers: tuple = ("T", "S")
    momentum_advection: str = "weno_vector_invariant"  # | "vector_invariant" | "none"
    tracer_advection: str = "weno5"  # | "centered2" | "upwind1" | "none"
    eos: object = TEOS10EquationOfState()
    coriolis: float = EARTH_ROTATION_RATE  # Omega; 0 disables rotation
    free_surface: object = SplitExplicitFreeSurface()
    closure: object = None  # VerticalScalarDiffusivity | CATKE | None
    chi: float = 0.1  # quasi-AB2 parameter (Euler first step)
    weno_eps: float = 1e-6
    # Kinetic-energy discretization for the vector-invariant Bernoulli term:
    # "hollingsworth" (default) = the NEMO-style corrected KE, robust
    # against the Hollingsworth instability at eddy-resolving resolution
    # (the reference's WENOVectorInvariant carries its own equivalent
    # cure); "standard" = plain C-grid form (ops/operators.py).
    ke_scheme: str = "hollingsworth"
    # Precision lowering (reference analog: Reactant.MultiFloatOptions,
    # src/arg_parsing.jl:99-107): compute the tendency stage in this dtype
    # (e.g. "bfloat16") while the prognostic state/update stays in the
    # storage dtype. None = compute in storage precision.
    compute_dtype: str | None = None
    # Communication/computation overlap (reference analog: the boundary/
    # interior kernel split + ``optimize_communications`` CompileOption,
    # /root/reference/src/precompile.jl:52-73 and
    # sharding/sharded_baroclinic_instability_simulation_run.jl:109-112):
    # when True and running distributed, core tendencies are computed from a
    # local-only extension so they carry no data dependence on the halo
    # ppermutes, letting XLA's latency-hiding scheduler overlap them; the
    # four boundary strips are recomputed from the exchange and stitched.
    # Default False: the four boundary strips are recomputed, and whether
    # hiding the exchange pays for that has not been measured on GPUs.
    overlap_split: bool = False

    @property
    def g(self):
        return self.free_surface.gravitational_acceleration


jax.tree_util.register_dataclass(
    HydrostaticConfig,
    data_fields=[],
    meta_fields=[f.name for f in dataclasses.fields(HydrostaticConfig)],
)
