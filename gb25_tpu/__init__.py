"""gb25_tpu: a global-ocean simulation engine in JAX for NVIDIA GPUs.

A brand-new JAX/XLA/Pallas framework with the capabilities of the GB-25
Gordon Bell stack (Oceananigans ``HydrostaticFreeSurfaceModel`` + ClimaOcean
coupling + Reactant distributed execution), designed as the reference is
for the GPU: one XLA program per step, XLA fusing the stencils:

- the whole time step is one pure, jitted SPMD program over a ``State`` pytree
  (reference: Reactant traces Julia into StableHLO; here JAX *is* the tracer);
- spatial domain decomposition over a 2-D ``jax.sharding.Mesh`` with halo
  exchange via ``lax.ppermute`` under ``shard_map`` (reference:
  Oceananigans.Distributed + Shardy propagation + NCCL);
- stencil operators are shape-preserving rolls over halo-extended arrays so
  the identical physics code runs single-device and sharded.

Layer map (mirrors SURVEY.md section 1, reference layers L2-L7):
  grids/      - LatitudeLongitude + Tripolar grids, vertical coordinates, metrics
  ops/        - staggered C-grid operators, WENO-5, EOS, tridiagonal solver
  models/     - hydrostatic free-surface model, closures, coupled model
  parallel/   - device mesh policy, halo exchange, sharding helpers
  simulation/ - Simulation driver, callbacks, output writers
  io/         - per-host sharded checkpointing
  utils/      - config/CLI, profiling, logging
"""

__version__ = "0.1.0"

from gb25_tpu.grids import (  # noqa: F401
    LatitudeLongitudeGrid,
    TripolarGrid,
    exponential_z_faces,
    simple_latitude_longitude_grid,
    tripolar_grid,
)
from gb25_tpu.models import (  # noqa: F401
    HydrostaticConfig,
    HydrostaticState,
    SplitExplicitFreeSurface,
    baroclinic_instability_model,
    loop,
    time_step,
)
