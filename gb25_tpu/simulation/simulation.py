"""Simulation driver: schedules, callbacks, output writers, progress.

Reference surface reimplemented: ``Simulation(coupled_model; Δt, stop_time)``
with ``add_callback!(progress, IterationInterval(10))`` and
``JLD2OutputWriter`` (/root/reference/simulations/ocean_climate_simulation.jl:90-139),
plus the ``loop!`` driver used by the benchmarks
(/root/reference/src/timestepping_utils.jl:37-45).

Design: the hot path stays on device — the driver advances in *chunks* of
``inner_steps`` using one jitted ``lax.fori_loop`` program (like the
reference's traced 256-step while-loop) and only returns to Python at
callback/output boundaries.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from typing import Callable

import jax
import numpy as np

from gb25_tpu.models.hydrostatic import loop as _loop

logger = logging.getLogger("gb25_tpu")


@dataclasses.dataclass
class IterationInterval:
    every: int

    def aligned_steps(self, sim, max_steps: int) -> int:
        k = self.every - (sim.iteration % self.every)
        return min(k, max_steps)

    def should_fire(self, sim) -> bool:
        return sim.iteration % self.every == 0


@dataclasses.dataclass
class TimeInterval:
    """Exact time-based schedule: the driver shrinks chunks so model time
    lands ON each actuation boundary (multiples of ``seconds``), matching
    Oceananigans' TimeInterval alignment the reference relies on
    (/root/reference/simulations/ocean_climate_simulation.jl:90-134)."""

    seconds: float

    def __post_init__(self):
        self._next = None

    def _init(self, time: float):
        if self._next is None:
            self._next = (np.floor(time / self.seconds + 1e-12) + 1) * self.seconds

    def aligned_steps(self, sim, max_steps: int) -> int:
        self._init(sim.time)
        k = int(np.ceil((self._next - sim.time) / sim.dt - 1e-9))
        return min(max(k, 1), max_steps)

    def should_fire(self, sim) -> bool:
        self._init(sim.time)
        if sim.time >= self._next - 1e-6:
            while self._next <= sim.time + 1e-6:
                self._next += self.seconds
            return True
        return False


@dataclasses.dataclass
class Callback:
    fn: Callable  # fn(sim) -> None
    schedule: object


class Simulation:
    """Drives a jitted model; reference analog of Oceananigans' Simulation."""

    def __init__(self, cfg, grid, state, dt, stop_time=None, stop_iteration=None,
                 inner_steps=16, comm=None, step_fn=None, wall_time_limit=None):
        self.cfg = cfg
        self.grid = grid
        self.state = state
        self.dt = float(dt)
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.wall_time_limit = wall_time_limit  # seconds (reference: CI `timeout`)
        self.inner_steps = inner_steps
        self.callbacks: list[Callback] = []
        self.output_writers: list = []
        self._writer_schedules: list[TimeInterval] = []
        if step_fn is None and comm is not None:
            # wire the explicit halo-exchange comm into the default loop
            # (closed over, not traced) — otherwise the requested ppermute
            # path would be silently ignored
            step_fn = jax.jit(
                lambda cfg, grid, state, dt, n: _loop(cfg, grid, state, dt, n,
                                                      comm=comm),
                static_argnames="n",
            )
        self._step_fn = step_fn or jax.jit(_loop, static_argnames="n")
        self._comm = comm
        self.run_wall_time = 0.0

    # -- reference: add_callback!(sim, progress, IterationInterval(10)) --
    def add_callback(self, fn, schedule):
        self.callbacks.append(Callback(fn, schedule))

    def add_output_writer(self, writer):
        self.output_writers.append(writer)
        # align chunk boundaries to the writer's time interval so writes land
        # exactly on multiples of it (reference: TimeInterval output schedule)
        iv = getattr(writer, "interval", None)
        if iv:
            self._writer_schedules.append(TimeInterval(iv))

    @property
    def iteration(self) -> int:
        return int(self.state.iteration)

    @property
    def time(self) -> float:
        return float(self.state.time)

    def _next_chunk(self) -> int:
        n = self.inner_steps
        if self.stop_iteration is not None:
            n = min(n, self.stop_iteration - self.iteration)
        if self.stop_time is not None:
            n = min(n, int(np.ceil((self.stop_time - self.time) / self.dt - 1e-9)))
        for sched in [cb.schedule for cb in self.callbacks] + self._writer_schedules:
            n = min(n, sched.aligned_steps(self, n))
        return max(n, 0)

    def _should_stop(self) -> bool:
        if self.stop_iteration is not None and self.iteration >= self.stop_iteration:
            return True
        if self.stop_time is not None and self.time >= self.stop_time - 1e-9:
            return True
        return False

    def run(self):
        """Reference analog of ``run!(simulation)``."""
        t0 = _time.perf_counter()
        # initial record at the true start time: writers fire on their first
        # call, and without this it would land at the END of the first chunk
        # (an unaligned, mislabeled "initial" time)
        for w in self.output_writers:
            w.maybe_write(self)
        while not self._should_stop():
            if (self.wall_time_limit is not None
                    and _time.perf_counter() - t0 > self.wall_time_limit):
                logger.warning("wall-time limit reached; stopping cleanly")
                break
            n = self._next_chunk()
            if n <= 0:
                break
            self.state = self._step_fn(self.cfg, self.grid, self.state, self.dt, n)
            jax.block_until_ready(self.state)
            for cb in self.callbacks:
                if cb.schedule.should_fire(self):
                    cb.fn(self)
            for sched in self._writer_schedules:
                sched.should_fire(self)  # keep boundary tracking advancing
            for w in self.output_writers:
                w.maybe_write(self)
        self.run_wall_time = _time.perf_counter() - t0
        return self.state


class CheckpointWriter:
    """Periodic per-host sharded checkpointing (reference: save_model_state
    after each benchmark loop, sharded_io.jl:122-138)."""

    def __init__(self, directory, interval_seconds=86400.0, keep=2):
        self.directory = directory
        self.interval = interval_seconds
        self.keep = keep
        self._last = None
        self._written = []

    def maybe_write(self, sim):
        import os
        import shutil

        from gb25_tpu.io import save_sharded_state
        from gb25_tpu.io.output import _boundary_crossed

        fire, self._last = _boundary_crossed(sim.time, self.interval, self._last)
        if not fire:
            return
        path = os.path.join(self.directory, f"ckpt_iter{sim.iteration:09d}")
        save_sharded_state(sim.state, path)
        self._written.append(path)
        while len(self._written) > self.keep:
            old = self._written.pop(0)
            if jax.process_index() == 0:
                shutil.rmtree(old, ignore_errors=True)


@jax.jit
def _progress_stats(u, T):
    import jax.numpy as jnp

    if T is None:
        return jnp.abs(u).max(), None, None
    return jnp.abs(u).max(), T.min(), T.max()


def progress_callback(sim: Simulation):
    """Default progress logger (reference:
    simulations/ocean_climate_simulation.jl:95-116: iteration, time, max|u|,
    extrema(T), wall time).

    Reductions run ON DEVICE and only scalars cross to the host — pulling
    the full u/T arrays costs ~300 MB per callback at 1/4 degree."""
    s = sim.state
    mu, tmin, tmax = jax.device_get(
        _progress_stats(s.u, s.tracers.get("T")))
    msg = f"iter={sim.iteration} t={sim.time / 86400.0:.3f} days max|u|={float(mu):.4f}"
    if tmin is not None:
        msg += f" T in [{float(tmin):.3f}, {float(tmax):.3f}]"
    logger.info(msg)
