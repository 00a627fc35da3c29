#!/usr/bin/env python3
"""Quickest proof that the system runs on an NVIDIA GPU, through the entry
points a user calls, at full width.

    python chip_smoke.py          # one GPU: every phase below but "sharded"
    python chip_smoke.py --four   # four GPUs of one host: "device", "sharded"

Phases, in order (each prints its own lines; any failure raises, so the
script exits non-zero and prints no result):

  device      the default device must be a GPU; prints its kind and count,
              the card's name and power limit, the JAX version, XLA_FLAGS
              and the compile-cache directory
  flagship    ``loop`` of the baroclinic-instability model at 1536x768x64
              float32: compile time, steady ms/step, memory, finite state,
              and device ms per stage from one profiler trace
  climate     ``coupled_loop`` of the 1/4-degree data-free climate ocean
              (tripolar, gaussian islands, CATKE, coupled fluxes) at
              1536x768x64, once with the Triton Thomas kernel (the solver
              the step takes on a GPU) and once with the ``lax.scan`` Thomas
  thomas      the five implicit solves of one climate step at 1536x768x64:
              Triton kernel against the scan, timed and compared
  gpu_vs_cpu  one flagship and one coupled step at 192x96x32 on the GPU and
              on the host CPU, every prognostic field compared
  gpu_tests   the ``gpu``-marked tests, run in this process
  sharded     (--four) sharded lat-lon and tripolar climate steps against
              the serial step on card 0, the collectives in the compiled
              program, and per-card ms/step at the reference tile

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Traces and per-op summaries go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ONE_CARD_PHASES = ("device", "flagship", "climate", "thomas", "gpu_vs_cpu", "gpu_tests")
FOUR_CARD_PHASES = ("device", "sharded")
STAGES = ("fluxes", "closure", "tendency", "barotropic", "vertical_solve")
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "chip_smoke")

FULL = (1536, 768, 64)      # flagship and 1/4-degree climate grid
SMALL = (192, 96, 32)       # GPU-against-CPU comparison grid
TILE4 = (1536, 1536, 64)    # four cards x the reference's 768x768x64 tile
LOOP_STEPS = 8              # steps per timed loop
THOMAS_TOL = dict(rtol=1e-5, atol=1e-7)      # same elimination order
GPU_CPU_TOL = dict(rtol=2e-5, atol=1e-8)     # one step, f32
SHARDED_TOL = dict(rtol=5e-6, atol=1e-8)     # same program, decomposed


def phases(four: bool) -> tuple[str, ...]:
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def require_gpu(platform: str) -> None:
    """Every number this script prints must come from a GPU."""
    if platform != "gpu":
        print(f"chip_smoke: default device platform is {platform!r}, not 'gpu'",
              file=sys.stderr)
        raise SystemExit(1)


def takes_triton(hlo: str) -> bool:
    """Whether a compiled GPU program calls a Pallas-Triton kernel."""
    return "__gpu$xla.gpu.triton" in hlo


def result_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class Smoke:
    """State shared across phases: the card's label and the climate state
    that the Thomas phase reuses."""

    def __init__(self):
        self.card = None
        self.device = None
        self.climate = None

    # -- helpers ---------------------------------------------------------

    def timed_loop(self, phase, label, jitted, args, state_index, steps):
        """Compile ``jitted(*args)`` (state donated), run it twice, time the
        second call; print compile time, ms/step, memory; return (compiled,
        final state)."""
        import jax
        import jax.numpy as jnp

        args = list(args)
        args[state_index] = jax.tree_util.tree_map(jnp.copy, args[state_index])
        t0 = time.perf_counter()
        compiled = jitted.lower(*args).compile()
        say(phase, f"{label}: compile {time.perf_counter() - t0:.1f} s [{self.card}]")
        say(phase, f"{label}: memory_analysis {compiled.memory_analysis()}")
        state = jax.block_until_ready(compiled(*args))
        args[state_index] = state
        t0 = time.perf_counter()
        state = jax.block_until_ready(compiled(*args))
        ms = 1e3 * (time.perf_counter() - t0) / steps
        say(phase, f"{label}: {ms:.3f} ms/step over {steps} steps [{self.card}]")
        stats = jax.devices()[0].memory_stats() or {}  # None on the CPU
        say(phase, f"{label}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
        for leaf in jax.tree_util.tree_leaves(state):
            if jnp.issubdtype(leaf.dtype, jnp.floating) and not bool(jnp.isfinite(leaf).all()):
                raise FloatingPointError(f"{label}: non-finite state")
        say(phase, f"{label}: state finite, max|u| = {float(jnp.abs(state.u).max()):.4g}")
        return compiled, state, ms

    def stage_trace(self, phase, label, jitted, args):
        """Recompile ``jitted`` without command buffers (a CUDA graph shows
        in the trace as one event, hiding its kernels), run it once under
        the profiler; print device ms per stage, write the busiest ops to
        OUT_DIR, return the final state."""
        import shutil

        import jax

        from gb25_tpu.analysis.stages import device_events, instruction_scopes, stage_device_ms

        compiled = jitted.lower(*args).compile(
            compiler_options={"xla_gpu_enable_command_buffer": ""})
        trace_dir = os.path.join(OUT_DIR, f"trace_{label}")
        shutil.rmtree(trace_dir, ignore_errors=True)
        with jax.profiler.trace(trace_dir):
            state = jax.block_until_ready(compiled(*args))
        hlo = compiled.as_text()
        ms = stage_device_ms(trace_dir, hlo, STAGES)
        per_step = {k: v / LOOP_STEPS for k, v in ms.items()}
        say(phase, f"{label} (no command buffers): device ms/step by stage "
                   + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())
                   + f"; idle share {1 - ms['busy'] / ms['window']:.3f} [{self.card}]")
        import glob

        path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                                recursive=True))[-1]
        scopes = instruction_scopes(hlo)
        totals = {}
        for name, _, dur in device_events(path):
            totals[name] = totals.get(name, 0.0) + dur / 1e6
        with open(os.path.join(OUT_DIR, f"{label}_ops.txt"), "w") as f:
            f.write(f"# {label}: device ms over {LOOP_STEPS} steps [{self.card}]\n")
            for name, t in sorted(totals.items(), key=lambda kv: -kv[1])[:60]:
                f.write(f"{t:10.3f}  {name}  {sorted(scopes.get(name, ()))[:1]}\n")
        shutil.rmtree(trace_dir, ignore_errors=True)
        return state

    # -- phases ----------------------------------------------------------

    def device_phase(self, four):
        import jax

        from gb25_tpu.utils.cache import enable_persistent_cache
        from gb25_tpu.utils.device import device_info, nvidia_smi_line, parse_nvidia_smi

        self.device = device_info()
        require_gpu(self.device["platform"])
        if four and self.device["count"] < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {self.device['count']}")
        smi = nvidia_smi_line()
        name, watts = parse_nvidia_smi(smi)
        self.card = f"{name} {watts:g} W"
        say("device", f"platform {self.device['platform']}, device_kind "
                      f"{self.device['kind']}, count {self.device['count']}")
        print(smi, flush=True)
        say("device", f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
        say("device", f"compile cache {enable_persistent_cache()}")
        os.makedirs(OUT_DIR, exist_ok=True)

    def flagship_phase(self):
        import jax

        from gb25_tpu.models import baroclinic_instability_model, loop

        cfg, grid, state = baroclinic_instability_model(*FULL)
        jl = jax.jit(loop, static_argnames="n", donate_argnames="state")
        args = (cfg, grid, state, 60.0)
        jitted = _Bound(jl, n=LOOP_STEPS)
        compiled, state, _ = self.timed_loop("flagship", "flagship {}x{}x{} f32".format(*FULL),
                                             jitted, args, 2, LOOP_STEPS)
        self.stage_trace("flagship", "flagship", jitted, (cfg, grid, state, 60.0))

    def climate_phase(self):
        import jax

        import gb25_tpu.models.hydrostatic as hydrostatic
        from gb25_tpu.models.coupled import coupled_loop, data_free_ocean_climate_model
        from gb25_tpu.ops.tridiagonal import scan_vertical_diffusion

        t0 = time.perf_counter()
        ccfg, grid, atmos, state = data_free_ocean_climate_model(
            resolution=384.0 / FULL[0], Nz=FULL[2], grid_type="gaussian_islands_tripolar")
        assert (grid.Nx, grid.Ny, grid.Nz) == FULL and grid.immersed and grid.north_fold
        say("climate", f"model build (host) {time.perf_counter() - t0:.1f} s")
        dt = 60.0

        jl = jax.jit(coupled_loop, static_argnames="n", donate_argnames="state")
        compiled, state_k, ms_k = self.timed_loop(
            "climate", "climate 1/4deg, Triton Thomas", _Bound(jl, n=LOOP_STEPS),
            (ccfg, grid, atmos, state, dt), 3, LOOP_STEPS)
        if not takes_triton(compiled.as_text()):
            raise AssertionError("the climate step did not take the Triton Thomas kernel")
        say("climate", "the step's vertical solves run as the Triton Thomas kernel")
        state_k = self.stage_trace("climate", "climate", _Bound(jl, n=LOOP_STEPS),
                                   (ccfg, grid, atmos, state_k, dt))

        def scan_solves(field, kappa, dt_, dzc, dzf, damping=None):
            if isinstance(field, (tuple, list)):
                return tuple(scan_vertical_diffusion(f, kappa, dt_, dzc, dzf, damping)
                             for f in field)
            return scan_vertical_diffusion(field, kappa, dt_, dzc, dzf, damping)

        def coupled_loop_scan(*a, **k):  # a new function: a new trace
            return coupled_loop(*a, **k)

        saved = hydrostatic.implicit_vertical_diffusion
        hydrostatic.implicit_vertical_diffusion = scan_solves
        try:
            js = jax.jit(coupled_loop_scan, static_argnames="n", donate_argnums=3)
            compiled_s, state_s, ms_s = self.timed_loop(
                "climate", "climate 1/4deg, lax.scan Thomas", _Bound(js, n=LOOP_STEPS),
                (ccfg, grid, atmos, state, dt), 3, LOOP_STEPS)
        finally:
            hydrostatic.implicit_vertical_diffusion = saved
        if takes_triton(compiled_s.as_text()):
            raise AssertionError("the scan variant still holds a Triton call")
        say("climate", f"climate step: Triton {ms_k:.3f} ms/step, scan {ms_s:.3f} "
                       f"ms/step, Triton/scan {ms_k / ms_s:.3f} [{self.card}]")
        del state_s, compiled_s
        self.climate = (ccfg, grid, state_k)

    def thomas_phase(self):
        import jax
        import numpy as np

        from gb25_tpu.models.hydrostatic import compute_tendencies
        from gb25_tpu.ops.thomas_triton import thomas_solve
        from gb25_tpu.ops.tridiagonal import scan_vertical_diffusion

        ccfg, grid, state = self.climate
        diff = jax.jit(lambda s: compute_tendencies(ccfg.ocean, grid, s)[4])(state)
        hz, Nz = grid.hz, grid.Nz
        dzc = grid.dz_c[:, :, hz: hz + Nz]
        dzf = grid.dz_f[:, :, hz: hz + Nz]
        dt = 60.0
        tr = state.tracers
        solves = [  # the five solves of one climate step, grouped by kappa
            ("u,v", (state.u, state.v), diff["kappa_u"], None),
            ("T,S", (tr["T"], tr["S"]), diff["kappa_c"], None),
            ("e", (tr["e"],), diff["kappa_e"], diff["lam_e"]),
        ]
        say("thomas", "comparison under jax.default_matmul_precision('highest') "
                      "(no matrix product on this path; set for the reference)")
        t_kernel = t_scan = 0.0
        with jax.default_matmul_precision("highest"):
            for name, fields, kap, damp in solves:
                kern = jax.jit(lambda f, k, d: thomas_solve(f, k, dt, dzc, dzf, d))
                scan = jax.jit(lambda f, k, d: tuple(
                    scan_vertical_diffusion(x, k, dt, dzc, dzf, d) for x in f))
                got = jax.block_until_ready(kern(fields, kap, damp))
                want = jax.block_until_ready(scan(fields, kap, damp))
                for g, w in zip(got, want):
                    g, w = np.asarray(g), np.asarray(w)
                    err = np.max(np.abs(g - w) / (THOMAS_TOL["atol"] + THOMAS_TOL["rtol"] * np.abs(w)))
                    say("thomas", f"{name}: max |kernel - scan| / (atol + rtol|scan|) = {err:.3g}")
                    np.testing.assert_allclose(g, w, **THOMAS_TOL)
                t_kernel += _best_of(lambda: kern(fields, kap, damp))
                t_scan += _best_of(lambda: scan(fields, kap, damp))
        say("thomas", f"five solves at {grid.Nx}x{grid.Ny}x{grid.Nz} f32: Triton kernel "
                      f"{1e3 * t_kernel:.3f} ms, lax.scan {1e3 * t_scan:.3f} ms "
                      f"[{self.card}]")
        self.climate = None

    def gpu_vs_cpu_phase(self):
        """Each prognostic field after one step on the GPU against the host
        CPU's, at GPU_CPU_TOL or else at the step's rounding sensitivity
        (``held_to``): the two devices round differently (FMA contraction,
        reduction order)."""
        import jax

        from gb25_tpu.grids import simple_latitude_longitude_grid
        from gb25_tpu.models import baroclinic_instability_config, baroclinic_instability_state, time_step
        from gb25_tpu.models.coupled import coupled_time_step, data_free_ocean_climate_model

        cpu = jax.devices("cpu")[0]
        grid = simple_latitude_longitude_grid(*SMALL)
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(grid, noise_velocity=1e-3)
        ccfg, cgrid, atmos, cstate = data_free_ocean_climate_model(
            resolution=384.0 / SMALL[0], Nz=SMALL[2], grid_type="gaussian_islands_tripolar")
        assert (cgrid.Nx, cgrid.Ny, cgrid.Nz) == SMALL
        cases = [
            ("flagship time_step", jax.jit(time_step), (cfg, grid, state, 60.0), 2),
            ("coupled_time_step", jax.jit(coupled_time_step),
             (ccfg, cgrid, atmos, cstate, 600.0), 3),
        ]
        bad = []
        for label, fn, args, si in cases:
            on_gpu = fn(*args)
            cpu_args = list(jax.device_put(args, cpu))
            on_cpu = fn(*cpu_args)
            cpu_args[si] = perturb_ulp(cpu_args[si])
            nudged = fn(*cpu_args)
            bad += held_to("gpu_vs_cpu", f"{label}, gpu vs cpu", GPU_CPU_TOL,
                           prognostic_fields(on_gpu, on_cpu, nudged))
        if bad:
            raise AssertionError(f"GPU and CPU differ beyond the stated tolerance and "
                                 f"beyond the step's rounding sensitivity: {bad}")

    def gpu_tests_phase(self):
        import pytest

        class Count:
            passed = failed = 0

            def pytest_runtest_logreport(self, report):
                if report.when == "call" and report.passed:
                    self.passed += 1
                elif report.failed:
                    self.failed += 1

        count = Count()
        tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_gpu.py")
        rc = pytest.main(["-q", "-m", "gpu", "--noconftest", "-p", "no:cacheprovider",
                          tests], plugins=[count])
        say("gpu_tests", f"pytest exit {int(rc)}: {count.passed} passed, {count.failed} failed")
        if rc != 0 or count.passed == 0 or count.failed:
            raise AssertionError("gpu-marked tests failed or did not run")

    def sharded_phase(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from gb25_tpu.grids import simple_latitude_longitude_grid
        from gb25_tpu.models import baroclinic_instability_config, baroclinic_instability_state, time_step
        from gb25_tpu.models.coupled import coupled_time_step, data_free_ocean_climate_model
        from gb25_tpu.parallel import factors, make_mesh, shard_state, sharded_step_fn
        from gb25_tpu.parallel.sharded import sharded_coupled_step_fn

        mesh = make_mesh(4)
        say("sharded", f"mesh {factors(4)} over devices "
                       f"{[d.id for d in mesh.devices.flat]}")
        card0 = jax.devices()[0]
        dt = jnp.float32(60.0)

        def check_placement(label, s):
            shards = s.u.addressable_shards
            ids = sorted(sh.device.id for sh in shards)
            if ids != sorted(d.id for d in mesh.devices.flat) or len(shards) != 4:
                raise AssertionError(f"{label}: shards on devices {ids}")
            say("sharded", f"{label}: u shards {[sh.data.shape for sh in shards]} "
                           f"on devices {ids}")

        def compare(label, step, args, si, got):
            """``got`` against the serial step on card 0, at SHARDED_TOL or
            else at the serial step's rounding sensitivity (``held_to``)."""
            args = list(jax.device_put(args, card0))
            ref = step(*args)
            args[si] = perturb_ulp(args[si])
            nudged = step(*args)
            fields = []
            for (path, r), g, p in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                       jax.tree_util.tree_leaves(got),
                                       jax.tree_util.tree_leaves(nudged)):
                r, g, p = np.asarray(r), np.asarray(g), np.asarray(p)
                if r.dtype.kind == "f":
                    fields.append((jax.tree_util.keystr(path), g, r, p))
                else:
                    np.testing.assert_array_equal(g, r)
            bad = held_to("sharded", f"{label}, sharded vs serial on card 0",
                          SHARDED_TOL, fields)
            if bad:
                raise AssertionError(f"{label}: sharded differs from serial beyond the "
                                     f"stated tolerance and the rounding sensitivity: {bad}")
            say("sharded", f"{label}: sharded == serial on card 0")

        def check_collectives(label, compiled):
            hlo = compiled.as_text()
            n_perm = hlo.count("collective-permute")
            bad = [op for op in ("all-gather", "all-reduce", "all-to-all", "reduce-scatter")
                   if op in hlo]
            say("sharded", f"{label}: {n_perm} collective-permute mentions, other collectives {bad}")
            if n_perm == 0 or bad:
                raise AssertionError(f"{label}: halo exchange is not collective-permutes only")

        # lat-lon flagship, global 1536x768x64
        grid = simple_latitude_longitude_grid(*FULL)
        cfg = baroclinic_instability_config()
        state = baroclinic_instability_state(grid, noise_velocity=1e-3)
        fn = sharded_step_fn(cfg, grid, mesh)
        sstate = shard_state(state, mesh)
        compiled = fn.lower(sstate, dt).compile()
        check_collectives("lat-lon step", compiled)
        got = compiled(sstate, dt)
        check_placement("lat-lon step", got)
        compare("lat-lon {}x{}x{}".format(*FULL), jax.jit(time_step),
                (cfg, grid, state, dt), 2, got)
        del got, sstate

        # tripolar climate with the north fold across cards
        ccfg, cgrid, atmos, cstate = data_free_ocean_climate_model(
            resolution=384.0 / FULL[0], Nz=FULL[2], grid_type="gaussian_islands_tripolar")
        cfn = sharded_coupled_step_fn(ccfg, cgrid, atmos, mesh)
        scstate = shard_state(cstate, mesh)
        compiled = cfn.lower(scstate, dt).compile()
        check_collectives("tripolar climate step", compiled)
        got = compiled(scstate, dt)
        check_placement("tripolar climate step", got)
        compare("tripolar climate {}x{}x{}".format(*FULL), jax.jit(coupled_time_step),
                (ccfg, cgrid, atmos, cstate, dt), 3, got)
        del got, scstate, atmos

        # per-card time at the reference's 768x768x64 tile
        grid4 = simple_latitude_longitude_grid(*TILE4)
        fn4 = sharded_step_fn(cfg, grid4, mesh, n_inner=LOOP_STEPS)
        s4 = shard_state(baroclinic_instability_state(grid4), mesh)
        t0 = time.perf_counter()
        c4 = fn4.lower(s4, dt).compile()
        rx, ry = factors(4)
        tile = f"{TILE4[0] // rx}x{TILE4[1] // ry}x{TILE4[2]}"
        say("sharded", f"tile {tile} x 4: compile {time.perf_counter() - t0:.1f} s")
        s4 = jax.block_until_ready(c4(s4, dt))
        t0 = time.perf_counter()
        s4 = jax.block_until_ready(c4(s4, dt))
        ms = 1e3 * (time.perf_counter() - t0) / LOOP_STEPS
        if not bool(jnp.isfinite(s4.u).all()):
            raise FloatingPointError("tile run: non-finite state")
        say("sharded", f"flagship {TILE4[0]}x{TILE4[1]}x{TILE4[2]} on 2x2: {ms:.3f} "
                       f"ms/step per card (tile {tile}) [{self.card} x4]")


class _Bound:
    """``jitted`` with its static ``n`` bound, keeping ``.lower``."""

    def __init__(self, jitted, n):
        self.jitted, self.n = jitted, n

    def lower(self, *args):
        return self.jitted.lower(*args, n=self.n)


def _best_of(fn, reps=5):
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def perturb_ulp(state, seed=0):
    """``state`` with every floating leaf scaled by 1 + 2**-23 * N(0, 1):
    about one float32 ulp of each value."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)

    def nudge(x):
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        noise = jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        return x * (1 + 2.0 ** -23 * noise)

    return jax.tree_util.tree_map(nudge, state)


def held_to(phase, label, tol, fields):
    """Check ``(name, got, ref, nudged)`` arrays; return those that fail.

    Each field must agree with ``ref`` within ``tol``, pointwise. A field
    that does not is held to the reference step's rounding sensitivity
    instead, and its line says so: the gap may not exceed that between
    ``ref`` and ``nudged``, the same step from a state about one float32 ulp
    away (``perturb_ulp``). The step amplifies rounding where a field is a
    small difference of large terms, as velocity and surface height are one
    step from a near-balanced start."""
    import numpy as np

    bad = []
    for name, got, ref, nudged in fields:
        scale = max(float(np.max(np.abs(ref))), 1e-30)
        gap = float(np.max(np.abs(got - ref))) / scale
        sens = float(np.max(np.abs(nudged - ref))) / scale
        ratio = float(np.max(np.abs(got - ref) / (tol["atol"] + tol["rtol"] * np.abs(ref))))
        head = (f"{label} {name}: max|got-ref|/max|ref| = {gap:.3g}, "
                f"pointwise max|got-ref|/(atol+rtol|ref|) = {ratio:.3g}")
        if ratio <= 1.0:
            say(phase, f"{head}: within {tol}")
            continue
        verdict = "within" if gap <= sens else "BEYOND"
        say(phase, f"{head}: beyond {tol}; a one-ulp state perturbation moves it by "
                   f"{sens:.3g} of max|ref|: gap {verdict} the step's rounding sensitivity")
        if gap > sens:
            bad.append((label, name, gap, sens))
    return bad


def prognostic_fields(*states):
    """(name, *arrays) of u, v, eta and every tracer, one array per state."""
    import numpy as np

    first = states[0]
    out = [(n, *(np.asarray(getattr(s, n)) for s in states)) for n in ("u", "v", "eta")]
    out += [(k, *(np.asarray(s.tracers[k]) for s in states)) for k in first.tracers]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="four GPUs: run only the sharded phase")
    args = p.parse_args(argv)
    # phase gpu_vs_cpu needs the host CPU beside the GPU
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    smoke = Smoke()
    for phase in phases(args.four):
        t0 = time.perf_counter()
        if phase == "device":
            smoke.device_phase(args.four)
        else:
            getattr(smoke, f"{phase}_phase")()
        say(phase, f"done in {time.perf_counter() - t0:.1f} s")
    print(result_line(smoke.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
