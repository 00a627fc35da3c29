"""Collective-communication accounting from compiled HLO.

A multi-device perf signal that needs no multi-device hardware: parse the compiled sharded step's HLO, find the steady-state
while body, and sum the bytes moved by every ``collective-permute`` per step
per device. The reference scrapes analogous numbers from NCCL traces
(analysis/analyze_traces.ipynb) and ablates comm optimization at scale
(analysis/weak-scaling/pm-ablation.jl); here the accounting is static and
exact for the compiled program.
"""

from __future__ import annotations

import dataclasses
import re

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1,
}

# Result-type extraction handles BOTH lowered forms:
#   sync:  %cp  = f32[8,128]{1,0} collective-permute(...)
#   async: %cps = (f32[8,128]{1,0}, f32[8,128]{1,0}, u32[], u32[])
#                 collective-permute-start(...)   [latency-hiding scheduler]
# For the async tuple the first array entry is the operand (== result shape);
# the matching collective-permute-done is NOT counted (same data movement).
_RESULT_TYPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _iter_permute_results(scope: str):
    """Yield (dtype, dims) for each collective-permute(-start) in ``scope``."""
    for line in scope.splitlines():
        if "collective-permute" not in line or "collective-permute-done" in line:
            continue
        eq = line.find("=")
        op = line.find("collective-permute")
        if eq < 0 or op < eq:
            continue
        m = _RESULT_TYPE_RE.search(line, eq, op)
        if m:
            yield m.group(1), m.group(2)


@dataclasses.dataclass
class CommStats:
    permute_count: int          # exchange ops per step (latency rounds)
    bytes_per_step: int         # bytes sent per device per step
    trip_count: int | None      # steps in the compiled loop (if annotated)
    per_op: list                # (dtype, shape, bytes) per permute


def _find_while_body(hlo: str):
    """Return (body_text, trip_count) of the steady-state while loop, or
    (None, None) when the program has no while (single-step program).

    Programs can carry several while loops (implicit-solve scans, blocked
    barotropic loops, the n-step outer loop); the steady-state STEP body is
    the one whose computation contains the halo-exchange permutes — pick
    the body with the most collective-permutes, not the first while in
    textual order (which picked a permute-free inner loop on the coupled
    climate program, round-5 fix)."""
    names = re.findall(r"while\([^)]*\)[^\n]*body=%([\w\.\-]+)", hlo)
    if not names:
        return None, None
    trip = None
    tm = re.search(r'known_trip_count[^}]*?"n":"(\d+)"', hlo)
    if tm:
        trip = int(tm.group(1))
    best, best_n = None, -1
    for body_name in dict.fromkeys(names):
        start = hlo.find(f"%{body_name} (")
        if start < 0:
            continue
        end = hlo.find("\n}", start)
        body = hlo[start:end]
        n = sum(1 for _ in _iter_permute_results(body))
        if n > best_n:
            best, best_n = body, n
    return best, trip


def collective_permute_stats(hlo: str) -> CommStats:
    """Per-step collective-permute accounting for a compiled sharded program.

    Counts permutes inside the steady-state while body (one execution per
    model step); for programs without a loop, counts the whole module.
    """
    body, trip = _find_while_body(hlo)
    scope = body if body is not None else hlo
    per_op = []
    total = 0
    for dt, dims in _iter_permute_results(scope):
        nbytes = _DTYPE_BYTES.get(dt, 4)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        b = n * nbytes
        per_op.append((dt, dims, b))
        total += b
    return CommStats(
        permute_count=len(per_op), bytes_per_step=total,
        trip_count=trip, per_op=per_op,
    )


# --- weak-scaling projection -------------------------------------------------

def project_weak_scaling(ms_per_step_compute: float, stats: CommStats, *,
                         link_bytes_per_sec: float,
                         latency_per_round: float,
                         bw_uncertainty: float,
                         chip_counts=(8, 16, 32, 64, 128, 256),
                         overlap: bool = True):
    """Project weak-scaling efficiency: fixed per-device tile, so bytes/step/
    device is constant with chip count; comm either hides under compute
    (overlap=True; the interior/boundary split + XLA latency hiding) or adds
    serially (the ablation). Returns {chips: {ms_per_step, efficiency,
    comm_ms, comm_ms_range, efficiency_range}} — the *_range fields span the
    ~``bw_uncertainty``x uncertainty applied to the WHOLE comm term (best
    case: nominal constants; worst case: every constant degraded by that
    factor — at production tile sizes the per-permute dispatch latency
    dominates the bytes term, so a bandwidth-only bar would understate).

    ``link_bytes_per_sec`` / ``latency_per_round``: the per-device halo
    link rate and per-collective-permute latency. They have no default:
    they must come from a measurement on the interconnect being projected."""
    t_comp = ms_per_step_compute / 1e3
    t_comm = stats.bytes_per_step / link_bytes_per_sec \
        + stats.permute_count * latency_per_round
    t_comm_hi = t_comm * bw_uncertainty
    out = {}
    for n in chip_counts:
        def total(tc):
            return max(t_comp, tc) if overlap else t_comp + tc

        t, t_hi = total(t_comm), total(t_comm_hi)
        out[n] = {
            "ms_per_step": 1e3 * t,
            "efficiency": t_comp / t,
            "comm_ms": 1e3 * t_comm,
            "comm_ms_range": [1e3 * t_comm, 1e3 * t_comm_hi],
            "efficiency_range": [t_comp / t_hi, t_comp / t],
        }
    return out
