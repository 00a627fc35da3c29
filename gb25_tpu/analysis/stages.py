"""Per-stage device time from a ``jax.profiler`` trace.

The step labels its stages with ``jax.named_scope`` ("closure", "tendency",
"barotropic", "vertical_solve" in models/hydrostatic.py, "fluxes" in
models/coupled.py). XLA keeps the scope path in each instruction's
``op_name`` metadata, and the profiler tags each device event with the HLO
instruction it ran (``hlo_op``). So the reduction maps every device event
to its instruction, the instruction (or, for a fusion, the computation it
calls) to the scopes in its metadata, and sums durations per stage. The
trace is read with ``jax.profiler.ProfileData`` alone.
"""

from __future__ import annotations

import collections
import glob
import os
import re

_COMP_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"(?:calls|body|condition|to_apply)=%?([\w.\-]+)")


def instruction_scopes(hlo_text: str) -> dict[str, set[str]]:
    """Instruction name -> the ``op_name`` paths of it and of the
    computations it calls (one level: a fusion's body)."""
    own: dict[str, set[str]] = {}
    calls: dict[str, list[str]] = {}
    per_comp: dict[str, set[str]] = collections.defaultdict(set)
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP_HEADER.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        names = set(_OP_NAME.findall(line))
        own[name] = names
        calls[name] = _CALLS.findall(line)
        if comp is not None:
            per_comp[comp] |= names
    return {name: own[name].union(*(per_comp.get(c, set()) for c in calls[name]))
            for name in own}


def stage_of(op_names: set[str], stages) -> str:
    """The first of ``stages`` named in any of ``op_names``, else "other"."""
    for stage in stages:
        tag = f"/{stage}/"
        if any(tag in n or n.endswith(f"/{stage}") for n in op_names):
            return stage
    return "other"


def device_events(xplane_path: str, plane_prefix: str = "/device:"):
    """(hlo_op or event name, start_ns, duration_ns) of every event with an
    ``hlo_op`` stat on the planes whose name starts with ``plane_prefix``."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats:
                    continue
                out.append((stats["hlo_op"], ev.start_ns, ev.duration_ns))
    return out


def stage_device_ms(trace_dir: str, hlo_text: str, stages,
                    plane_prefix: str = "/device:") -> dict:
    """Device ms per stage summed over the trace in ``trace_dir`` (the
    newest ``.xplane.pb`` under it), plus "other", "busy" (the union of
    event intervals) and "window" (first start to last end)."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    scopes = instruction_scopes(hlo_text)
    events = device_events(paths[-1], plane_prefix)
    if not events:
        raise ValueError(f"no device events on planes {plane_prefix!r}*")
    ms = dict.fromkeys(list(stages) + ["other"], 0.0)
    for name, _, dur in events:
        ms[stage_of(scopes.get(name, set()), stages)] += dur / 1e6
    spans = sorted((s, s + d) for _, s, d in events)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    ms["busy"] = busy / 1e6
    ms["window"] = (spans[-1][1] - spans[0][0]) / 1e6
    return ms
