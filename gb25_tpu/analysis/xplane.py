"""Minimal pure-Python decoder for XLA profiler XSpace/XPlane protobufs.

Reference capability: ``analysis/xspace/tensorflow/profiler/xplane_pb.jl`` —
a ProtoBuf.jl-generated decoder for the `.xplane.pb` traces that the
reference's notebooks mine for kernel statistics (NCCL send/recv durations
etc., analysis/analyze_traces.ipynb). ``jax.profiler.trace`` on the GPU emits
the *same* XSpace format, so this hand-rolled wire-format walker (no protobuf
dependency is available in the image) provides the equivalent offline
analysis layer.

Implements just the XSpace schema (tensorflow/profiler/protobuf/xplane.proto):
XSpace{planes=1} / XPlane{id=1,name=2,lines=3,event_metadata=4,stat_metadata=5}
/ XLine{id=1,name=2,timestamp_ns=3,events=4} / XEvent{metadata_id=1,
offset_ps=2,duration_ps=3,stats=4} / XEventMetadata{id=1,name=2} /
XStat{metadata_id=1,double=2,uint64=3,int64=4,str=5,bytes=6,ref=7} /
XStatMetadata{id=1,name=2}.
"""

from __future__ import annotations

import dataclasses
import glob
import os


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf):
    """Iterate (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _zigzag(v):
    return v  # xplane uses plain int64 varints


@dataclasses.dataclass
class XEvent:
    metadata_id: int = 0
    offset_ps: int = 0
    duration_ps: int = 0
    stats: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class XLine:
    id: int = 0
    name: str = ""
    timestamp_ns: int = 0
    events: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class XPlane:
    id: int = 0
    name: str = ""
    lines: list = dataclasses.field(default_factory=list)
    event_names: dict = dataclasses.field(default_factory=dict)
    stat_names: dict = dataclasses.field(default_factory=dict)


def _parse_stat(buf, stat_names):
    sid, val = 0, None
    for f, w, v in _fields(buf):
        if f == 1:
            sid = v
        elif f == 2:
            import struct

            val = struct.unpack("<d", v)[0]
        elif f in (3, 4, 7):
            val = v
        elif f == 5:
            val = v.decode("utf-8", "replace")
        elif f == 6:
            val = v
    return sid, val


def _parse_event(buf):
    ev = XEvent()
    for f, w, v in _fields(buf):
        if f == 1:
            ev.metadata_id = v
        elif f == 2:
            ev.offset_ps = v
        elif f == 3:
            ev.duration_ps = v
        elif f == 4:
            sid, val = _parse_stat(v, None)
            ev.stats[sid] = val
    return ev


def _parse_line(buf):
    line = XLine()
    for f, w, v in _fields(buf):
        if f == 1:
            line.id = v
        elif f == 2:
            line.name = v.decode("utf-8", "replace")
        elif f == 3:
            line.timestamp_ns = v
        elif f == 4:
            line.events.append(_parse_event(v))
    return line


def _parse_kv_metadata(buf):
    """map<int64, X*Metadata> entry -> (id, name)."""
    key, name = 0, ""
    for f, w, v in _fields(buf):
        if f == 1:
            key = v
        elif f == 2:  # the metadata message
            for f2, w2, v2 in _fields(v):
                if f2 == 1:
                    key = v2 if not key else key
                elif f2 == 2:
                    name = v2.decode("utf-8", "replace")
    return key, name


def _parse_plane(buf):
    plane = XPlane()
    for f, w, v in _fields(buf):
        if f == 1:
            plane.id = v
        elif f == 2:
            plane.name = v.decode("utf-8", "replace")
        elif f == 3:
            plane.lines.append(_parse_line(v))
        elif f == 4:
            k, n = _parse_kv_metadata(v)
            plane.event_names[k] = n
        elif f == 5:
            k, n = _parse_kv_metadata(v)
            plane.stat_names[k] = n
    return plane


def parse_xspace(path) -> list[XPlane]:
    with open(path, "rb") as f:
        buf = f.read()
    planes = []
    for f_, w, v in _fields(buf):
        if f_ == 1:
            planes.append(_parse_plane(v))
    return planes


def find_xplane_files(logdir):
    return sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True))


def op_durations(planes, plane_filter=None):
    """Aggregate total duration [ms] per event name across planes/lines."""
    totals = {}
    for plane in planes:
        if plane_filter and plane_filter not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                name = plane.event_names.get(ev.metadata_id, str(ev.metadata_id))
                totals[name] = totals.get(name, 0.0) + ev.duration_ps / 1e9
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def aggregate_file(path, plane_filter=None):
    """Total duration [ms] per event name for one xplane file. Uses the
    native C scanner (gb25_tpu.native) when available; pure-Python otherwise."""
    from gb25_tpu.native import get_xplane_fast

    fast = get_xplane_fast()
    totals = {}
    if fast is not None:
        with open(path, "rb") as f:
            data = f.read()
        for plane_name, durs in fast.aggregate(data):
            if plane_filter and plane_filter not in plane_name:
                continue
            for name, ps in durs.items():
                totals[name] = totals.get(name, 0.0) + ps / 1e9
        return totals
    return op_durations(parse_xspace(path), plane_filter)


def summarize(logdir, top=20, plane_filter=None):
    """Top ops by total time across all xplane files under logdir."""
    out = {}
    for path in find_xplane_files(logdir):
        for name, ms in aggregate_file(path, plane_filter).items():
            out[name] = out.get(name, 0.0) + ms
    items = sorted(out.items(), key=lambda kv: -kv[1])[:top]
    return items
