"""XSpace trace decoding test: emit a real jax.profiler trace (the CPU
backend writes the same .xplane.pb format as the GPU) and mine it with our
dependency-free decoder (reference analog: analysis/xspace + notebooks)."""

import jax
import jax.numpy as jnp

from gb25_tpu.analysis import find_xplane_files, parse_xspace, op_durations, summarize
from gb25_tpu.utils import with_profiler, annotate


def test_xplane_roundtrip(tmp_path):
    logdir = str(tmp_path / "trace")

    @jax.jit
    def f(a):
        return jnp.sin(a) @ a.T

    a = jnp.ones((256, 256))
    f(a).block_until_ready()
    with with_profiler(logdir):
        with annotate("bench", step=1):
            for _ in range(3):
                f(a).block_until_ready()

    files = find_xplane_files(logdir)
    assert files, "no xplane.pb produced"
    planes = parse_xspace(files[0])
    assert planes, "no planes decoded"
    names = [p.name for p in planes]
    assert any(names), names
    durs = op_durations(planes)
    assert durs
    top = summarize(logdir, top=5)
    assert len(top) > 0
    assert all(isinstance(n, str) and ms >= 0 for n, ms in top)


def test_native_scanner_matches_python(tmp_path):
    from gb25_tpu.native import get_xplane_fast

    fast = get_xplane_fast()
    if fast is None:
        import pytest

        pytest.skip("no C compiler available")

    logdir = str(tmp_path / "trace2")

    @jax.jit
    def f(a):
        return (a * 2.0).sum()

    a = jnp.ones((128, 128))
    f(a).block_until_ready()
    with with_profiler(logdir):
        f(a).block_until_ready()

    files = find_xplane_files(logdir)
    planes = parse_xspace(files[0])
    py = op_durations(planes)
    with open(files[0], "rb") as fh:
        data = fh.read()
    native = {}
    for pname, durs in fast.aggregate(data):
        for n, ps in durs.items():
            native[n] = native.get(n, 0.0) + ps / 1e9
    # same totals for every event the python path found
    for name, ms in py.items():
        assert abs(native.get(name, 0.0) - ms) < 1e-9, name
