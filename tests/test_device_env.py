"""What the program takes from its environment: the compile-cache
directory, the XLA flags, the device mesh and the multi-device dry run."""

import os

import jax
import numpy as np
import pytest

from gb25_tpu.parallel.mesh import _SPECIAL, factors, make_mesh
from gb25_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_honours_jax_compilation_cache_dir(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cache.enable_persistent_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    assert os.path.isdir(tmp_path / "cc")


def test_cache_default_is_one_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 64, 512])
def test_factors(n):
    """Rx * Ry = N; the special cases of the reference's table where they
    are consistent, else the divisor pair closest to Rx = 2 Ry."""
    rx, ry = factors(n)
    assert rx * ry == n
    if n in _SPECIAL:
        assert (rx, ry) == _SPECIAL[n]
        return
    score = lambda a, b: abs(np.log2(a / b) - 1.0)
    best = min(score(n // d, d) for d in range(1, n + 1) if n % d == 0)
    assert score(rx, ry) == best
    assert factors(4) == (2, 2)


@pytest.mark.parametrize("n", [4, 8])
def test_make_mesh_reshapes_the_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    mesh = make_mesh(n)
    assert mesh.axis_names == ("x", "y")
    assert mesh.devices.shape == factors(n)
    assert list(mesh.devices.flat) == jax.devices()[:n]


def test_make_mesh_refuses_missing_devices():
    with pytest.raises(ValueError, match="requested"):
        make_mesh(len(jax.devices()) + 1)


def test_dry_run_needs_an_explicit_cpu_pin(monkeypatch):
    """With too few devices the multi-device dry run moves to virtual CPU
    devices only under JAX_PLATFORMS=cpu; otherwise it fails."""
    import __graft_entry__

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)


def test_weak_scaling_projection_needs_a_measured_link_rate():
    from gb25_tpu.analysis.comm import CommStats, project_weak_scaling

    stats = CommStats(permute_count=8, bytes_per_step=10**6, trip_count=None, per_op=[])
    with pytest.raises(TypeError):
        project_weak_scaling(100.0, stats)
    out = project_weak_scaling(100.0, stats, link_bytes_per_sec=1e11,
                               latency_per_round=1e-5, bw_uncertainty=2.0,
                               chip_counts=(8,))
    assert set(out) == {8}
