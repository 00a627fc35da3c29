"""The pieces of ``chip_smoke.py`` that need no GPU: the refusal of another
platform, the form of the last line, the ``nvidia-smi`` line, the peak
table, the phase selection, and the per-stage reduction of a trace."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from gb25_tpu.utils.device import device_peaks, parse_nvidia_smi  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("platform", ["cpu", "rocm", "METAL"])
def test_require_gpu_refuses_other_platforms(platform):
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(platform)
    assert e.value.code == 1


def test_require_gpu_accepts_gpu():
    chip_smoke.require_gpu("gpu")


def test_result_line_form():
    line = chip_smoke.result_line({"platform": "gpu", "kind": H100, "count": 1})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", H100, 700.0),
    ("NVIDIA H100 80GB HBM3, 400.00 W\n", H100, 400.0),
    (" NVIDIA H100 PCIe, 350 W ", "NVIDIA H100 PCIe", 350.0),
])
def test_parse_nvidia_smi(line, name, watts):
    assert parse_nvidia_smi(line) == (name, watts)


def test_parse_nvidia_smi_rejects_other_lines():
    with pytest.raises(ValueError):
        parse_nvidia_smi("NVIDIA-SMI has failed")


def test_h100_peaks():
    peaks = device_peaks(H100)
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["f32_flop_per_s"] == 67e12
    assert "data sheet" in peaks["source"]


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        device_peaks(kind)


def test_cpu_has_no_peak():
    assert device_peaks("cpu") is None


def test_phase_selection():
    assert chip_smoke.phases(four=True) == ("device", "sharded")
    one = chip_smoke.phases(four=False)
    assert one[0] == "device" and "sharded" not in one
    assert one == ("device", "flagship", "climate", "thomas", "gpu_vs_cpu", "gpu_tests")


@pytest.mark.parametrize("hlo,expected", [
    ('%c = f32[8] custom-call(%a), custom_call_target="__gpu$xla.gpu.triton"', True),
    ("%w = (f32[8]) while(%t), body=%body", False),
])
def test_takes_triton(hlo, expected):
    assert chip_smoke.takes_triton(hlo) is expected


def _run_main(monkeypatch, capsys, argv, count):
    ran = []

    def device_phase(self, four):
        ran.append("device")
        self.device = {"platform": "gpu", "kind": H100, "count": count}

    monkeypatch.setattr(chip_smoke.Smoke, "device_phase", device_phase)
    for phase in ("flagship", "climate", "thomas", "gpu_vs_cpu", "gpu_tests", "sharded"):
        monkeypatch.setattr(chip_smoke.Smoke, f"{phase}_phase",
                            lambda self, p=phase: ran.append(p))
    assert chip_smoke.main(argv) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    return ran, json.loads(last)


def test_main_four_runs_only_its_phases(monkeypatch, capsys):
    ran, last = _run_main(monkeypatch, capsys, ["--four"], 4)
    assert ran == ["device", "sharded"]
    assert last == {"ok": True, "device": {"platform": "gpu", "kind": H100, "count": 4}}


def test_main_one_card_runs_every_other_phase(monkeypatch, capsys):
    ran, last = _run_main(monkeypatch, capsys, [], 1)
    assert ran == list(chip_smoke.ONE_CARD_PHASES)
    assert last["device"]["count"] == 1


def _script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(r):
    return r.returncode != 0 and '"ok"' not in r.stdout


def test_script_refuses_the_cpu():
    assert _no_result(_script(REPO))


def test_script_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    assert _no_result(_script(tmp_path))


def test_stage_reduction_of_a_cpu_trace(tmp_path):
    """Device time per named scope, read back from a real profiler trace
    (the host CPU's plane here; the GPU's on the card)."""
    from gb25_tpu.analysis.stages import instruction_scopes, stage_device_ms, stage_of

    def f(x):
        with jax.named_scope("tendency"):
            y = jnp.sin(x) * 2
        with jax.named_scope("vertical_solve"):
            z = jnp.cumsum(y, axis=0)
        return z

    jf = jax.jit(f)
    x = jnp.ones((512, 512), jnp.float32)
    jf(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(2):
            jf(x).block_until_ready()
    hlo = jf.lower(x).compile().as_text()
    scopes = instruction_scopes(hlo)
    assert any(stage_of(s, ("tendency",)) == "tendency" for s in scopes.values())
    ms = stage_device_ms(str(tmp_path), hlo, ("tendency", "vertical_solve"),
                         plane_prefix="/host:CPU")
    assert set(ms) == {"tendency", "vertical_solve", "other", "busy", "window"}
    assert ms["tendency"] + ms["vertical_solve"] > 0
    assert 0 < ms["busy"] <= ms["window"]


def test_stage_of_takes_the_first_stage_named():
    from gb25_tpu.analysis.stages import stage_of

    stages = ("closure", "tendency")
    assert stage_of({"jit(loop)/while/body/tendency/mul"}, stages) == "tendency"
    assert stage_of({"a/tendency/x", "a/closure/y"}, stages) == "closure"
    assert stage_of({"jit(f)/add"}, stages) == "other"
    assert stage_of(set(), stages) == "other"


def test_perturb_ulp_moves_floats_by_about_one_ulp():
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import baroclinic_instability_state

    grid = simple_latitude_longitude_grid(16, 8, 4, dtype=jnp.float32)
    state = baroclinic_instability_state(grid, noise_velocity=1e-3)
    nudged = chip_smoke.perturb_ulp(state)
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(nudged)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        if a.dtype.kind == "f":
            assert np.all(np.abs(b - a) <= 8 * 2.0 ** -23 * np.abs(a))
    T0, T1 = np.asarray(state.tracers["T"]), np.asarray(nudged.tracers["T"])
    assert (T0 != T1).any()


def test_prognostic_fields_lists_velocities_surface_and_tracers():
    from gb25_tpu.grids import simple_latitude_longitude_grid
    from gb25_tpu.models import baroclinic_instability_state

    grid = simple_latitude_longitude_grid(16, 8, 4, dtype=jnp.float32)
    state = baroclinic_instability_state(grid)
    fields = chip_smoke.prognostic_fields(state, state)
    assert [f[0] for f in fields] == ["u", "v", "eta"] + list(state.tracers)
    assert all(len(f) == 3 for f in fields)


@pytest.mark.parametrize("gap,nudge,failed", [
    (1e-7, 0.0, False),   # within the stated tolerance
    (1e-3, 1e-2, False),  # beyond it, within the rounding sensitivity
    (1e-3, 1e-4, True),   # beyond both
])
def test_held_to(capsys, gap, nudge, failed):
    ref = np.linspace(1.0, 2.0, 16)
    got, nudged = ref.copy(), ref.copy()
    got[3] += gap
    nudged[5] += nudge
    bad = chip_smoke.held_to("t", "case", dict(rtol=2e-5, atol=1e-8),
                             [("u", got, ref, nudged)])
    assert bool(bad) is failed
    out = capsys.readouterr().out
    assert out.startswith("[t] case u: ")
    assert ("beyond" in out) is (gap > 1e-6)
