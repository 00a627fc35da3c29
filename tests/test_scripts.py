"""Driver/CLI-surface smoke tests: bench.py's JSON contract and the compile
artifact dump (reference CI runs its scripts the same way, SURVEY.md 4.4)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=1200):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_bench_json_contract():
    r = _run(["bench.py", "--nx", "64", "--ny", "32", "--nz", "8",
              "--steps", "2", "--headline-only"])
    assert r.returncode == 0, r.stderr[-2000:]
    line = [l for l in r.stdout.strip().splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    assert set(out) >= {"metric", "value", "unit", "vs_baseline", "device"}
    # the suite's virtual CPU devices (XLA_FLAGS) reach the child as well
    assert out["device"]["platform"] == "cpu" and out["device"]["kind"] == "cpu"
    assert out["device"]["count"] >= 1
    assert out["value"] > 0
    assert out["unit"] == "cell-steps/s"
    assert out["hbm_pct_peak"] is None  # the CPU has no published peak


def test_bench_atmosphere_row_contract():
    # the shallow-water atmosphere companion (BASELINE.md atmosphere rows)
    r = _run(["bench.py", "--config", "atmosphere", "--nx", "64", "--ny", "32",
              "--steps", "2", "--headline-only"])
    assert r.returncode == 0, r.stderr[-2000:]
    line = [l for l in r.stdout.strip().splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    assert out["config"] == "atmosphere"
    assert out["value"] > 0
    assert out["vs_baseline"] is None  # reference tile size unpublished
    assert out["metric"].startswith("shallow_water_atmosphere")


import pytest


@pytest.mark.skipif(
    not int(os.environ.get("GB25_SCRIPT_TESTS", "0")),
    reason="covered by the CI compile-artifacts job; set GB25_SCRIPT_TESTS=1",
)
def test_compile_dump_script(tmp_path):
    r = _run(["scripts/baroclinic_instability_compile.py",
              "--grid-x", "16", "--grid-y", "8", "--grid-z", "4",
              "--steps", "2", "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    names = os.listdir(tmp_path)
    assert any(n.endswith(".stablehlo.mlir") for n in names)
    assert any(n.endswith(".hlo.txt") for n in names)


@pytest.mark.skipif(
    not int(os.environ.get("GB25_SCRIPT_TESTS", "0")),
    reason="covered by the CI compile-artifacts job; set GB25_SCRIPT_TESTS=1",
)
def test_climate_compile_dump_script(tmp_path):
    r = _run(["scripts/ocean_climate_simulation_compile.py",
              "--resolution", "12", "--Nz", "4", "--steps", "2",
              "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    names = os.listdir(tmp_path)
    assert any("ocean_climate" in n and n.endswith(".stablehlo.mlir") for n in names)
    assert any("ocean_climate" in n and n.endswith(".hlo.txt") for n in names)
