"""What a measurement says about the device it ran on: the platform and kind
as JAX reports them, the card's name and power limit as ``nvidia-smi``
reports them, and the published peak rates the roofline shares divide by."""

from __future__ import annotations

import subprocess

# Published peaks by ``device_kind``. A device missing here is an error, not a
# default: add its row with the source beside it.
# H100 SXM: NVIDIA H100 Tensor Core GPU data sheet (SXM5, dense rates):
# 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores, at 700 W.
# "cpu" has no published peak; it is listed so the CPU smoke runs name it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flop_per_s": 67e12,
        "source": "NVIDIA H100 SXM data sheet",
    },
    "cpu": None,
}

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def device_peaks(kind: str):
    """Peak rates of ``kind`` (None for a device with no published peak)."""
    if kind not in PEAKS:
        raise ValueError(
            f"no peak rates for device_kind {kind!r}: add its row, with its "
            "source, to gb25_tpu.utils.device.PEAKS")
    return PEAKS[kind]


def device_info() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def parse_nvidia_smi(line: str) -> tuple[str, float]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> (name, power limit in W)."""
    name, _, limit = line.strip().rpartition(",")
    if not name:
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    value = limit.strip()
    if value.endswith("W"):
        value = value[:-1]
    return name.strip(), float(value)


def nvidia_smi_line() -> str:
    """First card's ``name, power.limit`` line from ``nvidia-smi``."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]

