"""Test configuration.

Mirrors the reference's CI trick (SURVEY.md section 4.2): run everything on
the CPU backend with 8 virtual XLA devices
(``--xla_force_host_platform_device_count=8``) so all distributed/sharded
code paths are exercised on a single host without accelerators.

Auto-loaded pytest plugins may import jax before this file runs, so we both
set the env vars and force a backend re-initialization. Tests marked ``gpu``
skip here; chip_smoke.py runs them on the card without this file.
"""

import os

os.environ["JAX_PLATFORMS"] = os.environ.get("GB25_TEST_BACKEND", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
try:  # drop any backend initialized before conftest import
    jax.clear_backends()
except Exception:
    pass
