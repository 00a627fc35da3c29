"""Environment preamble for distributed runs.

Reference behavior: ``GordonBell25.preamble()``
(/root/reference/src/timestepping_utils.jl:47-67) unsets proxy variables that
hang XLA's distributed rendezvous and fixes TMPDIR handling; the submission
generator additionally sets collective-timeout XLA flags
(sharding/common_submission_generator.jl:121-146). No XLA flag is set here:
none has been measured to help on the GPU yet.
"""

from __future__ import annotations

import os

_PROXY_VARS = (
    "http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY",
    "no_proxy", "NO_PROXY", "all_proxy", "ALL_PROXY",
)


def preamble(collective_timeout_minutes: int = 30):
    """Sanitize the environment before jax.distributed.initialize()."""
    for var in _PROXY_VARS:
        os.environ.pop(var, None)

    # a usable TMPDIR (some schedulers hand out per-job paths that vanish)
    tmpdir = os.environ.get("TMPDIR", "/tmp")
    if not os.path.isdir(tmpdir):
        os.environ["TMPDIR"] = "/tmp"

    # hang detection: bound the distributed rendezvous (reference: XLA
    # collective call timeouts used as hang detectors, SURVEY.md section 5)
    os.environ.setdefault(
        "JAX_DISTRIBUTED_INITIALIZATION_TIMEOUT_SECONDS",
        str(collective_timeout_minutes * 60),
    )
