"""Differential-correctness harness.

Reference behavior reimplemented: ``src/correctness.jl`` — field-by-field
comparison of two model states (there: Reactant vs vanilla CPU; here: e.g.
sharded vs single-device, f32 vs f64 oracle, GPU vs CPU) with per-field
max|psi|, max|delta| and argmax reporting, ``rtol=sqrt(eps(FT))``, ``atol=0``
defaults, and ``sync_states!`` to copy one state onto another's devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def default_rtol(dtype) -> float:
    dtype = np.dtype(dtype)
    if not np.issubdtype(dtype, np.floating):
        return 0.0  # integers compare exactly
    return float(np.sqrt(np.finfo(dtype).eps))


def _leaf_names(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(
            str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", p))))
            for p in path
        )
        out.append((name, leaf))
    return out


def compare_states(a, b, rtol=None, atol=0.0, throw_error=True, verbose=True,
                   loose_prefixes=(), loose_rtol=1e-4):
    """Compare two state pytrees field by field (reference: compare_states,
    correctness.jl:28-90). Returns list of (name, max_ref, max_err, argmax).

    ``loose_prefixes``: field-name prefixes compared at ``loose_rtol`` instead
    — used for tendency caches, whose magnitude is cancellation-suppressed so
    reduction-order roundoff looms large relative to their own max.
    """
    la, lb = _leaf_names(a), _leaf_names(b)
    assert [n for n, _ in la] == [n for n, _ in lb], "state structures differ"
    report, failures = [], []
    for (name, xa), (_, xb) in zip(la, lb):
        field_rtol = rtol
        if any(name.startswith(p) for p in loose_prefixes):
            field_rtol = max(loose_rtol, rtol or 0.0)
        va = np.asarray(jax.device_get(xa), dtype=np.float64)
        vb = np.asarray(jax.device_get(xb), dtype=np.float64)
        delta = np.abs(va - vb)
        scale = np.abs(va)
        max_ref = float(scale.max()) if scale.size else 0.0
        max_err = float(delta.max()) if delta.size else 0.0
        am = np.unravel_index(int(delta.argmax()), delta.shape) if delta.size else ()
        report.append((name, max_ref, max_err, am))
        tol = (field_rtol if field_rtol is not None else default_rtol(xa.dtype))
        if max_err > tol * max(max_ref, 1e-300) + atol:
            failures.append((name, max_ref, max_err, am))
        if verbose:
            print(f"  {name:24s} max|psi| = {max_ref:.6e}  max|delta| = {max_err:.6e} @ {am}")
    if failures and throw_error:
        lines = ", ".join(f"{n} (err {e:.3e})" for n, _, e, _ in failures)
        raise AssertionError(f"state comparison failed: {lines}")
    return report


def sync_states(src, dst):
    """Copy src state values onto dst's shardings/dtypes (reference:
    sync_states!, correctness.jl:92-115)."""

    def put(s, d):
        arr = jnp.asarray(np.asarray(jax.device_get(s)), dtype=d.dtype)
        sharding = getattr(d, "sharding", None)
        return jax.device_put(arr, sharding) if sharding is not None else arr

    return jax.tree_util.tree_map(put, src, dst)
