"""Per-host sharded checkpoint I/O with zero cross-process communication.

Reference behavior reimplemented: ``src/sharded_io.jl`` — each rank
serializes only its *addressable* shards together with their global index
ranges (``fields_rank{R}.dat``) plus iteration/time metadata; an offline
reassembly path rebuilds global fields (``load_global_field``), with no
gather at save time.

JAX mapping (SURVEY.md section 2b): ``jax.Array.addressable_shards``
exposes exactly (data, global index) per local shard; we write one
``.npz`` per host process and reassemble offline with NumPy.
"""

from __future__ import annotations

import json
import os
import re

import jax
import numpy as np


def _flatten_state(state) -> dict:
    """name -> jax.Array for every leaf of the state pytree."""
    flat = {}
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(state)[0]
    for path, leaf in leaves_with_paths:
        name = "/".join(
            str(getattr(p, "name", getattr(p, "key", getattr(p, "idx", p))))
            for p in path
        )
        flat[name] = leaf
    return flat


def save_sharded_state(state, directory, process_index=None, extra_metadata=None):
    """Write this process' addressable shards of every state field.

    Creates ``fields_rank{R}.npz`` with arrays ``{name}__shard{i}`` and a
    JSON index of global slices (reference: save_sharded_fields,
    sharded_io.jl:70-96).
    """
    os.makedirs(directory, exist_ok=True)
    rank = jax.process_index() if process_index is None else process_index
    flat = _flatten_state(state)

    arrays = {}
    index = {}
    for name, arr in flat.items():
        arr = jax.numpy.asarray(arr)
        entries = []
        for i, shard in enumerate(arr.addressable_shards):
            key = f"{name}__shard{i}"
            arrays[key] = np.asarray(shard.data)
            slices = [
                [0 if s.start is None else int(s.start),
                 arr.shape[d] if s.stop is None else int(s.stop)]
                for d, s in enumerate(shard.index)
            ]
            entries.append({"key": key, "slices": slices})
        index[name] = {"global_shape": list(arr.shape), "dtype": str(arr.dtype),
                       "shards": entries}

    meta = {
        "iteration": int(jax.numpy.asarray(flat["iteration"])) if "iteration" in flat else None,
        "time": float(jax.numpy.asarray(flat["time"])) if "time" in flat else None,
        "nprocs": jax.process_count(),
    }
    if extra_metadata:
        meta.update(extra_metadata)

    np.savez(os.path.join(directory, f"fields_rank{rank}.npz"), **arrays)
    with open(os.path.join(directory, f"index_rank{rank}.json"), "w") as f:
        json.dump({"meta": meta, "fields": index}, f)


def _rank_files(directory):
    pat = re.compile(r"index_rank(\d+)\.json$")
    ranks = sorted(
        int(pat.match(f).group(1)) for f in os.listdir(directory) if pat.match(f)
    )
    if not ranks:
        # consistent failure for all loaders (an empty/wrong directory used
        # to IndexError in load_all_fields/load_metadata)
        raise FileNotFoundError(f"no shard files in {directory}")
    return ranks


def load_global_field(directory, name) -> np.ndarray:
    """Offline reassembly of one field from all ranks' shard files
    (reference: load_global_field, sharded_io.jl:146-174)."""
    out = None
    for rank in _rank_files(directory):
        with open(os.path.join(directory, f"index_rank{rank}.json")) as f:
            idx = json.load(f)
        info = idx["fields"][name]
        if out is None:
            out = np.zeros(info["global_shape"], dtype=np.dtype(info["dtype"]))
        data = np.load(os.path.join(directory, f"fields_rank{rank}.npz"))
        for entry in info["shards"]:
            sl = tuple(slice(a, b) for a, b in entry["slices"])
            out[sl] = data[entry["key"]]
    if out is None:
        raise FileNotFoundError(f"no shard files in {directory}")
    return out


def load_all_fields(directory) -> dict:
    """Reassemble every saved field (reference: load_all_fields)."""
    ranks = _rank_files(directory)
    with open(os.path.join(directory, f"index_rank{ranks[0]}.json")) as f:
        names = list(json.load(f)["fields"].keys())
    return {n: load_global_field(directory, n) for n in names}


def load_metadata(directory) -> dict:
    ranks = _rank_files(directory)
    with open(os.path.join(directory, f"index_rank{ranks[0]}.json")) as f:
        return json.load(f)["meta"]


def restore_state(state_template, directory):
    """Rebuild a state pytree (on the template's shardings) from a checkpoint."""
    fields = load_all_fields(directory)
    # derive leaf names with the SAME function save uses (_flatten_state),
    # so the save/restore naming scheme cannot silently diverge
    names = iter(_flatten_state(state_template).keys())

    def rebuild(leaf):
        arr = fields[next(names)].astype(leaf.dtype)
        return jax.device_put(arr, leaf.sharding)

    return jax.tree_util.tree_map(rebuild, state_template)
