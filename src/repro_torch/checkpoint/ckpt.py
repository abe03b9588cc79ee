"""Sharded checkpointing without external deps: tree -> manifest + npz shards
(the port's own copy of `repro.checkpoint.ckpt`, same files on disk).

Leaves (torch tensors or numpy arrays) are copied to the host, written as
numbered .npz files of at most about `shard_mb` each plus a JSON manifest
(tree structure, dtypes, shapes, step). A checkpoint written by either
package restores in the other, bit-equal. `restore` returns numpy arrays,
as the reference does without shardings; `models.api.params_from_numpy`
puts a params tree on a device.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

_SEP = "/"


def _flatten(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k2, v in sorted(node.items()):
                walk(f"{prefix}{_SEP}{k2}" if prefix else k2, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{_SEP}{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _host(val) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is detached and copied)."""
    if torch.is_tensor(val):
        if val.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: cast bf16 leaves to "
                            "float32 before saving a checkpoint")
        return val.detach().cpu().numpy()
    return np.asarray(val)


def save(path: str, tree: Any, step: int = 0, shard_mb: int = 512):
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    manifest = {"step": step, "entries": {}}
    shard, shard_idx, shard_bytes = {}, 0, 0
    limit = shard_mb * 1024 * 1024

    def flush():
        nonlocal shard, shard_idx, shard_bytes
        if shard:
            np.savez(os.path.join(path, f"shard_{shard_idx:05d}.npz"), **shard)
            shard, shard_bytes = {}, 0
            shard_idx += 1

    for key, val in flat.items():
        arr = _host(val)
        manifest["entries"][key] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "shard": shard_idx,
        }
        shard[key.replace(_SEP, "__")] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= limit:
            flush()
    flush()
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def restore(path: str):
    """(tree of numpy arrays, step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shards = {}
    flat_out = {}
    for key, meta in manifest["entries"].items():
        si = meta["shard"]
        if si not in shards:
            shards[si] = np.load(os.path.join(path, f"shard_{si:05d}.npz"))
        flat_out[key] = shards[si][key.replace(_SEP, "__")]
    return _unflatten(flat_out), manifest["step"]


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def _listify(node):
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_listify(node[k]) for k in sorted(node, key=int)]
        return {k: _listify(v) for k, v in node.items()}
    return node
