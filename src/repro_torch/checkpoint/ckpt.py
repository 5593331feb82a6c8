"""Sharded checkpoint save/restore (npz + json manifest, atomic rename).

The port of ``repro.checkpoint.ckpt``, with the same on-disk format: a
``ckpt_{step:08d}`` directory holding ``arrays.npz`` and
``manifest.json``, so a checkpoint written by either package loads in the
other. Leaves are gathered to the host (a tensor through
``.detach().cpu().numpy()``, anything else through ``np.asarray``) and
stored flat-keyed; the manifest records step, tree paths, shapes and
dtypes so restores can validate against the live model before overwriting
anything. Writes go to ``<dir>.tmp`` and are renamed only after fsync — a
torn write never shadows a good checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _unflatten(flat):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host(path: str, leaf) -> np.ndarray:
    """One leaf as a host numpy array. A tensor whose dtype numpy lacks
    (bf16 and the other reduced floats) raises: how to store those is
    settled with the training slice."""
    if isinstance(leaf, torch.Tensor):
        try:
            return leaf.detach().cpu().numpy()
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {path!r}: a {leaf.dtype} tensor has no "
                f"numpy dtype to store it as") from e
    return np.asarray(leaf)


def save_checkpoint(state, step: int, directory: str) -> str:
    os.makedirs(directory, exist_ok=True)
    dest = os.path.join(directory, f"ckpt_{step:08d}")
    tmp = dest + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    manifest = {"step": step, "leaves": {}}
    arrays = {}
    for i, (path, leaf) in enumerate(sorted(flat.items())):
        arr = _host(path, leaf)
        key = f"a{i}"
        arrays[key] = arr
        manifest["leaves"][path] = {
            "key": key, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.rename(tmp, dest)
    return dest


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    cands = sorted(d for d in os.listdir(directory)
                   if d.startswith("ckpt_") and not d.endswith(".tmp"))
    return os.path.join(directory, cands[-1]) if cands else None


def load_checkpoint(path: str, like=None):
    """Returns (state, step). ``like`` (optional) validates shapes/dtypes."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat = {}
    for p, meta in manifest["leaves"].items():
        arr = data[meta["key"]]
        assert list(arr.shape) == meta["shape"]
        flat[p] = arr
    state = _unflatten(flat)
    if like is not None:
        ref = _flatten(like)
        assert set(ref) == set(flat), "checkpoint tree mismatch"
        for p in ref:
            assert tuple(ref[p].shape) == tuple(flat[p].shape), p
    return state, manifest["step"]
