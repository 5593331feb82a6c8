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

A bf16 leaf (a ``torch.bfloat16`` tensor, or a numpy array of an extension
``bfloat16`` dtype such as the reference's) is stored as the reference
stores it: its raw 2-byte words under the npy type ``'<V2'`` (numpy has no
bf16 of its own), with ``"bfloat16"`` in the manifest; the member's bytes
are the reference's. On load such a leaf comes back as a CPU
``torch.bfloat16`` tensor with the same bits; every other leaf as a numpy
array.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import zipfile

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


BF16 = "bfloat16"


def _host(path: str, leaf) -> tuple[np.ndarray, str]:
    """One leaf as a host numpy array and its manifest dtype. A bf16 leaf
    comes back as its raw words (uint16). A tensor of another dtype that
    numpy lacks (the fp8 types) raises."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), BF16
        try:
            arr = leaf.numpy()
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {path!r}: a {leaf.dtype} tensor has no "
                f"numpy dtype to store it as") from e
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == BF16:
        return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _savez(path: str, arrays: dict, dtypes: dict) -> None:
    """``np.savez(path, **arrays)``, member for member and byte for byte,
    each member's data written straight from the array (numpy copies it
    through 16 MB chunks); a leaf whose dtype is :data:`BF16` gets the npy
    type ``'<V2'`` that numpy gives the reference's bf16 arrays."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            head = fmt.header_data_from_array_1_0(arr)
            if dtypes[key] == BF16:
                head["descr"] = "<V2"
            data = arr.T if head["fortran_order"] else arr
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                fmt.write_array_header_1_0(f, head)
                f.write(np.ascontiguousarray(data).reshape(-1).view(np.uint8))


def _loadz(path: str) -> dict:
    """The npy members of an npz archive as arrays, each member read in
    one piece and its data viewed in place (numpy's own npz reader copies a
    large member through 256 KB reads, the most of a restore's time)."""
    fmt = np.lib.format
    readers = {(1, 0): fmt.read_array_header_1_0,
               (2, 0): fmt.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            buf = bytearray(zf.read(name))      # writable, as np.load's
            head = io.BytesIO(buf)
            shape, fortran, dtype = readers[fmt.read_magic(head)](head)
            arr = np.frombuffer(buf, dtype=dtype, offset=head.tell(),
                                count=int(np.prod(shape)))
            out[name[:-len(".npy")]] = arr.reshape(
                shape, order="F" if fortran else "C")
    return out


def bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU ``torch.bfloat16`` tensor holding the 2-byte words of ``arr``
    (raw ``'V2'`` words, or an extension ``bfloat16`` array)."""
    words = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(words.copy()).view(torch.bfloat16)


def save_checkpoint(state, step: int, directory: str) -> str:
    os.makedirs(directory, exist_ok=True)
    dest = os.path.join(directory, f"ckpt_{step:08d}")
    tmp = dest + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    manifest = {"step": step, "leaves": {}}
    arrays, dtypes = {}, {}
    for i, (path, leaf) in enumerate(sorted(flat.items())):
        arr, dtype = _host(path, leaf)
        key = f"a{i}"
        arrays[key], dtypes[key] = arr, dtype
        manifest["leaves"][path] = {
            "key": key, "shape": list(arr.shape), "dtype": dtype}
    _savez(os.path.join(tmp, "arrays.npz"), arrays, dtypes)
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
    data = _loadz(os.path.join(path, "arrays.npz"))
    flat = {}
    for p, meta in manifest["leaves"].items():
        arr = data[meta["key"]]
        assert list(arr.shape) == meta["shape"]
        flat[p] = bf16_tensor(arr) if meta["dtype"] == BF16 else arr
    state = _unflatten(flat)
    if like is not None:
        ref = _flatten(like)
        assert set(ref) == set(flat), "checkpoint tree mismatch"
        for p in ref:
            assert tuple(ref[p].shape) == tuple(flat[p].shape), p
    return state, manifest["step"]
