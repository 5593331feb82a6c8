"""State and batch placement on a mesh (the port's ``in_shardings``).

The reference's sharded train step takes its state and batch placed by
``NamedSharding``\\ s: the parameters, the AdamW moments and the master by
``tree_param_specs(params, tp, data_size)``, the step counter replicated,
the batch by ``batch_specs`` (``repro.launch.dryrun._state_struct_and_specs``
and ``_batch_struct_and_specs``); its sharded decode step takes the
parameters by the same specs, the cache by ``cache_specs`` and the tokens
by ``P(ba)`` or ``P()`` (``lower_decode``). Here the same specs become DTensor
placements (:func:`repro_torch.sharding.specs.placements`) on the mesh's
``DeviceMesh``, one process a mesh position.

Every rank holds the same full tree (drawn from one seed, read from one
checkpoint, or one batch of :class:`repro_torch.data.SyntheticTokens`) and
keeps its own shard of it: no data moves, and a sharded run starts from an
unsharded run's bits. :func:`gather_state` is the way back (every rank
takes part; each gets the full tensors).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.launch.mesh import batch_axes, data_size
from repro_torch.sharding import ctx
from repro_torch.sharding.specs import (P, batch_specs, cache_specs,
                                        placements, tree_param_specs)
from repro_torch.train.optimizer import tree_map


def _device_mesh(mesh):
    if mesh.device_mesh is None:
        raise ValueError(
            f"mesh {mesh.shape} has no DeviceMesh: place on a mesh from "
            f"launch.mesh.init_mesh")
    return mesh.device_mesh


def place(x, spec, dm, device=None):
    """A full tensor (or numpy array) ``x``, the same on every rank, as a
    DTensor placed by ``spec`` on ``dm``: this rank's shard, copied out of
    ``x``, on ``device`` (default the mesh's device type; a meta tensor
    stays on the meta device). A shard that is all of ``x`` (every axis
    it splits over is of size 1, or none) is ``x`` itself, not a copy: on
    a mesh of one device a full-width model is placed in no more
    memory."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    if device is None:
        device = "meta" if torch.is_tensor(x) and x.is_meta \
            else dm.device_type
    t = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                        device=device)
    pl = placements(spec, dm)
    if all(dm.size(i) == 1 for i, p in enumerate(pl) if isinstance(p, Shard)):
        return DTensor.from_local(t.detach(), dm, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    dt = distribute_tensor(t, dm, pl, src_data_rank=None)
    return DTensor.from_local(dt.to_local().clone(), dm, dt.placements,
                              shape=dt.shape, stride=dt.stride())


def state_specs(state, mesh) -> dict:
    """The state's specs: ``params``, ``m``, ``v`` (and ``master``) by
    ``tree_param_specs(params, tp, data_size)``, ``step`` replicated."""
    p_specs = tree_param_specs(state["params"], mesh.shape["model"],
                               data_size(mesh))
    o_specs = {"m": p_specs, "v": p_specs, "step": P()}
    if "master" in state["opt"]:
        o_specs["master"] = p_specs
    return {"params": p_specs, "opt": o_specs}


def place_state(state, mesh, device=None) -> dict:
    """``state`` (``{"params", "opt": {"m", "v", "step"[, "master"]}}``,
    full tensors or numpy arrays) placed on ``mesh``."""
    dm = _device_mesh(mesh)
    return tree_map(lambda x, s: place(x, s, dm, device), state,
                    state_specs(state, mesh))


def place_params(params, mesh, device=None) -> dict:
    """A parameter tree placed on ``mesh`` by ``tree_param_specs`` (the
    state's ``params``, :func:`state_specs`)."""
    dm = _device_mesh(mesh)
    specs = tree_param_specs(params, mesh.shape["model"], data_size(mesh))
    return tree_map(lambda x, s: place(x, s, dm, device), params, specs)


def place_batch(batch, cfg, shape=None, mesh=None, device=None) -> dict:
    """A full batch placed by ``batch_specs``: its batch axis split over
    the mesh's batch axes (``("pod", "data")`` or ``("data",)``), the rest
    replicated. ``mesh`` None: the configured one.

    Rows that do not split evenly over the batch axes' ``n`` ranks (a
    microbatch of fewer rows than ``n``, or a count that does not divide)
    are placed as DTensor's uneven parts, ``torch.chunk``'s: ceil(B / n)
    rows on each of the first ranks (in the batch axes' order, "pod"
    before "data"), the rest on the next, none on the last; the "model"
    ranks of a batch position hold the same rows. These are the rows XLA
    gives each device when it pads the reference's pin of that dimension;
    the model's blocks run on them (``ctx.local_map``, ``ctx.matmul``)."""
    mesh = mesh or ctx.current_mesh()
    dm = _device_mesh(mesh)
    specs = batch_specs(batch_axes(mesh), cfg, shape)
    return {k: place(v, specs[k], dm, device) for k, v in batch.items()}


def place_cache(cache, cfg, batch, mesh=None, kv_shardable=False,
                device=None) -> dict:
    """A decode cache (``model.init_cache``'s dict, full tensors) placed by
    ``cache_specs(batch_axes, cfg, batch, kv_shardable, data_size)``:
    ``batch`` rows at least the mesh's batch axes' size split over them,
    fewer (long-context) split the sequence over "data"; the kv heads over
    "model" when ``kv_shardable`` (``hkv % tp == 0``, as ``lower_decode``
    decides); the Mamba states' d_inner over "model". The shared length
    ``"len"`` stays the replicated host int. ``mesh`` None: the configured
    one. A leaf whose split dimension does not divide by its mesh axes'
    size raises ``ValueError``, as the reference's ``jax.jit`` refuses
    such ``in_shardings`` (DTensor would give the last rank a shorter
    part, and the sequence branch reads every part as of one length)."""
    mesh = mesh or ctx.current_mesh()
    dm = _device_mesh(mesh)
    specs = cache_specs(batch_axes(mesh), cfg, batch, kv_shardable,
                        data_size(mesh))
    for k, v in cache.items():
        for i, entry in enumerate(() if k == "len" else specs[k]):
            n = math.prod(mesh.shape[a] for a in (
                entry if isinstance(entry, tuple) else (entry,)) if a)
            if v.shape[i] % n:
                raise ValueError(
                    f"cache leaf {k!r} {tuple(v.shape)}: dimension {i} "
                    f"({v.shape[i]}) does not divide by the {n} devices "
                    f"of {entry!r} (cache_specs {specs[k]!r})")
    return {k: v if k == "len" else place(v, specs[k], dm, device)
            for k, v in cache.items()}


def place_tokens(tokens, mesh=None, device=None):
    """Decode tokens [B] placed as ``lower_decode`` places them: ``P(ba)``
    (rows over the batch axes) when B is at least their size, else
    ``P()`` (every device all rows)."""
    mesh = mesh or ctx.current_mesh()
    ba = batch_axes(mesh)
    spec = P(ba) if len(tokens) >= data_size(mesh) else P()
    return place(tokens, spec, _device_mesh(mesh), device)


def gather_state(state, device="cpu"):
    """Every leaf as a full tensor on ``device`` (a copy): DTensors
    gathered (a collective: every rank calls it, in tree order), plain
    tensors copied; a host int (a cache's ``"len"``) as it is."""
    def full(x):
        if isinstance(x, int):
            return x
        if ctx.is_dtensor(x):
            x = x.full_tensor()
        return torch.as_tensor(x).to(device, copy=True)
    return tree_map(full, state)
