"""State and batch placement on a mesh (the port's ``in_shardings``).

The reference's sharded train step takes its state and batch placed by
``NamedSharding``\\ s: the parameters, the AdamW moments and the master by
``tree_param_specs(params, tp, data_size)``, the step counter replicated,
the batch by ``batch_specs`` (``repro.launch.dryrun._state_struct_and_specs``
and ``_batch_struct_and_specs``). Here the same specs become DTensor
placements (:func:`repro_torch.sharding.specs.placements`) on the mesh's
``DeviceMesh``, one process a mesh position.

Every rank holds the same full tree (drawn from one seed, read from one
checkpoint, or one batch of :class:`repro_torch.data.SyntheticTokens`) and
keeps its own shard of it: no data moves, and a sharded run starts from an
unsharded run's bits. :func:`gather_state` is the way back (every rank
takes part; each gets the full tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import batch_axes, data_size
from repro_torch.sharding import ctx
from repro_torch.sharding.specs import (P, batch_specs, placements,
                                        tree_param_specs)
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
    ``x`` (a shard that is all of ``x``, one replicated on every axis, is
    ``x`` itself), on ``device`` (default the mesh's device type; a meta
    tensor stays on the meta device)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if device is None:
        device = "meta" if torch.is_tensor(x) and x.is_meta \
            else dm.device_type
    t = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                        device=device)
    dt = distribute_tensor(t, dm, placements(spec, dm), src_data_rank=None)
    local = dt.to_local()
    if local.numel() == t.numel():
        return dt
    return DTensor.from_local(local.clone(), dm, dt.placements,
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
    replicated. ``mesh`` None: the configured one."""
    mesh = mesh or ctx.current_mesh()
    dm = _device_mesh(mesh)
    specs = batch_specs(batch_axes(mesh), cfg, shape)
    return {k: place(v, specs[k], dm, device) for k, v in batch.items()}


def gather_state(state, device="cpu"):
    """Every leaf as a full tensor on ``device`` (a copy): DTensors
    gathered (a collective: every rank calls it, in tree order), plain
    tensors copied."""
    def full(x):
        if ctx.is_dtensor(x):
            x = x.full_tensor()
        return torch.as_tensor(x).to(device, copy=True)
    return tree_map(full, state)
