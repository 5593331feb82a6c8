"""Production meshes.

The port of ``repro.launch.mesh``, over the port's
:class:`~repro_torch.sharding.ctx.Mesh`:

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices.

Under a running process group a mesh position is a process (rank ``i`` at
row-major position ``i``; the ranks fill the nodes in order, as
``torchrun`` starts them, and a node's ranks go round its cards), and the
mesh carries
the ``DeviceMesh`` its DTensors live on; :func:`init_process_group` starts
the group from ``RANK``/``WORLD_SIZE`` and :func:`init_mesh` builds a mesh
of any shape over it. With no group a mesh is built over the visible
devices (:func:`repro_torch.sharding.ctx.visible_devices`). With fewer
positions than the shape needs, :func:`make_production_mesh` raises a
``ValueError`` that names the shape, as ``jax.make_mesh`` does.
"""
from __future__ import annotations

import math
import os
import tempfile

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.sharding.ctx import Mesh, make_mesh, visible_devices


def _group_running() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _node() -> tuple[int, int, int, int]:
    """This process's ``(rank, world, local rank, local world)``: the
    global ones from ``RANK``/``WORLD_SIZE`` (default 0 and 1), its place
    on its node from ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` (default one node
    of the whole world)."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank % local_world)))
    return rank, world, local_rank, local_world


def init_process_group(device=None, *, store: str | None = None
                       ) -> torch.device:
    """Start this process's ``torch.distributed`` group, unless one runs:
    rank and world from :func:`_node`, the rendezvous a ``file://`` store
    at ``store`` (default ``$REPRO_MESH_STORE``; a one-process world may
    take a fresh file), the backend NCCL on the card when every rank of the
    node has a card of its own (``LOCAL_WORLD_SIZE`` at most the node's
    card count), gloo otherwise (on the CPU, or several ranks sharing a
    card). Returns the rank's device: ``cuda:<LOCAL_RANK mod the card
    count>`` on the card (made current), else ``device``."""
    import datetime

    import torch.distributed as dist
    dev = resolve_device(device)
    rank, world, local_rank, local_world = _node()
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if _group_running():
        return dev
    backend = "nccl" if dev.type == "cuda" \
        and local_world <= torch.cuda.device_count() else "gloo"
    store = store or os.environ.get("REPRO_MESH_STORE")
    if store is None:
        if world != 1:
            raise ValueError(f"a world of {world} ranks needs a shared "
                             f"store: pass store= or set REPRO_MESH_STORE")
        fd, store = tempfile.mkstemp(prefix="repro_mesh_store_")
        os.close(fd)
        os.unlink(store)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    return dev


def init_mesh(shape, axis_names, device=None) -> Mesh:
    """A mesh of ``shape`` over the running process group (started by
    :func:`init_process_group` when none runs), carrying its
    ``DeviceMesh``. The world must be the shape's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = init_process_group(device)
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a mesh of shape {shape} over {names} needs {math.prod(shape)} "
            f"processes, the group has {world}")
    local_world = _node()[3]
    devices = np.empty(world, dtype=object)
    devices[:] = [torch.device("cuda", i % local_world
                               % torch.cuda.device_count())
                  if dev.type == "cuda" else dev for i in range(world)]
    dm = DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                    mesh_dim_names=names)
    return Mesh(devices.reshape(shape), names, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _group_running():
        import torch.distributed as dist
        world = dist.get_world_size()
        if world < math.prod(shape):
            raise ValueError(
                f"a mesh of shape {shape} over {axes} needs "
                f"{math.prod(shape)} devices, {world} processes in the "
                f"group")
        return init_mesh(shape, axes, device)
    return make_mesh(shape, axes, visible_devices(device))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_size(mesh: Mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n
