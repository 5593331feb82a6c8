"""Production meshes.

The port of ``repro.launch.mesh``, over the port's
:class:`~repro_torch.sharding.ctx.Mesh`:

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices.

A mesh is built over the visible devices
(:func:`repro_torch.sharding.ctx.visible_devices`); with fewer than the
shape needs, :func:`make_production_mesh` raises a ``ValueError`` that
names the shape.
"""
from __future__ import annotations

from repro_torch.sharding.ctx import Mesh, make_mesh, visible_devices


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, visible_devices(device))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_size(mesh: Mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n
