"""Elastic re-meshing: continue training on the surviving devices.

The port of ``repro.runtime.elastic``. On permanent pod loss the runtime
(1) rebuilds the mesh from the surviving device set, (2) rebuilds the
train step for the new mesh, and (3) restores the last checkpoint into the
new placement (checkpoints are stored as host numpy). The global batch is
kept constant by raising per-pod microbatches.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.sharding.ctx import Mesh, make_mesh, visible_devices


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    microbatch_scale: int


def remesh_plan(old_pods: int, lost_pods: int, base_shape=(16, 16),
                axis_names=("data", "model")) -> ElasticPlan:
    """Plan after losing ``lost_pods``: same per-pod mesh, scaled microbatches."""
    left = old_pods - lost_pods
    assert left >= 1, "no pods left"
    if left == 1:
        return ElasticPlan(base_shape, axis_names, old_pods)
    return ElasticPlan((left,) + base_shape, ("pod",) + axis_names,
                       old_pods // left if old_pods % left == 0 else old_pods)


def rebuild_mesh(plan: ElasticPlan, devices=None) -> Mesh:
    """The plan's mesh over ``devices`` (None = every visible device of
    the card)."""
    devices = devices if devices is not None else visible_devices()
    need = math.prod(plan.mesh_shape)
    assert len(devices) >= need, (len(devices), need)
    return make_mesh(plan.mesh_shape, plan.axis_names, devices)
