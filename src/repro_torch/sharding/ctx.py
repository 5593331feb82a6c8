"""Sharding context: the device mesh, logical-axis rules, the head plan.

The port of ``repro.sharding.ctx``. Model code annotates activations with
*logical* axes ("batch", "tp", ...); ``configure(mesh)`` binds them to mesh
axes, while unit tests and single-device runs leave the context unset.
The port's :class:`Mesh` is its own small value (an array of
``torch.device`` with named axes, as ``jax.sharding.Mesh``), so
:func:`grid_mesh`, :mod:`repro_torch.launch.mesh` and
:mod:`repro_torch.runtime.elastic` build meshes without jax.

Visible devices are the ``k`` CUDA devices when the port runs on the
card, the caller's first (``cuda:i..k-1`` then ``cuda:0..i-1``); on the
CPU they are ``k`` copies of ``cpu``, where ``k`` is
:func:`host_device_count` (default 1, set by :func:`set_host_device_count`,
the port's ``--xla_force_host_platform_device_count``). The scheduler's
grid launch splits its instance rows over a :func:`grid_mesh`
(:func:`repro_torch.core.greedy_torch.greedy_fanout_grid_torch`).

Under a mesh the port runs one process per mesh position, as
``torch.distributed`` does: :func:`configure` also binds the
``DeviceMesh`` the mesh carries (a mesh from
:func:`repro_torch.launch.mesh.init_mesh`), and tensors placed on it are
DTensors (:mod:`repro_torch.sharding.place`). :func:`shard` is then the
counterpart of ``with_sharding_constraint``: a DTensor is redistributed to
the placements its logical axes resolve to. A plain tensor, or any tensor
with no mesh configured, passes through unchanged once the axes are
checked, so single-device runs make no DTensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

_CTX: dict | None = None
_HOST_DEVICES = 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name in ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    device_mesh: object = None       # its torch DeviceMesh, one per process

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh devices of shape {self.devices.shape} do not match "
                f"axis names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(shape, axis_names, devices) -> Mesh:
    """A :class:`Mesh` of the first ``prod(shape)`` of ``devices``."""
    shape = tuple(int(s) for s in shape)
    need = math.prod(shape)
    if len(devices) < need:
        raise ValueError(
            f"a mesh of shape {shape} over {tuple(axis_names)} needs "
            f"{need} devices, {len(devices)} visible")
    arr = np.empty(need, dtype=object)
    arr[:] = list(devices)[:need]
    return Mesh(arr.reshape(shape), tuple(axis_names))


def host_device_count() -> int:
    """How many devices the CPU shows the port (default 1)."""
    return _HOST_DEVICES


def set_host_device_count(n: int) -> int:
    """Show the port ``n`` CPU devices; returns the previous count. It
    changes nothing on the card."""
    global _HOST_DEVICES
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise ValueError(f"host device count must be a positive int, "
                         f"got {n!r}")
    prev, _HOST_DEVICES = _HOST_DEVICES, n
    return prev


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh may span for an entry point on ``device`` (None
    = the card): every CUDA device, starting from ``device``'s own and
    wrapping round (so a mesh's first device, where a split run gathers
    its results, is the caller's), or :func:`host_device_count` copies of
    the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        k = torch.cuda.device_count()
        first = torch.cuda.current_device() if dev.index is None \
            else dev.index
        return [torch.device("cuda", (first + i) % k) for i in range(k)]
    return [torch.device(dev.type)] * host_device_count()


def configure(mesh: Mesh) -> None:
    """Bind logical axes to this mesh ('pod', 'data', 'model'), and the
    ``DeviceMesh`` it carries, if any."""
    global _CTX
    batch = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    _CTX = {
        "mesh": mesh,
        "device_mesh": mesh.device_mesh,
        "batch_axes": batch,
        "rules": {
            "batch": batch,
            "data": "data",
            "tp": "model",
            "kv_tp": None,       # kv heads replicated over TP by default
            "expert": "model",
            "cap": "data",       # MoE capacity axis
            "seq_kv": "data",    # long-context: KV sequence over data
        },
    }


def reset() -> None:
    global _CTX
    _CTX = None


def current_mesh() -> Mesh | None:
    """The configured :class:`Mesh`, or None."""
    return None if _CTX is None else _CTX["mesh"]


def device_mesh():
    """The configured mesh's ``DeviceMesh``, or None (no mesh, or a mesh
    with no process group behind it)."""
    return None if _CTX is None else _CTX["device_mesh"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. Imports nothing: before
    ``torch.distributed.tensor`` is imported no DTensor can exist, and
    the unsharded paths never import it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def grid_mesh(devices: int | None = None, device=None) -> Mesh:
    """1-D scheduler mesh over the "data" axis for the portfolio grid.

    The scheduler's combined (instances x profiles x variants) launch
    splits its instance rows over "data"
    (:func:`repro_torch.sharding.specs.grid_batch_spec`). ``devices=None``
    takes every device visible to ``device`` (None = the card); otherwise
    the first ``devices`` of :func:`visible_devices`.
    """
    avail = visible_devices(device)
    n = len(avail) if devices is None else devices
    if not 1 <= n <= len(avail):
        raise ValueError(
            f"devices={devices} out of range: {len(avail)} visible")
    return make_mesh((n,), ("data",), avail)


def axis_size(logical: str) -> int:
    if _CTX is None:
        return 1
    rule = _CTX["rules"].get(logical)
    if rule is None:
        return 1
    mesh = _CTX["mesh"]
    if isinstance(rule, tuple):
        return math.prod(mesh.shape[a] for a in rule)
    return mesh.shape[rule]


def logical_spec(ndim: int, *axes):
    """The mesh-axis :class:`~repro_torch.sharding.specs.PartitionSpec`
    that logical ``axes`` (one a leading dimension of a tensor of ``ndim``
    dimensions; None = whole) resolve to under the configured rules.
    Raises ``ValueError`` for an unknown axis, one whose rule names an axis
    the mesh lacks, or more axes than dimensions."""
    from repro_torch.sharding.specs import P
    rules, mesh = _CTX["rules"], _CTX["mesh"]
    if len(axes) > ndim:
        raise ValueError(f"{len(axes)} logical axes for a tensor of "
                         f"{ndim} dimensions")
    parts = []
    for a in axes:
        if a is None:
            parts.append(None)
            continue
        if a not in rules:
            raise ValueError(f"unknown logical axis {a!r}")
        rule = rules[a]
        names = rule if isinstance(rule, tuple) else (rule,)
        missing = [n for n in names if n is not None
                   and n not in mesh.axis_names]
        if missing:
            raise ValueError(f"logical axis {a!r} maps to {missing}, not "
                             f"axes of the mesh {mesh.axis_names}")
        parts.append(rule)
    return P(*parts)


def logical_placements(ndim: int, *axes):
    """DTensor placements on the bound ``DeviceMesh`` of logical ``axes``
    (:func:`logical_spec`)."""
    from repro_torch.sharding.specs import placements
    return placements(logical_spec(ndim, *axes), device_mesh())


def distribute(x, *axes):
    """A full plain tensor ``x``, the same on every rank, as a DTensor on
    the bound ``DeviceMesh`` placed by logical ``axes``: this rank's shard
    of it, and no data moves."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, device_mesh(),
                             logical_placements(x.ndim, *axes),
                             src_data_rank=None)


def gather_batch(tree):
    """A layer's parameters (a dict of tensors, nested or not) made whole
    over the batch axes where they are DTensors split there (FSDP over
    "data"), their "model" split kept: FSDP's all-gather at use, whose
    backward reduce-scatters the gradients back onto the shards. Done
    per layer inside the remat block, as XLA gathers a layer's weights in
    the reference's scan. No mesh, or plain tensors: the tree itself."""
    if _CTX is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_batch(v) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate, Shard
    names = tree.device_mesh.mesh_dim_names
    batch = _CTX["batch_axes"]
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] in batch
                 else p for i, p in enumerate(tree.placements))
    return tree if want == tuple(tree.placements) \
        else tree.redistribute(tree.device_mesh, want)


def partial_over(placements, *axes) -> tuple:
    """``placements`` on the bound ``DeviceMesh`` with every mesh dimension
    of logical ``axes`` made ``Partial()``: the gradient placements of an
    input that a block reads whole over those dimensions and each rank
    differentiates by its own part of the work."""
    from torch.distributed.tensor import Partial
    names = device_mesh().mesh_dim_names
    dims = set()
    for a in axes:
        rule = _CTX["rules"][a]
        dims.update(names.index(n) for n in (
            rule if isinstance(rule, tuple) else (rule,)) if n is not None)
    return tuple(Partial() if i in dims else pl
                 for i, pl in enumerate(placements))


def local_map(fn, out_placements, in_placements, in_grad_placements=None):
    """``fn`` of plain tensors applied to DTensors on each rank's local
    shards (``torch.distributed.tensor.experimental.local_map`` on the
    bound ``DeviceMesh``): the inputs redistributed to
    ``in_placements`` first, the outputs placed by ``out_placements``, and
    each input's gradient read as ``in_grad_placements`` (default: its
    input placements)."""
    from torch.distributed.tensor.experimental import local_map as lm
    return lm(fn, out_placements=out_placements, in_placements=in_placements,
              in_grad_placements=in_grad_placements,
              device_mesh=device_mesh(), redistribute_inputs=True)


def batch_shards() -> int:
    """Devices over the mesh's batch axes (("pod", "data") or ("data",)),
    whatever the "batch" rule maps to; 1 with no mesh."""
    if _CTX is None:
        return 1
    return math.prod(_CTX["mesh"].shape[a] for a in _CTX["batch_axes"])


@contextlib.contextmanager
def decode_rules(batch: int):
    """The logical axes of a decode step of ``batch`` rows, as
    ``cache_specs`` places its cache, bound on top of :func:`configure`'s
    (the reference's) while the step runs: with at least as many rows as
    :func:`batch_shards`, the rows over the batch axes and the cache's
    sequence ("cache_seq") whole; with fewer (long-context, B=1), the rows
    whole on every device ("batch" replicated, as the reference's
    ``lower_decode`` places the tokens by ``P()``) and "cache_seq" over
    "data": each device holds a part of every row's positions, and the
    attention over them is combined across "data" (flash-decoding). The
    rules are restored on exit; no mesh, nothing to bind."""
    if _CTX is None:
        yield
        return
    rules = _CTX["rules"]
    saved = dict(rules)
    rules["cache_seq"] = None
    if batch < batch_shards():
        rules.update({"batch": None, "cache_seq": "data"})
    try:
        yield
    finally:
        rules.clear()
        rules.update(saved)


def shard(x, *axes):
    """Pin ``x`` to logical ``axes``, the counterpart of
    ``with_sharding_constraint``. No mesh configured: the identity. With a
    mesh, the axes are checked first (:func:`logical_spec`); then a DTensor
    is redistributed to the placements they resolve to (a mesh axis that
    no dimension names is replicated), and a plain tensor passes
    unchanged."""
    if _CTX is None:
        return x
    spec = logical_spec(x.ndim, *axes)
    if not is_dtensor(x):
        return x
    from repro_torch.sharding.specs import placements
    want = placements(spec, x.device_mesh)
    return x if tuple(x.placements) == want \
        else x.redistribute(x.device_mesh, want)


def tp_size() -> int:
    return axis_size("tp")


def head_plan(num_heads: int, kv_heads: int, tp: int = 16):
    """Baseline TP plan for attention heads.

    Returns (Hq_pad, Hkv_pad, shard_heads). Pads q heads to a multiple of
    ``tp`` and kv heads to a divisor of the padded q count, so the grouped
    (repeat-kv) einsum shards cleanly on the head axis. Tiny models
    (Hq < tp/2) replicate heads instead (their FFN still shards).
    """
    if num_heads < tp // 2:
        return num_heads, kv_heads, False
    hq = -(-num_heads // tp) * tp
    hkv = kv_heads
    while hq % hkv != 0:
        hkv += 1
    return hq, hkv, True
