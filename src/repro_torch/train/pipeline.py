"""Pipeline parallelism over a process group: the GPipe schedule.

The port of ``repro.train.pipeline`` over ``torch.distributed``. The layer
stack is split into ``n_stages`` contiguous stages, one per rank of the
group (one per pod); microbatches stream through with point-to-point
boundary transfers (the reference's ``lax.ppermute``), and the last
stage's outputs reach every rank through one ``all_reduce`` (its
``psum``). The default plan keeps the pod axis as pure data parallelism;
this module provides the alternative.

Bubble fraction = (S-1)/(M+S-1) for S stages and M microbatches, so the
caller should pick M >> S (the helper asserts M >= 4*S).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def pipeline_apply(body_fn, stage_params, x_mb: torch.Tensor, *,
                   group=None) -> torch.Tensor:
    """Run a GPipe pipeline on this rank of ``group`` (None = the default
    process group); every rank of the group calls it.

    body_fn(params, x) -> x            one stage's computation
    stage_params: this rank's stage parameters
    x_mb: [M, mb, ...] microbatched activations (the same on every rank)

    Returns [M, mb, ...] outputs of the LAST stage, on every rank.
    """
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    M = x_mb.shape[0]
    assert M >= 4 * n_stages, "use >=4x microbatches per stage (bubble)"
    n_ticks = M + n_stages - 1

    buf_in = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for t in range(n_ticks):
        # stage 0 injects microbatch t (if any); others take the sent in
        x_in = x_mb[min(t, M - 1)] if stage == 0 else buf_in
        y = body_fn(stage_params, x_in)
        # pass to the next stage, take from the previous one
        ops = []
        if stage < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                  _peer(group, stage + 1), group))
        if stage > 0:
            buf_in = torch.empty_like(x_mb[0])
            ops.append(dist.P2POp(dist.irecv, buf_in,
                                  _peer(group, stage - 1), group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        # last stage writes its completed microbatch (t - (S-1))
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outputs[out_idx] = y
    # broadcast the last stage's outputs to all ranks
    dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs


def _stage_slice(tree, stage: int):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, stage) for k, v in tree.items()}
    return tree[stage]


def make_pipelined_forward(body_fn, mesh, axis_name: str = "pod", *,
                           group=None):
    """The per-rank forward of a pipeline over ``mesh``'s ``axis_name``.

    The returned ``fwd(stage_params, x_mb)`` takes the parameters of every
    stage stacked on a leading stage axis (the reference's
    ``in_specs=P(axis_name)``) and the replicated microbatches, runs this
    rank's stage in :func:`pipeline_apply`, and returns the last stage's
    outputs. ``group``'s size (None = the default process group) must be
    the axis' size.
    """
    n = mesh.shape[axis_name]

    def fwd(stage_params, x_mb):
        world = dist.get_world_size(group)
        if world != n:
            raise ValueError(
                f"mesh axis {axis_name!r} has {n} stages, the process "
                f"group {world} ranks")
        params = _stage_slice(stage_params, dist.get_rank(group))
        return pipeline_apply(body_fn, params, x_mb, group=group)

    return fwd
