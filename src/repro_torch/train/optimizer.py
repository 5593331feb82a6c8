"""AdamW with global-norm clipping and a warmup+cosine schedule (the port
of ``repro.train.optimizer``).

States are nested dicts of tensors, as the reference's pytrees: ``m`` and
``v`` in f32, ``step`` an int32 scalar tensor, and under mixed precision an
f32 ``master`` copy of the parameters while the live ones are bf16. The
arithmetic is the reference's, in f32 with its constants; every update
makes new tensors and leaves its inputs as they were, as the reference's
functions do. ``compress_grads`` rounds gradients through bf16 (the
reference's hook for a bf16 data-parallel all-reduce; on one card it only
rounds).

The leaves may be DTensors (a state placed on a mesh): the global norm
sums each leaf's local squares, adds the leaves in the same sorted order
and ends replicated; the clip, the moments and the update are elementwise
on the local shards, and ``inplace`` writes into them.
"""
from __future__ import annotations

import math

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in sorted key order, as
    ``jax.tree.leaves`` orders them. Sums over leaves (:func:`global_norm`)
    then add in one order whatever order the dicts were built in: a state
    read back from a checkpoint has its keys sorted, a live one the
    model's order, and one f32 rounding of the norm moves every
    parameter through the clip."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """Nested dicts of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def lr_schedule(step, *, peak: float = 3e-4, warmup: int = 200,
                total: int = 10_000, floor: float = 0.1):
    """Linear warmup to ``peak``, then cosine decay to ``floor * peak`` at
    ``total``; f32, as a tensor (on ``step``'s device when it is one)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def _replicated(x):
    """A DTensor reduced to replicated (a partial sum all-reduced); any
    other tensor as it is."""
    from repro_torch.sharding.ctx import is_dtensor
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32 (leaves in sorted
    key order; each DTensor leaf's sum replicated before it is added)."""
    return torch.sqrt(sum(_replicated(torch.sum(torch.square(x.float())))
                          for x in tree_leaves(tree)))


def adamw_init(params, mixed_precision: bool = False) -> dict:
    """Zero moments, step 0, and with ``mixed_precision`` an f32 copy of
    ``params`` as the master."""
    leaf = tree_leaves(params)[0]
    opt = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }
    if mixed_precision:
        opt["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return opt


def cast_params(params, dtype=torch.bfloat16):
    return tree_map(lambda p: p.to(dtype), params)


def adamw_update(params, grads, opt, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1,
                 clip: float = 1.0, inplace: bool = False):
    """One AdamW step: returns (new params, new opt state, the gradients'
    global norm before clipping). With a ``master`` in ``opt`` the update
    runs on the f32 master and the live parameters are its cast.

    ``inplace``: the new parameters and moments are written into the
    tensors of ``params`` and ``opt``, leaf by leaf (the same bits), and
    those dicts come back: the caller gives the old state up, as a jax
    step's donated buffers, and the card holds one state, not two."""
    if "master" in opt:                 # mixed precision: update the master
        new_master, opt2, gnorm = adamw_update(
            opt["master"], grads,
            {"m": opt["m"], "v": opt["v"], "step": opt["step"]}, lr,
            b1=b1, b2=b2, eps=eps, wd=wd, clip=clip, inplace=inplace)
        if inplace:
            tree_map(lambda p, q: p.copy_(q), params, new_master)
            new_params = params
        else:
            live_dtype = tree_leaves(params)[0].dtype
            new_params = tree_map(lambda p: p.to(live_dtype), new_master)
        opt2["master"] = new_master
        return new_params, opt2, gnorm
    gnorm = global_norm(grads)
    scale = torch.clamp(clip / (gnorm + 1e-12), max=1.0)
    step = opt["step"] + 1
    t = step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        mh = m_new / (1 - b1 ** t)
        vh = v_new / (1 - b2 ** t)
        new_p = (p.float() - lr * (
            mh / (torch.sqrt(vh) + eps) + wd * p.float())).to(p.dtype)
        if not inplace:
            return new_p, m_new, v_new
        p.copy_(new_p)
        m.copy_(m_new)
        v.copy_(v_new)
        return None

    out = tree_map(upd, params, grads, opt["m"], opt["v"])
    if inplace:
        return params, {"m": opt["m"], "v": opt["v"], "step": step}, gnorm
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm


def compress_grads(grads, enabled: bool = True):
    """Gradients rounded through bf16 (halves a data-parallel all-reduce's
    bytes in the reference)."""
    if not enabled:
        return grads
    return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
