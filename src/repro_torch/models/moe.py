"""Mixture-of-Experts FFN: sort-based capacity dispatch (the counterpart of
``repro.models.moe``).

Top-k routing in f32, pairs sorted by expert, each pair ranked within its
expert; a pair past the expert's capacity is dropped (gate 0, slot 0). The
kept tokens are scattered into an ``[E, cap, d]`` buffer, the experts run as
three batched products over it, and each token's k outputs are gathered back
and summed.

The tie rules decide which tokens drop, so they are the reference's:

* top-k: ``jax.lax.top_k`` puts the lower expert index first among equal
  logits; ``torch.topk`` promises no order, so :func:`top_k` takes the
  first k of a stable descending sort;
* the expert sort: ``jnp.argsort`` is stable, and so is
  ``torch.argsort(stable=True)``;
* the capacity: ``max(int(cf * nt * k / E), 1)`` rounded up to a multiple
  of 8.

The combine ``out.at[st].add(y_pairs)`` of the reference is a scatter-add
of k pairs a token; on CUDA ``index_add_`` on floats is not deterministic.
The port sorts the pairs back by token instead (a stable sort, so each
token's k weighted outputs keep ascending expert order, the order in which
the reference's sequential scatter meets them), views them as
``[nt, k, d]`` and adds them up in that order: the same bits on every
run. The dispatch writes each kept pair into its own (expert, slot), which
no other pair shares, so it is an exact assignment.

With no device mesh the reference's ``moe_ffn_sharded`` has one data shard
and ``moe_ffn_shardmap`` runs its local body with ``tp = 1``; those are the
forms ported here. Their multi-device forms belong to the multi-device
slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_shapes(d, moe_cfg, layers) -> dict:
    """The MoE parameter tree: name -> (shape, init). ``init`` is the
    standard deviation of a normal draw (the reference's scales)."""
    e, ff = moe_cfg.num_experts, moe_cfg.d_ff_expert
    return {
        "gate": ((layers, d, e), d ** -0.5),
        "w1": ((layers, e, d, ff), d ** -0.5),
        "w3": ((layers, e, d, ff), d ** -0.5),
        "w2": ((layers, e, ff, d), ff ** -0.5),
    }


def capacity(moe_cfg, nt: int) -> int:
    """Slots per expert for ``nt`` tokens, rounded up to a multiple of 8."""
    cap = max(int(moe_cfg.capacity_factor * nt * moe_cfg.top_k
                  / moe_cfg.num_experts), 1)
    return -(-cap // 8) * 8


def top_k(logits, k: int):
    """(values, indices) of the k largest logits of each row, descending,
    the lower index first among equals (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, gate, moe_cfg, cap: int) -> dict:
    """Routing of tokens xt [nt, d]: the f32 router, top-k and its softmax
    gates, the stable expert sort and each pair's rank. Returns the sorted
    pairs' expert ``se``, token ``st``, gate ``sg`` (0 where dropped),
    ``keep`` mask and ``slot`` (0 where dropped)."""
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    nt = xt.shape[0]
    logits = torch.matmul(xt.float(), gate.float())              # [nt, E]
    topv, topi = top_k(logits, k)
    gates = torch.softmax(topv, dim=-1)
    e_flat = topi.reshape(-1)
    t_flat = torch.arange(nt, device=xt.device).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    se, st, sg = e_flat[order], t_flat[order], gates.reshape(-1)[order]
    counts = torch.bincount(se, minlength=E)
    seg_off = torch.cumsum(counts, 0) - counts
    rank = torch.arange(nt * k, device=xt.device) - seg_off[se]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.zeros_like(rank))
    sg = torch.where(keep, sg, torch.zeros_like(sg))
    return {"se": se, "st": st, "sg": sg, "keep": keep, "slot": slot}


def _dispatch_combine(xt, r, w1, w3, w2, moe_cfg, cap):
    """Scatter the kept pairs into [E, cap, d], run the experts, gather the
    pairs back and sum each token's k outputs in ascending expert order."""
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    nt, d = xt.shape
    se, st, slot = r["se"], r["st"], r["slot"]
    # a dropped pair writes to slot ``cap``, a row the experts never read
    # (no host sync on a data-dependent count of kept pairs)
    buf = xt.new_zeros((E, cap + 1, d))
    buf[se, torch.where(r["keep"], slot, cap)] = xt[st]
    buf = buf[:, :cap]
    y_buf = torch.bmm(F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3), w2)
    y_pairs = y_buf[se, slot] * r["sg"][:, None].to(xt.dtype)
    # each token's k pairs in the order the sorted pairs meet them
    # (ascending expert): a stable sort of the pairs by token
    y_tok = y_pairs[torch.argsort(st, stable=True)].view(nt, k, d)
    out = y_tok[:, 0]
    for j in range(1, k):
        out = out + y_tok[:, j]
    return out


def moe_ffn(p, x, moe_cfg):
    """The reference's switch on ``moe_cfg.dispatch``."""
    d = getattr(moe_cfg, "dispatch", "global")
    if d == "sharded":
        return moe_ffn_sharded(p, x, moe_cfg)
    if d == "shardmap":
        return moe_ffn_shardmap(p, x, moe_cfg)
    return moe_ffn_global(p, x, moe_cfg)


def moe_ffn_global(p, x, moe_cfg):
    """x [B,S,d] -> [B,S,d]. Top-k routing with capacity dropping."""
    B, S, d = x.shape
    dt = x.dtype
    xt = x.reshape(B * S, d)
    cap = capacity(moe_cfg, B * S)
    r = route(xt, p["gate"], moe_cfg, cap)
    out = _dispatch_combine(xt, r, p["w1"].to(dt), p["w3"].to(dt),
                            p["w2"].to(dt), moe_cfg, cap)
    return out.reshape(B, S, d)


def moe_ffn_sharded(p, x, moe_cfg):
    """The hierarchical dispatch on one device: one data shard, whose
    capacity is the global one; the same routing, buffer and combine as
    :func:`moe_ffn_global`."""
    return moe_ffn_global(p, x, moe_cfg)


def moe_ffn_shardmap(p, x, moe_cfg):
    """The shard-map dispatch on one device (the reference's
    ``_moe_shardmap_local``, ``tp = 1``): every expert is local."""
    return moe_ffn_global(p, x, moe_cfg)
