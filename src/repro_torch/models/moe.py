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

Under a mesh (DTensor activations and parameters,
:mod:`repro_torch.sharding.place`) the three dispatches are the
reference's multi-device forms, each a chain of ``local_map`` blocks with
stated input, output and gradient placements, so the routing, sort,
scatter and combine run on plain local tensors:

* ``global``: every rank routes all ``nt`` tokens (the tokens gathered
  over the batch axes) with the global capacity; the ``[E, cap, d]``
  buffer is pinned to ("expert", "cap"), so each rank runs its experts'
  slots of its capacity rows, and the outputs are gathered back for the
  combine;
* ``sharded``: the routing, sort and scatter stay local to each of
  ``axis_size("batch")`` data shards (halved until it divides ``nt``), with
  the per-shard capacity ``cap_l``; the ``[ds, E, cap_l, d]`` buffer is
  repinned ("batch", None) -> ("batch", "expert") for the experts and back
  for the combine;
* ``shardmap``: one block over (batch rows, E/tp experts of "model"): a
  rank routes its rows, builds the whole buffer, runs its own experts and
  all-gathers their outputs over "model" (the functional collective,
  whose backward is the reduce-scatter; the output's cotangent is divided
  by the model axis's size first, as ``shard_map``'s transpose does for an
  output replicated over it).

The reference's ``sharded`` and ``shardmap`` split the flattened tokens
evenly over the devices, whatever the rows: on a microbatch whose rows do
not split evenly over the batch axes, both take the tokens as one row of
``B S / nb`` a rank first (:func:`_token_rows`).

With no mesh, ``moe_ffn_sharded`` has one data shard and
``moe_ffn_shardmap`` runs its local body with ``tp = 1``: both are the
global form's ops on the same shapes, so the same bits. Jamba's MoE layers
take the same code.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import shard


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


def _dispatch(xt, r, E: int, cap: int):
    """The kept pairs scattered into a contiguous [E, cap, d] buffer. A
    dropped pair writes to one spare row past the buffer, which the
    experts never read (no host sync on a data-dependent count of kept
    pairs)."""
    flat = xt.new_zeros((E * cap + 1, xt.shape[1]))
    flat[torch.where(r["keep"], r["se"] * cap + r["slot"], E * cap)] = \
        xt[r["st"]]
    return flat[:E * cap].view(E, cap, xt.shape[1])


def _experts(buf, w1, w3, w2):
    """The experts' SwiGLU over their slots: buf [E, cap, d] -> [E, cap,
    d]."""
    return torch.bmm(F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3), w2)


def _combine(y_buf, se, st, slot, sg, k: int):
    """Each pair's expert output gathered back and weighted; each token's
    k pairs summed in the order the sorted pairs meet them (ascending
    expert): a stable sort of the pairs by token."""
    d = y_buf.shape[-1]
    y_pairs = y_buf[se, slot] * sg[:, None].to(y_buf.dtype)
    y_tok = y_pairs[torch.argsort(st, stable=True)].view(-1, k, d)
    out = y_tok[:, 0]
    for j in range(1, k):
        out = out + y_tok[:, j]
    return out


def _dispatch_combine(xt, r, w1, w3, w2, moe_cfg, cap):
    """Scatter the kept pairs into [E, cap, d], run the experts, gather the
    pairs back and sum each token's k outputs in ascending expert order."""
    buf = _dispatch(xt, r, moe_cfg.num_experts, cap)
    y_buf = _experts(buf, w1, w3, w2)
    return _combine(y_buf, r["se"], r["st"], r["slot"], r["sg"],
                    moe_cfg.top_k)


def route_shards(xs, gate, moe_cfg, cap: int) -> dict:
    """:func:`route` of each shard of xs [ds, ntl, d] on its own (the
    reference's per-shard routing of ``moe_ffn_sharded``): the same keys,
    each stacked to [ds, ntl k]."""
    rs = [route(x, gate, moe_cfg, cap) for x in xs.unbind(0)]
    return {key: torch.stack([r[key] for r in rs]) for key in rs[0]}


def _weights(p, dt):
    return p["w1"].to(dt), p["w3"].to(dt), p["w2"].to(dt)


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
    cap = capacity(moe_cfg, B * S)
    if ctx.is_dtensor(x):
        return _global_mesh(p, x, moe_cfg, cap)
    xt = x.reshape(B * S, d)
    r = route(xt, p["gate"], moe_cfg, cap)
    out = _dispatch_combine(xt, r, *_weights(p, x.dtype), moe_cfg, cap)
    return out.reshape(B, S, d)


def moe_ffn_sharded(p, x, moe_cfg):
    """Hierarchical dispatch: the routing, sort and scatter stay local to
    each of ``ds`` data shards (``axis_size("batch")``, halved until it
    divides the token count), each with its own capacity ``cap_l``; with no
    mesh, one shard, the global form's ops."""
    B, S, d = x.shape
    nt = B * S
    ds = ctx.axis_size("batch")
    while nt % ds:
        ds //= 2
    cap_l = capacity(moe_cfg, nt // ds)
    if ctx.is_dtensor(x):
        return _token_rows(
            lambda xt: _sharded_mesh(p, xt, moe_cfg, ds, cap_l), x)
    ws = _weights(p, x.dtype)
    outs = []
    for xt in x.reshape(ds, nt // ds, d).unbind(0):
        r = route(xt, p["gate"], moe_cfg, cap_l)
        outs.append(_dispatch_combine(xt, r, *ws, moe_cfg, cap_l))
    return torch.cat(outs).reshape(B, S, d)


def moe_ffn_shardmap(p, x, moe_cfg):
    """The shard-map dispatch: each rank routes its own rows (every expert
    replicated over the model axis's ranks), runs its E/tp experts and
    all-gathers their outputs over "model". With no mesh, the reference's
    ``_moe_shardmap_local`` (``tp = 1``): every expert is local."""
    if ctx.is_dtensor(x):
        return _token_rows(lambda xt: _shardmap_mesh(p, xt, moe_cfg), x)
    return moe_ffn_global(p, x, moe_cfg)


# ---------------------------------------------------------------------------
# the multi-device forms (DTensors on the configured mesh)
# ---------------------------------------------------------------------------

# the routing keys the combine reads
ROUTE_KEYS = ("se", "st", "slot", "sg")


def _global_mesh(p, x, moe_cfg, cap):
    """``moe_ffn_global`` on DTensors: all tokens routed on every rank, the
    buffer pinned to ("expert", "cap"), the experts on each rank's slots,
    the combine on the gathered outputs."""
    B, S, d = x.shape
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    rep = ctx.logical_placements(2)
    w1, w3, w2 = _weights(p, x.dtype)

    def dispatch(x, gate):
        xt = x.reshape(B * S, d)
        r = route(xt, gate, moe_cfg, cap)
        return (_dispatch(xt, r, E, cap),) + tuple(r[n] for n in
                                                   ROUTE_KEYS)

    whole, pairs = ctx.logical_placements(3), ctx.logical_placements(1)
    buf, se, st, slot, sg = ctx.local_map(
        dispatch, (whole,) + (pairs,) * 4, (whole, rep))(x, p["gate"])
    buf = shard(buf, "expert", "cap", None)
    y_buf = _expert_block(buf, (w1, w3, w2), ("expert", "cap", None))
    y_buf = shard(y_buf, "expert", "cap", None)
    out = ctx.local_map(
        lambda y, *r: _combine(y, *r, k).reshape(B, S, d),
        (whole,), (whole,) + (pairs,) * 4)(y_buf, se, st, slot, sg)
    return shard(out, "batch", None, None)


def _expert_block(buf, ws, axes):
    """The experts on each rank's shard of ``buf`` (placed by logical
    ``axes``, its expert axis over "model", its rows split over some of
    the batch axes): the weights split over their experts and whole
    elsewhere, so their gradients are this rank's part of a sum over the
    mesh dimensions that split the buffer's rows, and whole over those
    that hold it whole (``global``'s "pod": its capacity rows split over
    "data" alone)."""
    from torch.distributed.tensor import Partial, Shard
    wp = ctx.logical_placements(3, "expert")
    bp = ctx.logical_placements(buf.ndim, *axes)
    wg = tuple(Partial() if isinstance(b, Shard) and not isinstance(w, Shard)
               else w for b, w in zip(bp, wp))

    def experts(b, w1, w3, w2):
        if b.ndim == 3:
            return _experts(b, w1, w3, w2)
        return torch.stack([_experts(x, w1, w3, w2) for x in b.unbind(0)])

    return ctx.local_map(experts, (bp,), (bp, wp, wp, wp),
                         (bp, wg, wg, wg))(buf, *ws)


def _sharded_mesh(p, x, moe_cfg, ds, cap_l):
    """``moe_ffn_sharded`` on DTensors: each rank routes, sorts and
    scatters its own data shards' tokens (this rank's ``ds / size`` of the
    ``ds`` shards) into a data-local [ds, E, cap_l, d] buffer, which is
    repinned ("batch", "expert") for the experts and ("batch", None) for
    the combine."""
    B, S, d = x.shape
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    nb = ctx.axis_size("batch")
    if ds % nb:
        raise ValueError(f"{ds} MoE data shards do not split over the "
                         f"{nb} ranks of the batch axes")
    ntl = B * S // ds
    w1, w3, w2 = _weights(p, x.dtype)
    rows = ctx.logical_placements(3, "batch")
    pairs = ctx.logical_placements(2, "batch")

    def dispatch(x, gate):
        xs = x.reshape(-1, ntl, d)
        r = route_shards(xs, gate, moe_cfg, cap_l)
        buf = torch.stack([_dispatch(xt, {n: v[i] for n, v in r.items()},
                                     E, cap_l)
                           for i, xt in enumerate(xs.unbind(0))])
        return (buf,) + tuple(r[n] for n in ROUTE_KEYS)

    rep, bufs = ctx.logical_placements(2), ctx.logical_placements(4, "batch")
    buf, se, st, slot, sg = ctx.local_map(
        dispatch, (bufs,) + (pairs,) * 4, (rows, rep),
        (rows, ctx.partial_over(rep, "batch")))(x, p["gate"])
    buf = shard(buf, "batch", None, None, None)
    buf = shard(buf, "batch", "expert", None, None)
    y_buf = _expert_block(buf, (w1, w3, w2),
                          ("batch", "expert", None, None))
    y_buf = shard(y_buf, "batch", "expert", None, None)
    y_buf = shard(y_buf, "batch", None, None, None)

    def combine(y, se, st, slot, sg):
        out = torch.stack([_combine(*a, k) for a in
                           zip(y.unbind(0), se.unbind(0), st.unbind(0),
                               slot.unbind(0), sg.unbind(0))])
        return out.reshape(-1, S, d)

    out = ctx.local_map(combine, (rows,), (bufs,) + (pairs,) * 4)(
        y_buf, se, st, slot, sg)
    return shard(out, "batch", None, None)


def _token_rows(fn, x):
    """``fn`` of x [B,S,d], whose rows split over the batch axes. Where
    they split unevenly (fewer rows than the axes' ``nb`` ranks, or a
    count that does not divide), ``fn`` takes the same tokens as ``nb``
    rows of ``B S / nb``, one a rank, and its output goes back to x's rows:
    the reference's ``shard_map`` and its ``[ds, ntl, d]`` pin split the
    flattened tokens evenly over the devices, not the padded rows, and a
    shard's routing and capacity follow its tokens. The tokens move by a
    gather over the batch axes and a slice (the output, and the
    gradients, likewise)."""
    if not ctx.uneven(x):
        return fn(x)
    B, S, d = x.shape
    nb = ctx.batch_shards()
    if (B * S) % nb:
        raise ValueError(f"{B * S} tokens do not split over the {nb} ranks "
                         f"of the batch axes")
    whole = (None, None, None)
    xt = shard(shard(x, *whole).reshape(nb, B * S // nb, d),
               "batch", None, None)
    return shard(shard(fn(xt), *whole).reshape(B, S, d), "batch", None, None)


def _all_gather(x, group):
    """x gathered over ``group`` along dimension 0: the functional
    collective, whose backward is the reduce-scatter (its name since torch
    2.13; ``all_gather_tensor_autograd`` before)."""
    import torch.distributed._functional_collectives as fc
    fn = getattr(fc, "all_gather_single_autograd", None) \
        or fc.all_gather_tensor_autograd
    return fn(x, gather_dim=0, group=group)


class _ScaleGrad(torch.autograd.Function):
    """The identity whose backward multiplies the cotangent by ``s``."""

    @staticmethod
    def forward(ctx_, x, s):
        ctx_.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        return g * ctx_.s, None


def _shardmap_mesh(p, x, moe_cfg):
    """``moe_ffn_shardmap`` on DTensors, the reference's ``shard_map``
    over (batch rows, "model" experts) as one ``local_map``: a rank's rows
    routed with the capacity of its own token count, the whole buffer
    built, its E/tp experts run and their outputs all-gathered over
    "model". Inputs replicated over an axis the block does not split
    (the rows over "model", the router everywhere) get their gradient as
    that axis's sum, as ``shard_map``'s transpose gives them."""
    B, S, d = x.shape
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    tp = ctx.tp_size()
    dm = ctx.device_mesh()
    if (B * S) % ctx.batch_shards():
        # the reference's ``assert nt % ds == 0``: its shard_map splits the
        # tokens over the mesh's batch axes, whatever the step's rows
        raise ValueError(f"{B * S} tokens do not split over the "
                         f"{ctx.batch_shards()} ranks of the batch axes "
                         f"(the shard-map dispatch)")
    if E % tp:
        raise ValueError(f"{E} experts do not split over the {tp} ranks of "
                         f"the model axis")
    w1, w3, w2 = _weights(p, x.dtype)
    rows = ctx.logical_placements(3, "batch")
    rep = ctx.logical_placements(2)
    wp = ctx.logical_placements(3, "expert")

    def body(x, gate, w1, w3, w2):
        xt = x.reshape(-1, d)
        cap_l = capacity(moe_cfg, xt.shape[0])
        r = route(xt, gate, moe_cfg, cap_l)
        buf = _dispatch(xt, r, E, cap_l)
        if tp > 1:
            e_loc = E // tp
            m = dm.get_local_rank("model")
            buf = buf[m * e_loc:(m + 1) * e_loc]
        y = _experts(buf, w1, w3, w2)
        if tp > 1:
            y = _all_gather(y, dm.get_group("model"))
        out = _combine(y, r["se"], r["st"], r["slot"], r["sg"], k)
        if tp > 1:
            out = _ScaleGrad.apply(out, 1.0 / tp)
        return out.reshape(-1, S, d)

    grads = (ctx.partial_over(rows, "tp"),
             ctx.partial_over(rep, "batch", "tp"),
             *(ctx.partial_over(wp, "batch"),) * 3)
    return ctx.local_map(body, (rows,), (rows, rep, wp, wp, wp), grads)(
        x, p["gate"].float(), w1, w3, w2)
