"""Shared model layers: RMSNorm, RoPE / M-RoPE, GQA attention, SwiGLU MLP
(the counterparts of ``repro.models.layers``).

Functions over explicit parameter dicts of one layer, in the reference's
layouts (``wq`` [d, H, hd], ``wo`` [H, hd, d], ...). Master parameters stay
f32 and are cast to the activation dtype at use, as in the reference. On
the card the self-attention is
:func:`repro_torch.kernels.flash_attention.flash_attention`'s CUDA kernel,
which computes the same exact softmax attention as the reference's
query-chunked jnp form, causal or not. Elsewhere (CPU tensors) it is
:func:`attention_plain_model`, the reference model's own arithmetic: scores
rounded to the activation dtype before the f32 softmax, the weights P
rounded to v's dtype before PV (the Pallas kernel's twin,
``flash_attention.attention_plain``, keeps both in f32). Attention whose
query and key lengths differ (Whisper's cross-attention) and the decode
step's one-query attention over the cache stay plain torch
(:func:`gqa_scores_out`; :func:`cross_attention`), as they are jnp in the
reference. Positions:
standard RoPE (``rope == "std"``), Qwen2-VL's M-RoPE (``"mrope"``,
[3, B, S] positions) or none (``"abs"``: Whisper adds learned positions to
its inputs).

Under a mesh (:func:`repro_torch.sharding.ctx.configure` with a
``DeviceMesh``) the parameters and activations are DTensors and the
reference's annotations place them (:func:`~repro_torch.sharding.ctx.shard`:
q and the attention output on ("batch", -, "tp", -), the SwiGLU hidden on
("batch", -, "tp")); the projections are DTensor matmuls, and the rotary
positions and the attention itself run on each rank's local shards
(``local_map``): batch rows over the batch axes, heads over "model". So the
flash kernels run under TP on the card as they do on one device; so does
the cross-attention. The decode step's attention reads a cache placed by
``cache_specs`` where it lies (:func:`_decode_attend`): rows over the batch
axes, or, with fewer rows than their size, the sequence over "data" and
the partial softmaxes combined across it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_mode
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import shard

NEG = -1e30
QCHUNK = 512     # query rows a block of the plain model attention (as there)


def dtype_of(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rmsnorm(x, w, eps=1e-6):
    """RMSNorm in f32, times the f32 weight, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _rope_freqs(head_dim, theta, device):
    """The rotary frequencies, computed in float64 numpy and used as f32 as
    the reference computes them; one copy per device (a host-to-device copy
    waits for the stream, so it is made once, not per call)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half) / half))
    return torch.as_tensor(freqs.astype(np.float32), device=device)


def _rope_cos_sin(pos, head_dim, theta):
    """pos [...]: returns cos/sin of shape [..., head_dim//2], f32."""
    ang = pos[..., None].float() * _rope_freqs(head_dim, theta, pos.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, pos, theta):
    """x [B,S,H,hd], pos [B,S] -> rotated x (rotate-half convention)."""
    hd = x.shape[-1]
    cos, sin = _rope_cos_sin(pos, hd, theta)      # [B,S,hd/2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, pos3, theta, sections):
    """Qwen2-VL M-RoPE: pos3 [3,B,S] (t/h/w); sections sum to head_dim//2.
    Frequency band i of the rotation takes its angle from position stream
    ``j`` where band i lies in section j."""
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    cs = [_rope_cos_sin(pos3[i], hd, theta) for i in range(3)]
    parts_cos, parts_sin = [], []
    off = 0
    for i, sec in enumerate(sections):
        parts_cos.append(cs[i][0][..., off:off + sec])
        parts_sin.append(cs[i][1][..., off:off + sec])
        off += sec
    cos = torch.cat(parts_cos, dim=-1)[:, :, None, :]
    sin = torch.cat(parts_sin, dim=-1)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(q, k, cfg, pos):
    """q and k rotated by ``cfg.rope``: ``"std"`` (pos [B,S]), ``"mrope"``
    (pos [3,B,S]); unrotated with ``pos`` None or any other rope (``"abs"``),
    as in the reference."""
    if pos is None:
        return q, k
    if cfg.rope == "mrope":
        return (apply_mrope(q, pos, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, pos, cfg.rope_theta, cfg.mrope_sections))
    if cfg.rope == "std":
        return apply_rope(q, pos, cfg.rope_theta), \
            apply_rope(k, pos, cfg.rope_theta)
    return q, k


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_shapes(cfg, layers, hq, hkv) -> dict:
    """Stacked attention parameters: name -> (shape, init), ``init`` a
    normal draw's standard deviation or ``("fill", v)``; head counts padded
    by the TP head plan, as in the reference's ``init_attn``."""
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": ((layers, d, hq, hd), d ** -0.5),
         "wk": ((layers, d, hkv, hd), d ** -0.5),
         "wv": ((layers, d, hkv, hd), d ** -0.5),
         "wo": ((layers, hq, hd, d), (hq * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=((layers, hq, hd), ("fill", 0.0)),
                 bk=((layers, hkv, hd), ("fill", 0.0)),
                 bv=((layers, hkv, hd), ("fill", 0.0)))
    return p


def mlp_shapes(d, ff, layers) -> dict:
    """Stacked SwiGLU parameters, as :func:`attn_shapes`."""
    return {"w1": ((layers, d, ff), d ** -0.5),
            "w3": ((layers, d, ff), d ** -0.5),
            "w2": ((layers, ff, d), ff ** -0.5)}


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul: x [B,S,d], w [d,H,hd]. On
    DTensors whose heads do not split over "model", each rank projects its
    own rows' whole heads (``local_map``: the weight whole, its gradient a
    part of a sum over the batch axes), so no product splits a head."""
    d, H, hd = w.shape
    if ctx.is_dtensor(x) and H % ctx.tp_size():
        rows = ctx.logical_placements(3, "batch")
        wp = ctx.logical_placements(3)
        return ctx.local_map(_proj, (ctx.logical_placements(4, "batch"),),
                             (rows, wp), (rows, ctx.partial_over(wp, "batch"))
                             )(x, w)
    return torch.matmul(x, w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


def _out_proj(o, wo):
    """einsum("bshk,hkd->bsd"): o [B,S,H,hd], wo [H,hd,d]."""
    H, hd, d = wo.shape
    return torch.matmul(o.reshape(*o.shape[:-2], H * hd),
                        wo.reshape(H * hd, d))


def _qkv(p, x, cfg):
    dt = x.dtype
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _expand_kv(k, v, hq):
    """kv heads expanded to ``hq`` by ``jnp.repeat(k, n, axis=2)``: each kv
    head repeated n times in place (not tiled)."""
    hkv = k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    return k, v


def gqa_scores_out(q, k, v, causal=False, kv_len_mask=None, q_offset=0):
    """Exact attention of q [B,Sq,Hq,hd] over k/v [B,Sk,Hkv,hd] by its
    definition (the reference's ``_gqa_scores_out``): scores in q's dtype,
    then f32, masked to -1e30 where a key lies after its query (``causal``;
    query i at position ``q_offset + i``) or outside ``kv_len_mask``
    [B,Sk], softmax, weights in v's dtype. The attention of differing
    lengths (cross-attention), of the decode step, and of the model on the
    CPU (:func:`attention_plain_model`)."""
    hd = q.shape[-1]
    k, v = _expand_kv(k, v, q.shape[2])
    s = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    s = s * (hd ** -0.5)
    neg = torch.full((), NEG, device=s.device)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=s.device)[:, None]
        kpos = torch.arange(k.shape[1], device=s.device)[None, :]
        s = torch.where(kpos <= qpos, s, neg)
    if kv_len_mask is not None:
        s = torch.where(kv_len_mask[:, None, None, :], s, neg)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def attention_plain_model(q, k, v, causal=True):
    """The reference model's attention (``attention_train`` there): its
    :func:`gqa_scores_out` over blocks of :data:`QCHUNK` query rows, each
    over all keys. Rounding as there: the scores to q's dtype, P to v's.
    The blocks bound the score memory; a row's result does not depend on
    them (the reference's last block of a length that is no multiple of
    QCHUNK starts early and is masked from the wrong offset; this one is
    cut short instead)."""
    S = q.shape[1]
    if S <= QCHUNK:
        return gqa_scores_out(q, k, v, causal)
    return torch.cat([gqa_scores_out(q[:, i:i + QCHUNK], k, v, causal,
                                     q_offset=i)
                      for i in range(0, S, QCHUNK)], dim=1)


def self_attention(q, k, v, causal=True, mode=None):
    """Self-attention of q [B,S,Hq,hd] over k/v [B,S,Hkv,hd]: the fused
    kernel (kv heads expanded) where ``mode`` resolves to it (CUDA
    tensors), else :func:`attention_plain_model`. ``mode="plain"`` forces
    the plain model path on the card (the comparison forwards)."""
    if resolve_mode(q, mode) == "kernel":
        k, v = _expand_kv(k, v, q.shape[2])
        return flash_attention(q, k, v, causal=causal, mode="kernel")
    return attention_plain_model(q, k, v, causal)


def _attention_core(q, k, v, cfg, pos, causal):
    """Rotary positions, then :func:`self_attention` (or
    :func:`gqa_scores_out` where the key length differs from the
    queries': the kernel takes q, k, v of one shape)."""
    q, k = _rope(q, k, cfg, pos)
    if k.shape[1] != q.shape[1]:
        return gqa_scores_out(q, k, v, causal)
    return self_attention(q, k, v, causal)


def _cross_core(q, k, v, cfg, pos, causal):
    """The cross-attention's core: plain, by definition, whatever the
    lengths (the reference's ``_gqa_scores_out``)."""
    return gqa_scores_out(q, k, v, causal)


def _attention_local(q, k, v, cfg, pos, causal, core=_attention_core):
    """``core`` (:func:`_attention_core`) of DTensors q, k, v, pos on each
    rank's local shards (``local_map``): rows over the batch axes, q heads
    over "model" where their count divides by its size (else every rank
    takes all). kv heads split with q's when theirs divide too, so a rank's
    q heads meet their own kv group; otherwise each rank takes the kv heads
    its q heads read (:func:`_group_heads`)."""
    dm = q.device_mesh
    tp = ctx.tp_size()
    hq, hkv = q.shape[2], k.shape[2]
    heads = "tp" if hq % tp == 0 else None
    qp = ctx.logical_placements(4, "batch", None, heads, None)
    kv_split = heads is not None and hkv % tp == 0
    kvp = qp if kv_split else ctx.logical_placements(4, "batch", None,
                                                     None, None)
    posp = None if pos is None else ctx.logical_placements(
        pos.ndim, *(("batch", None) if pos.ndim == 2
                    else (None, "batch", None)))

    def local(q, k, v, pos):
        if heads is not None and not kv_split:
            r, n = dm.get_local_rank("model"), q.shape[2]
            k, v = _group_heads(k, r, n, hq), _group_heads(v, r, n, hq)
        return core(q, k, v, cfg, pos, causal)

    return ctx.local_map(local, (qp,), (qp, kvp, kvp, posp))(q, k, v, pos)


def attention_train(p, x, cfg, pos, causal=True, kv_override=None):
    """Full-sequence attention: projections, rotary positions (``pos``
    [B,S], [3,B,S] or None), then :func:`self_attention`, causal or not.
    ``kv_override`` (k, v) replaces the layer's own keys and values
    (cross-attention); where their length differs from the queries' the
    attention is :func:`gqa_scores_out`, as the kernel takes q, k, v of one
    shape. On DTensors the rotation and the attention run on local shards
    (:func:`_attention_local`)."""
    q, k, v = _qkv(p, x, cfg)
    if kv_override is not None:
        k, v = kv_override
    if ctx.is_dtensor(q):
        q = shard(q, "batch", None, "tp", None)
        o = _attention_local(q, k, v, cfg, pos, causal)
    else:
        q, k = _rope(q, k, cfg, pos)
        q = shard(q, "batch", None, "tp", None)
        o = _attention_core(q, k, v, cfg, None, causal)
    o = shard(o, "batch", None, "tp", None)
    return _out_proj(o, p["wo"].to(x.dtype))


def _cross_q(p, x, cfg):
    """The cross-attention's queries: x's ``wq`` (and ``bq``)."""
    dt = x.dtype
    q = _proj(x, p["wq"].to(dt))
    return q + p["bq"].to(dt) if cfg.qkv_bias else q


def cross_attention(p, x, cfg, k, v):
    """Attention of x's queries (the layer's ``wq``, ``bq``, ``wo``) over
    given keys and values k, v [B,Sk,Hkv,hd]: Whisper's cross-attention,
    not causal, no rotation, plain torch (:func:`gqa_scores_out`) as it is
    jnp in the reference. On DTensors it runs on local shards, rows and
    heads, as the self-attention does (:func:`_attention_local`)."""
    q = _cross_q(p, x, cfg)
    if ctx.is_dtensor(q):
        o = _attention_local(q, k, v, cfg, None, False, core=_cross_core)
    else:
        o = gqa_scores_out(q, k, v)
    return _out_proj(o, p["wo"].to(x.dtype))


def attention_decode(p, x, cfg, cache_k, cache_v, cache_len):
    """One-token decode. x [B,1,d]; cache_k/v [B,Smax,Hkv,hd]; every row
    at position ``cache_len``.

    Writes the new k/v into the caches in place at ``cache_len`` (shared by
    all rows; past the end it lands on the last slot, as the reference's
    clamped ``dynamic_update_slice`` does) and returns (out, cache_k,
    cache_v). On DTensors (a placed cache, :func:`repro_torch.sharding.
    place.place_cache`) the write and the attention run on each rank's
    local shards (:func:`_decode_attend`)."""
    q, k, v = _qkv(p, x, cfg)
    o = _decode_attend(q, k, v, cache_k, cache_v, cfg, int(cache_len))
    return _out_proj(o, p["wo"].to(x.dtype)), cache_k, cache_v


def cross_attention_decode(p, x, cfg, k, v):
    """:func:`cross_attention` of a decode step over the cached keys and
    values k, v [B,Se,Hkv,hd]. On DTensors the cache is read where it is
    placed (:func:`_decode_attend`): with the frames split over "data"
    (fewer rows than the batch axes' size) each rank attends over its own
    frames and the parts are combined across "data"."""
    o = _decode_attend(_cross_q(p, x, cfg), None, None, k, v, cfg, None)
    return _out_proj(o, p["wo"].to(x.dtype))


def cache_pin(hkv: int) -> tuple:
    """The logical axes one layer's decode cache [B, Smax, Hkv, hd] is
    pinned to, the counterpart of the reference's ``shard(cache_k,
    "batch", None, "kv_tp", None)`` in ``attention_decode``: the rows over
    "batch" and the sequence over "cache_seq" (one of the two splits,
    :func:`repro_torch.sharding.ctx.decode_rules`), the kv heads over
    "model" where ``cache_specs`` puts them (``hkv % tp == 0``), else
    "kv_tp" (replicated by default, as there). The cache stays where it
    lies: the pin never moves it (see :func:`_decode_attend`)."""
    return ("batch", "cache_seq",
            "tp" if hkv % ctx.tp_size() == 0 else "kv_tp", None)


def _group_heads(kv, r: int, hq_l: int, hq: int):
    """Of every kv head of kv [B, S, Hkv, hd], those the ``hq_l`` q heads
    of model rank ``r`` read (q head h reads kv head ``h // (hq / Hkv)``,
    as :func:`_expand_kv` repeats them): a slice where the rank's q heads
    cover whole groups or lie in one, else the heads gathered one a q
    head."""
    g = hq // kv.shape[2]
    if hq_l % g == 0 or g % hq_l == 0:
        lo, hi = r * hq_l // g, ((r + 1) * hq_l - 1) // g + 1
        return kv[:, :, lo:hi]
    idx = (r * hq_l + torch.arange(hq_l, device=kv.device)) // g
    return kv.index_select(2, idx)


def _seq_combined(q, k, v, valid, group):
    """Attention of q [B,1,Hq,hd] over this rank's part k, v [B,Sl,Hkv,hd]
    of a sequence split over ``group`` (flash-decoding; kv heads expanded
    as :func:`gqa_scores_out` does): the scores in q's dtype then f32,
    masked to -1e30 outside ``valid`` [Sl] (None: all), the row max
    all-reduced (max) over the group, exp(s - max) and its products with v
    summed in f32 and all-reduced (sum), then divided: the softmax of the
    whole row, normalised once at the end."""
    import torch.distributed._functional_collectives as fc
    hd = q.shape[-1]
    k, v = _expand_kv(k, v, q.shape[2])
    s = torch.einsum("bqhd,bshd->bhqs", q, k).float() * (hd ** -0.5)
    if valid is not None:
        s = torch.where(valid, s, torch.full((), NEG, device=s.device))
    m = fc.all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(s - m)
    den = fc.all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)
    num = fc.all_reduce(torch.einsum("bhqs,bshd->bqhd", e, v.float()),
                        "sum", group)
    return (num / den.transpose(1, 2)).to(v.dtype)


def _decode_body(q, k, v, ck, cv, cfg, cache_len, off=0, smax=None,
                 pick=None, group=None):
    """A decode step's attention on plain tensors: q [B,1,Hq,hd], the new
    k, v [B,1,Hkv,hd] (None: cross-attention, nothing written) and the
    positions ``off`` .. ``off + Sl - 1`` of a cache ck, cv [B,Sl,Hkv,hd]
    of ``smax`` positions in all (None: Sl, the whole cache).

    With ``cache_len`` given, the rotary positions (every row at
    ``cache_len``) and the write first: the slot, clamped to the cache's
    last, is written where it lies in this part. Then
    :func:`gqa_scores_out` masked to ``<= cache_len``, or, the sequence
    split over ``group``, :func:`_seq_combined`. ``pick`` takes the kv
    heads q's heads read out of the cache's (:func:`_group_heads`)."""
    b, sl = q.shape[0], ck.shape[1]
    valid = None
    if cache_len is not None:
        pos = torch.full((b, 1), cache_len, device=q.device)
        q, k = _rope(q, k, cfg, pos[None].expand(3, b, 1)
                     if cfg.rope == "mrope" else pos)
        at = min(max(cache_len, 0), (smax or sl) - 1) - off
        if 0 <= at < sl:
            ck[:, at] = k[:, 0].to(ck.dtype)
            cv[:, at] = v[:, 0].to(cv.dtype)
        valid = off + torch.arange(sl, device=q.device) <= cache_len
    ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    if pick is not None:
        ck, cv = pick(ck), pick(cv)
    if group is not None:
        return _seq_combined(q, ck, cv, valid, group)
    mask = None if valid is None else valid[None].expand(b, sl)
    return gqa_scores_out(q, ck, cv, kv_len_mask=mask)


def _decode_attend(q, k, v, cache_k, cache_v, cfg, cache_len):
    """:func:`_decode_body` over the whole cache on plain tensors; on
    DTensors over each rank's local shards (``local_map``): q with its
    rows over the batch axes and its heads over "model" where their count
    divides its size, the new k, v likewise, and one layer's cache
    [B,Smax,Hkv,hd] placed by :func:`cache_pin`, which a cache of any
    other placement fails (a ``ValueError``: the write is in place, and a
    moved cache would take it). The batch branch (the sequence whole on
    every rank) attends over the local rows and heads; the sequence branch
    (the positions split evenly over "data", as ``place_cache`` checks)
    gives each rank its part's offset and combines across "data". A
    rank's q heads read their own kv heads: split with them, or picked
    out of all of them."""
    if not ctx.is_dtensor(q):
        return _decode_body(q, k, v, cache_k, cache_v, cfg, cache_len)
    dm = q.device_mesh
    hq, (_, smax, hkv, _) = q.shape[2], cache_k.shape
    heads = "tp" if hq % ctx.tp_size() == 0 else None
    pin = cache_pin(hkv)
    _, seq, kv_split, _ = (a is not None for a in ctx.logical_spec(4, *pin))
    cp = ctx.logical_placements(4, *pin)
    for c in (cache_k, cache_v):
        if tuple(c.placements) != cp:
            raise ValueError(
                f"a decode cache placed {tuple(c.placements)}, not as "
                f"cache_specs places it ({cp}): place it with "
                f"place.place_cache")
    qp = ctx.logical_placements(4, "batch", None, heads, None)
    kvp = ctx.logical_placements(4, "batch", None, pin[2], None)

    def local(q, k, v, ck, cv):
        r, hq_l = dm.get_local_rank("model"), q.shape[2]
        return _decode_body(
            q, k, v, ck, cv, cfg, cache_len,
            off=dm.get_local_rank("data") * ck.shape[1] if seq else 0,
            smax=smax,
            pick=(lambda c: _group_heads(c, r, hq_l, hq))
            if heads is not None and not kv_split else None,
            group=dm.get_group("data") if seq else None)

    if k is None:
        return ctx.local_map(lambda q, ck, cv: local(q, None, None, ck, cv),
                             (qp,), (qp, cp, cp))(q, cache_k, cache_v)
    return ctx.local_map(local, (qp,), (qp, kvp, kvp, cp, cp))(
        q, k, v, cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p, x):
    dt = x.dtype
    h = torch.nn.functional.silu(torch.matmul(x, p["w1"].to(dt)))
    h = h * torch.matmul(x, p["w3"].to(dt))
    h = shard(h, "batch", None, "tp")
    return torch.matmul(h, p["w2"].to(dt))


def unembed(x, embed):
    """Tied unembedding: x [..., d] @ embed [V, d]^T in x's dtype."""
    return torch.matmul(x, embed.to(x.dtype).t())


def embed_lookup(embed, tokens):
    """``embed[tokens]``. A DTensor table (vocab over "model", FSDP over
    "data") is gathered whole and each rank looks up its own token rows
    (``local_map``); the table's gradient is then a partial sum over the
    batch axes, reduced back onto its shards."""
    if not ctx.is_dtensor(embed):
        return embed[tokens]
    whole = ctx.logical_placements(2)
    rows = ctx.logical_placements(tokens.ndim, "batch")
    return ctx.local_map(
        lambda e, t: e[t], (ctx.logical_placements(tokens.ndim + 1, "batch"),),
        (whole, rows), (ctx.partial_over(whole, "batch"), rows))(
            embed, tokens)


def _xent_rows(logits, labels):
    """Each row's cross-entropy, logsumexp - the label's logit, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - ll


def softmax_xent(logits, labels):
    """Mean cross-entropy from f32 logits. DTensor logits (vocab over
    "model") are gathered over the vocab and each rank takes its own rows
    (``local_map``: a row's reductions are the unsharded ones); the mean
    comes back replicated."""
    if not ctx.is_dtensor(logits):
        return _xent_rows(logits, labels).mean()
    rows = ctx.logical_placements(labels.ndim, "batch")
    fn = ctx.local_map(_xent_rows, (rows,), (
        ctx.logical_placements(logits.ndim, "batch"), rows))
    return shard(fn(logits, labels).mean())
