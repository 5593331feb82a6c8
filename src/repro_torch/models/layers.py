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
the cross-attention.
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
    q heads meet their own kv group; otherwise each rank expands all kv
    heads and keeps its q heads' share."""
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
            k, v = _expand_kv(k, v, hq)
            r, n = dm.get_local_rank("model"), q.shape[2]
            k, v = k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n]
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


def cross_attention(p, x, cfg, k, v):
    """Attention of x's queries (the layer's ``wq``, ``bq``, ``wo``) over
    given keys and values k, v [B,Sk,Hkv,hd]: Whisper's cross-attention,
    not causal, no rotation, plain torch (:func:`gqa_scores_out`) as it is
    jnp in the reference. On DTensors it runs on local shards, rows and
    heads, as the self-attention does (:func:`_attention_local`)."""
    dt = x.dtype
    q = _proj(x, p["wq"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    if ctx.is_dtensor(q):
        o = _attention_local(q, k, v, cfg, None, False, core=_cross_core)
    else:
        o = gqa_scores_out(q, k, v)
    return _out_proj(o, p["wo"].to(dt))


def attention_decode(p, x, cfg, pos, cache_k, cache_v, cache_len):
    """One-token decode. x [B,1,d]; cache_k/v [B,Smax,Hkv,hd]; pos [B].

    Writes the new k/v into the caches in place at ``cache_len`` (shared by
    all rows; past the end it lands on the last slot, as the reference's
    clamped ``dynamic_update_slice`` does) and returns (out, cache_k,
    cache_v)."""
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope == "mrope":
        pos3 = pos[None, :, None].expand(3, pos.shape[0], 1)
        q, k = _rope(q, k, cfg, pos3)
    else:
        q, k = _rope(q, k, cfg, pos[:, None])
    Smax = cache_k.shape[1]
    at = min(max(int(cache_len), 0), Smax - 1)
    cache_k[:, at] = k[:, 0].to(cache_k.dtype)
    cache_v[:, at] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(Smax, device=x.device)[None, :] <= int(cache_len)
    valid = valid.expand(x.shape[0], Smax)
    o = gqa_scores_out(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                       kv_len_mask=valid)
    return _out_proj(o, p["wo"].to(x.dtype)), cache_k, cache_v


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
