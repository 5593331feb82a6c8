"""Shared model layers: RMSNorm, RoPE, attention, SwiGLU MLP (the dense
decoder's counterparts of ``repro.models.layers``).

Functions over explicit parameter dicts of one layer, in the reference's
layouts (``wq`` [d, H, hd], ``wo`` [H, hd, d], ...). Master parameters stay
f32 and are cast to the activation dtype at use, as in the reference. The
forward's attention goes through
:func:`repro_torch.kernels.flash_attention.flash_attention` (the CUDA kernel
on the card, its plain version on the CPU), which computes the same exact
softmax attention as the reference's query-chunked jnp form; the decode
step's one-query attention over the cache stays plain torch, as it is jnp
in the reference. M-RoPE (the VLM family) is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention

NEG = -1e30


def dtype_of(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rmsnorm(x, w, eps=1e-6):
    """RMSNorm in f32, times the f32 weight, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard)
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


def _rope(q, k, cfg, pos):
    if cfg.rope == "std":
        return apply_rope(q, pos, cfg.rope_theta), \
            apply_rope(k, pos, cfg.rope_theta)
    raise NotImplementedError(
        f"rope={cfg.rope!r} is not ported to repro_torch yet (M-RoPE and "
        f"absolute positions come with the VLM and Whisper families)")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul: x [B,S,d], w [d,H,hd]."""
    d, H, hd = w.shape
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


def _gqa_scores_out(q, k, v, kv_len_mask):
    """Exact non-causal attention of q [B,Sq,Hq,hd] over k/v [B,Sk,Hkv,hd],
    keys masked by ``kv_len_mask`` [B,Sk] (the decode step)."""
    hd = q.shape[-1]
    k, v = _expand_kv(k, v, q.shape[2])
    s = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    s = s * (hd ** -0.5)
    s = torch.where(kv_len_mask[:, None, None, :], s,
                    torch.full((), NEG, device=s.device))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def attention_train(p, x, cfg, pos):
    """Full-sequence causal attention: projections, RoPE, kv heads
    expanded, then the fused attention kernel. pos: [B,S]."""
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope(q, k, cfg, pos)
    k, v = _expand_kv(k, v, q.shape[2])
    o = flash_attention(q, k, v, causal=True)
    return _out_proj(o, p["wo"].to(x.dtype))


def attention_decode(p, x, cfg, pos, cache_k, cache_v, cache_len):
    """One-token decode. x [B,1,d]; cache_k/v [B,Smax,Hkv,hd]; pos [B].

    Writes the new k/v into the caches in place at ``cache_len`` (shared by
    all rows; past the end it lands on the last slot, as the reference's
    clamped ``dynamic_update_slice`` does) and returns (out, cache_k,
    cache_v)."""
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope(q, k, cfg, pos[:, None])
    Smax = cache_k.shape[1]
    at = min(max(int(cache_len), 0), Smax - 1)
    cache_k[:, at] = k[:, 0].to(cache_k.dtype)
    cache_v[:, at] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(Smax, device=x.device)[None, :] <= int(cache_len)
    valid = valid.expand(x.shape[0], Smax)
    o = _gqa_scores_out(q, cache_k.to(q.dtype), cache_v.to(q.dtype), valid)
    return _out_proj(o, p["wo"].to(x.dtype)), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p, x):
    dt = x.dtype
    h = torch.nn.functional.silu(torch.matmul(x, p["w1"].to(dt)))
    h = h * torch.matmul(x, p["w3"].to(dt))
    return torch.matmul(h, p["w2"].to(dt))


def unembed(x, embed):
    """Tied unembedding: x [..., d] @ embed [V, d]^T in x's dtype."""
    return torch.matmul(x, embed.to(x.dtype).t())


def softmax_xent(logits, labels):
    """Mean cross-entropy from f32 logits."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()
