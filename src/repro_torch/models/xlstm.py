"""xLSTM blocks [arXiv:2405.04517]: chunkwise-parallel mLSTM + sequential
sLSTM (the counterpart of ``repro.models.xlstm``).

mLSTM keeps a matrix memory C [hd, hd] per head with scalar input and
forget gates; its linear recurrence runs in the chunkwise form (an
attention-like term inside a chunk of :data:`CHUNK` positions, with the
cumulative log forget gate as its decay, plus the state carried in from
the chunks before). sLSTM's recurrence is not parallel, so it runs step by
step with block-diagonal (per-head) recurrent weights. Gates use the
reference's sigmoid forms (its documented simplification of the paper's
exponential gates). Both are torch ops, as they are XLA in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm

CHUNK = 64


def mlstm_shapes(cfg, layers) -> dict:
    """The mLSTM parameter tree: name -> (shape, init), ``init`` a normal
    draw's standard deviation or ``("fill", v)``."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "ln": ((layers, d), ("fill", 1.0)),
        "wq": ((layers, d, H, hd), d ** -0.5),
        "wk": ((layers, d, H, hd), d ** -0.5),
        "wv": ((layers, d, H, hd), d ** -0.5),
        "wi": ((layers, d, H), d ** -0.5),
        "wf": ((layers, d, H), d ** -0.5),
        "bf": ((layers, H), ("fill", 3.0)),      # forget bias: long memory
        "wgate": ((layers, d, H * hd), d ** -0.5),
        "wo": ((layers, H, hd, d), (H * hd) ** -0.5),
    }


def slstm_shapes(cfg, layers) -> dict:
    """The sLSTM parameter tree (gates z, i, f, o on axis 2 of ``wx``)."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "ln": ((layers, d), ("fill", 1.0)),
        "wx": ((layers, d, 4, H, hd), d ** -0.5),
        "wr": ((layers, 4, H, hd, hd), hd ** -0.5),
        "b": ((layers, 4, H, hd), ("fill", 0.0)),
        "wo": ((layers, H, hd, d), (H * hd) ** -0.5),
    }


def _heads(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, H, hd = w.shape
    return torch.matmul(x, w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


def _out(y, wo):
    """einsum("bshk,hkd->bsd")."""
    H, hd, d = wo.shape
    return torch.matmul(y.reshape(*y.shape[:-2], H * hd),
                        wo.reshape(H * hd, d))


def _mlstm_proj(p, x, cfg):
    """The normed input and its q, k (scaled by hd^-0.5), v, and the f32
    input and forget gates [B,S,H]."""
    dt = x.dtype
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = _heads(xn, p["wq"].to(dt))
    k = _heads(xn, p["wk"].to(dt)) * cfg.head_dim ** -0.5
    v = _heads(xn, p["wv"].to(dt))
    x32 = xn.float()
    i = torch.sigmoid(torch.matmul(x32, p["wi"]))
    f = torch.sigmoid(torch.matmul(x32, p["wf"]) + p["bf"])
    return xn, q, k, v, i, f


def _mlstm_out(p, x, xn, y):
    """Output gate, projection and residual: y [B,S,H,hd] in x's dtype."""
    B, S = x.shape[:2]
    gate = F.silu(torch.matmul(xn, p["wgate"].to(x.dtype)))
    y = y.reshape(B, S, -1) * gate
    return x + _out(y.view(B, S, *p["wo"].shape[:2]), p["wo"].to(x.dtype))


def mlstm_train(p, x, cfg):
    """Chunkwise-parallel mLSTM. x [B,S,d] -> [B,S,d]."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    xn, q, k, v, i, f = _mlstm_proj(p, x, cfg)
    ch = min(CHUNK, S)
    assert S % ch == 0
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    mask = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for c0 in range(0, S, ch):
        sl = slice(c0, c0 + ch)
        qq, kk, vv = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ii, ff = i[:, sl], f[:, sl]                          # [B,ch,H]
        acum = torch.cumsum(torch.log(ff + 1e-8), dim=1)     # inclusive
        # inter-chunk: the state's contribution decayed to each position
        dec = torch.exp(acum)
        y_int = torch.einsum("bchd,bhde->bche", qq, C) * dec[..., None]
        n_int = torch.einsum("bchd,bhd->bch", qq, n) * dec
        # intra-chunk: decay(t, s) = exp(acum_t - acum_s) * i_s, s <= t
        w_ts = torch.exp(acum[:, :, None, :] - acum[:, None, :, :])
        w_ts = torch.where(mask[None, :, :, None], w_ts,
                           torch.zeros((), device=x.device))
        w_ts = w_ts * ii[:, None, :, :]
        sc = torch.einsum("bthd,bshd->btsh", qq, kk) * w_ts
        y_intra = torch.einsum("btsh,bshd->bthd", sc, vv)
        n_intra = sc.sum(dim=2)
        y = y_int + y_intra
        nn_ = torch.abs(n_int + n_intra)
        y = y / torch.clamp(nn_, min=1.0)[..., None]
        # the state at the chunk's end
        wN = torch.exp(acum[:, -1:, :] - acum) * ii
        carry = torch.exp(acum[:, -1])
        C = (carry[:, :, None, None] * C
             + torch.einsum("bsh,bshd,bshe->bhde", wN, kk, vv))
        n = carry[:, :, None] * n + torch.einsum("bsh,bshd->bhd", wN, kk)
        ys.append(y.to(x.dtype))
    return _mlstm_out(p, x, xn, torch.cat(ys, dim=1))


def mlstm_init_state(cfg, batch, device=None):
    H, hd = cfg.num_heads, cfg.head_dim
    return {"C": torch.zeros((batch, H, hd, hd), device=device),
            "n": torch.zeros((batch, H, hd), device=device)}


def mlstm_decode(p, x, cfg, state):
    """One-token mLSTM step. x [B,1,d] -> ([B,1,d], new state)."""
    xn, q, k, v, i, f = _mlstm_proj(p, x, cfg)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i, f = i[:, 0], f[:, 0]                                  # [B,H]
    C = (f[..., None, None] * state["C"]
         + i[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n = f[..., None] * state["n"] + i[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, C)
    nn_ = torch.abs(torch.einsum("bhd,bhd->bh", q, n))
    y = y / torch.clamp(nn_, min=1.0)[..., None]
    return _mlstm_out(p, x, xn, y[:, None].to(x.dtype)), {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM: strictly sequential, block-diagonal recurrence
# ---------------------------------------------------------------------------

def slstm_init_state(cfg, batch, device=None):
    H, hd = cfg.num_heads, cfg.head_dim
    return {"c": torch.zeros((batch, H, hd), device=device),
            "h": torch.zeros((batch, H, hd), device=device)}


def _recurrent(wr):
    """The block-diagonal recurrent weights [4, H, hd, hd] as one [H, hd,
    4 hd] operand of a batched product over the heads."""
    G, H, hd, _ = wr.shape
    return wr.permute(1, 2, 0, 3).reshape(H, hd, G * hd)


def _slstm_step(p, wr, xg, state):
    """xg [B,4,H,hd] (the input projections, f32), wr from
    :func:`_recurrent`; returns (state, h). The recurrence
    ``einsum("bhk,ghkl->bghl", h, wr)`` is one batched product over the
    heads."""
    c, h = state["c"], state["h"]
    B, H, hd = h.shape
    rec = torch.bmm(h.transpose(0, 1), wr).view(H, B, 4, hd)
    g = xg + rec.permute(1, 2, 0, 3) + p["b"]
    z = torch.tanh(g[:, 0])
    i, f, o = torch.sigmoid(g[:, 1:]).unbind(1)
    c = torch.addcmul(f * c, i, z)
    h = o * torch.tanh(c)
    return {"c": c, "h": h}, h


def _slstm_proj(p, x, cfg):
    """The normed input's gate projections [B,S,4,H,hd], f32."""
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    d, G, H, hd = p["wx"].shape
    wx = p["wx"].to(x.dtype).reshape(d, G * H * hd)
    return torch.matmul(xn, wx).view(*x.shape[:2], G, H, hd).float()


def slstm_train(p, x, cfg):
    xg = _slstm_proj(p, x, cfg)
    wr = _recurrent(p["wr"])
    state = slstm_init_state(cfg, x.shape[0], x.device)
    hs = []
    for t in range(x.shape[1]):
        state, h = _slstm_step(p, wr, xg[:, t], state)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)                    # [B,S,H,hd]
    return x + _out(y, p["wo"].to(x.dtype))


def slstm_decode(p, x, cfg, state):
    xg = _slstm_proj(p, x, cfg)[:, 0]
    state, h = _slstm_step(p, _recurrent(p["wr"]), xg, state)
    return x + _out(h.to(x.dtype), p["wo"].to(x.dtype))[:, None], state
