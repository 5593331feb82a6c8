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

Under a mesh the mLSTM's chunk recurrence runs on each rank's local rows
and heads (heads over "model" where they divide) and its gated output is
pinned to ("batch", -, "tp"), as in the reference; the sLSTM's recurrence
and both initial states run on each rank's local rows (``local_map``),
its recurrent weights whole, their gradients a part of a sum over the
batch axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _proj, rmsnorm
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import shard

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


def _out(y, wo):
    """einsum("bshk,hkd->bsd")."""
    H, hd, d = wo.shape
    return ctx.matmul(y.reshape(*y.shape[:-2], H * hd),
                      wo.reshape(H * hd, d))


def _mlstm_proj(p, x, cfg):
    """The normed input and its q, k (scaled by hd^-0.5), v, and the f32
    input and forget gates [B,S,H]."""
    dt = x.dtype
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = _proj(xn, p["wq"].to(dt))
    k = _proj(xn, p["wk"].to(dt)) * cfg.head_dim ** -0.5
    v = _proj(xn, p["wv"].to(dt))
    x32 = xn.float()
    i = torch.sigmoid(ctx.matmul(x32, p["wi"]))
    f = torch.sigmoid(ctx.matmul(x32, p["wf"]) + p["bf"])
    return xn, q, k, v, i, f


def _mlstm_out(p, x, xn, y):
    """Output gate, projection and residual: y [B,S,H,hd] (or its heads
    flattened) in x's dtype."""
    B, S = x.shape[:2]
    gate = F.silu(ctx.matmul(xn, p["wgate"].to(x.dtype)))
    y = shard(y.reshape(B, S, -1) * gate, "batch", None, "tp")
    return x + ctx.matmul(y, p["wo"].to(x.dtype).reshape(-1, x.shape[-1]))


def _mlstm_chunks(q, k, v, i, f, dtype):
    """The chunkwise recurrence from a zero state: q, k, v [B,S,H,hd], the
    f32 gates i, f [B,S,H] -> y [B,S,H,hd] in ``dtype``."""
    B, S, H, hd = q.shape
    ch = min(CHUNK, S)
    assert S % ch == 0
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    mask = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                 device=q.device))
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
                           torch.zeros((), device=q.device))
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
        ys.append(y.to(dtype))
    return torch.cat(ys, dim=1)


def mlstm_train(p, x, cfg):
    """Chunkwise-parallel mLSTM. x [B,S,d] -> [B,S,d]."""
    xn, q, k, v, i, f = _mlstm_proj(p, x, cfg)
    if ctx.is_dtensor(q):
        # heads flattened on the rank: no DTensor view splits a head
        heads = "tp" if q.shape[2] % ctx.tp_size() == 0 else None
        qp = ctx.logical_placements(4, "batch", None, heads, None)
        gp = ctx.logical_placements(3, "batch", None, heads)
        y = ctx.local_map(lambda *t: _mlstm_chunks(*t, x.dtype).flatten(2),
                          (gp,), (qp, qp, qp, gp, gp))(q, k, v, i, f)
    else:
        y = _mlstm_chunks(q, k, v, i, f, x.dtype)
    return _mlstm_out(p, x, xn, y)


def mlstm_init_state(cfg, batch, device=None):
    H, hd = cfg.num_heads, cfg.head_dim
    return {"C": torch.zeros((batch, H, hd, hd), device=device),
            "n": torch.zeros((batch, H, hd), device=device)}


def _mlstm_step(q, k, v, i, f, C, n):
    """One step of the matrix memory: q, k, v [B,1,H,hd], the f32 gates
    i, f [B,1,H], the state C [B,H,hd,hd], n [B,H,hd] -> (y [B,H,hd] f32,
    C, n)."""
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i, f = i[:, 0], f[:, 0]                                  # [B,H]
    C = (f[..., None, None] * C
         + i[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n = f[..., None] * n + i[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, C)
    nn_ = torch.abs(torch.einsum("bhd,bhd->bh", q, n))
    return y / torch.clamp(nn_, min=1.0)[..., None], C, n


def mlstm_decode(p, x, cfg, state):
    """One-token mLSTM step. x [B,1,d] -> ([B,1,d], new state). On
    DTensors the step runs on each rank's local rows (``local_map``), every
    head whole, as ``cache_specs`` places the state (rows over the batch
    axes, or whole with fewer rows than their size)."""
    xn, q, k, v, i, f = _mlstm_proj(p, x, cfg)
    if ctx.is_dtensor(q):
        r3, r4 = (ctx.logical_placements(n, "batch") for n in (3, 4))
        y, C, n = ctx.local_map(
            _mlstm_step, (r3, r4, r3), (r4, r4, r4, r3, r3, r4, r3))(
                q, k, v, i, f, state["C"], state["n"])
    else:
        y, C, n = _mlstm_step(q, k, v, i, f, state["C"], state["n"])
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


def _gates(xn, wx):
    """xn [B,S,d] @ wx [d,4,H,hd] -> [B,S,4,H,hd], f32."""
    d, G, H, hd = wx.shape
    return torch.matmul(xn, wx.reshape(d, G * H * hd)).view(
        *xn.shape[:2], G, H, hd).float()


def _slstm_proj(p, x, cfg):
    """The normed input's gate projections [B,S,4,H,hd], f32. On DTensors
    each rank projects its own rows whole (``local_map``: the recurrence
    takes whole rows; ``wx`` whole, its gradient a part of a sum over the
    batch axes)."""
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    wx = p["wx"].to(x.dtype)
    if not ctx.is_dtensor(xn):
        return _gates(xn, wx)
    rows = ctx.logical_placements(3, "batch")
    wp = ctx.logical_placements(4)
    return ctx.local_map(_gates, (ctx.logical_placements(5, "batch"),),
                         (rows, wp), (rows, ctx.partial_over(wp, "batch")))(
                             xn, wx)


def _slstm_scan(xg, wr, b):
    """The recurrence over xg [B,S,4,H,hd] from zero states, one step a
    position: h [B,S,H,hd] f32."""
    B, _, _, H, hd = xg.shape
    p, wr = {"b": b}, _recurrent(wr)
    state = {"c": xg.new_zeros((B, H, hd)), "h": xg.new_zeros((B, H, hd))}
    hs = []
    for t in range(xg.shape[1]):
        state, h = _slstm_step(p, wr, xg[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1)


def slstm_train(p, x, cfg):
    xg = _slstm_proj(p, x, cfg)
    if ctx.is_dtensor(xg):
        rows = ctx.logical_placements(5, "batch")
        w, b = ctx.logical_placements(4), ctx.logical_placements(3)
        hs = ctx.local_map(
            lambda *t: _slstm_scan(*t).flatten(2),
            (ctx.logical_placements(3, "batch"),),
            (rows, w, b), (rows, ctx.partial_over(w, "batch"),
                           ctx.partial_over(b, "batch")))(
                               xg, p["wr"], p["b"])
    else:
        hs = _slstm_scan(xg, p["wr"], p["b"]).flatten(2)
    return x + ctx.matmul(hs.to(x.dtype),
                          p["wo"].to(x.dtype).reshape(-1, x.shape[-1]))


def slstm_decode(p, x, cfg, state):
    """One-token sLSTM step. x [B,1,d] -> ([B,1,d], new state). On
    DTensors the recurrence runs on each rank's local rows
    (``local_map``), its weights whole."""
    xg = _slstm_proj(p, x, cfg)[:, 0]
    if ctx.is_dtensor(xg):
        rows = ctx.logical_placements(3, "batch")

        def step(xg, wr, b, c, h):
            st, h = _slstm_step({"b": b}, _recurrent(wr), xg,
                                {"c": c, "h": h})
            return st["c"], h

        c, h = ctx.local_map(step, (rows, rows), (
            ctx.logical_placements(4, "batch"), ctx.logical_placements(4),
            ctx.logical_placements(3), rows, rows))(
                xg, p["wr"], p["b"], state["c"], state["h"])
        state = {"c": c, "h": h}
    else:
        state, h = _slstm_step(p, _recurrent(p["wr"]), xg, state)
    return x + _out(h.to(x.dtype), p["wo"].to(x.dtype))[:, None], state
