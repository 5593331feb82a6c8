"""Mamba-1 selective SSM block, Jamba's mixer (the counterpart of
``repro.models.mamba``).

Training runs over sequence chunks of ``mcfg.chunk`` positions, carrying
the f32 SSM state from one chunk to the next, as the reference does.
Inside a chunk the linear recurrence h_t = dA_t * h_{t-1} + dBx_t is
solved as a prefix scan of the pairs (dA, dBx) under
(a, b) -> (a0 b0, b0 a1 + b1). The reference uses ``lax.associative_scan``
(log-depth); torch has no counterpart, so :func:`prefix_scan` is a
Hillis-Steele scan in torch ops: log2(chunk) steps, each combining every
position with the one ``2^i`` before it. Both are exact up to the order of
f32 products and sums, which differ (the tolerance is stated in the tests).
Decode is the O(1) recurrent step. No Pallas kernel exists here; the chunk
scan is XLA in the reference and torch ops in the port.

Under a mesh d_inner splits over "model", as in the reference: ``u`` and
``y`` are pinned to ("batch", -, "tp"), the depthwise conv and the chunk
scan run per channel on each rank's local rows and channels
(``local_map``), and ``x_proj`` and ``out_proj``, which contract over
d_inner, leave partial sums that DTensor reduces.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import shard


def mamba_shapes(d, mcfg, layers) -> dict:
    """The Mamba parameter tree: name -> (shape, init). ``init`` is the
    standard deviation of a normal draw, ``("fill", v)`` a constant, or
    ``("A_log",)``: log(1..d_state) along the last axis."""
    di = mcfg.expand * d
    dtr = max(d // 16, 1)
    return {
        "in_proj": ((layers, d, 2 * di), d ** -0.5),
        "conv_w": ((layers, mcfg.d_conv, di), 0.2),
        "conv_b": ((layers, di), ("fill", 0.0)),
        "x_proj": ((layers, di, dtr + 2 * mcfg.d_state), di ** -0.5),
        "dt_proj": ((layers, dtr, di), dtr ** -0.5),
        "dt_bias": ((layers, di), ("fill", 0.0)),
        "A_log": ((layers, di, mcfg.d_state), ("A_log",)),
        "D": ((layers, di), ("fill", 1.0)),
        "out_proj": ((layers, di, d), di ** -0.5),
    }


def _ssm_inputs(p, x):
    """x [B,S,d] -> (u, z), each [B,S,di]."""
    xz = torch.matmul(x, p["in_proj"].to(x.dtype))
    return torch.chunk(xz, 2, dim=-1)


def _conv_silu(p, u, mcfg, conv_state=None):
    """Causal depthwise conv (kernel d_conv) + SiLU; returns (u, new_state):
    the last d_conv - 1 inputs, the next step's state."""
    K = mcfg.d_conv
    if conv_state is None:
        pad = u.new_zeros(u.shape[:1] + (K - 1,) + u.shape[2:])
        full = torch.cat([pad, u], dim=1)
    else:
        full = torch.cat([conv_state.to(u.dtype), u], dim=1)
    S = u.shape[1]
    w = p["conv_w"].to(u.dtype)
    out = full[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + full[:, i:i + S] * w[i]
    out = out + p["conv_b"].to(u.dtype)
    new_state = full[:, full.shape[1] - (K - 1):]
    return F.silu(out), new_state


def _ssm_params(p, u, mcfg):
    """dt [B,S,di] f32, Bc/Cc [B,S,ds] f32, A [di,ds] f32."""
    dtr = p["dt_proj"].shape[-2]
    ds = mcfg.d_state
    dbc = torch.matmul(u, p["x_proj"].to(u.dtype)).float()
    dt_raw, Bc, Cc = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(torch.matmul(dt_raw, p["dt_proj"].float())
                    + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return dt, Bc, Cc, A


def prefix_scan(a, b, dim: int = 1):
    """Inclusive prefix of the pairs (a, b) along ``dim`` under
    (a, b) -> (a_prev a, a b_prev + b): returns (prod of a up to t, the
    recurrence's value at t from a zero state). Hillis-Steele: log2(n)
    steps."""
    n = a.shape[dim]
    for i in range(math.ceil(math.log2(max(n, 1)))):
        off = 1 << i
        a_hi, b_hi = a.narrow(dim, off, n - off), b.narrow(dim, off, n - off)
        a_lo, b_lo = a.narrow(dim, 0, n - off), b.narrow(dim, 0, n - off)
        b = torch.cat([b.narrow(dim, 0, off), a_hi * b_lo + b_hi], dim=dim)
        a = torch.cat([a.narrow(dim, 0, off), a_lo * a_hi], dim=dim)
    return a, b


def _scan(u, dt, Bc, Cc, A, D, mcfg):
    """The chunk scan of every channel, plus the skip: y [B,S,di] f32."""
    B_, S, di = u.shape
    ch = min(mcfg.chunk, S)
    assert S % ch == 0, (S, ch)
    uf = u.float()
    h = torch.zeros((B_, di, mcfg.d_state), dtype=torch.float32,
                    device=u.device)
    ys = []
    for c0 in range(0, S, ch):
        sl = slice(c0, c0 + ch)
        dA = torch.exp(dt[:, sl, :, None] * A)                # [B,ch,di,ds]
        dBx = (dt[:, sl] * uf[:, sl])[..., None] * Bc[:, sl, None, :]
        pA, pB = prefix_scan(dA, dBx)
        hs = pA * h[:, None] + pB
        ys.append(torch.einsum("bcis,bcs->bci", hs, Cc[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1) + D * uf


def _local_conv_scan(p, u, mcfg):
    """The conv and the scan of DTensors on local shards: rows over the
    batch axes, channels over "model". The per-channel parameters come
    whole over the batch axes, so their gradients are this rank's part of
    a sum there; the state-space inputs ``Bc``/``Cc`` come whole over
    "model", so theirs are this rank's channels' part of a sum there."""
    chans = ctx.logical_placements(3, "batch", None, "tp")
    rows = ctx.logical_placements(3, "batch", None, None)
    w, wg = _over_channels(2, -1)
    b, bg = _over_channels(1, -1)
    u = ctx.local_map(lambda u, w, b: _conv_silu(
        {"conv_w": w, "conv_b": b}, u, mcfg)[0],
        (chans,), (chans, w, b), (chans, wg, bg))(
            u, p["conv_w"], p["conv_b"])
    dt, Bc, Cc, A = _ssm_params(p, u, mcfg)
    a, ag = _over_channels(2, 0)
    dvec, dg = _over_channels(1, 0)
    bcg = ctx.partial_over(rows, "tp")
    y = ctx.local_map(lambda *t: _scan(*t, mcfg), (chans,),
                      (chans, chans, rows, rows, a, dvec),
                      (chans, chans, bcg, bcg, ag, dg))(
                          u, dt, Bc, Cc, A, p["D"])
    return u, y


def _over_channels(ndim, dim):
    """(placements, gradient placements) of a per-channel parameter of
    ``ndim`` dimensions whose dimension ``dim`` is d_inner: split over
    "model", whole elsewhere; its gradient a part of a sum over the batch
    axes."""
    axes = [None] * ndim
    axes[dim] = "tp"
    pl = ctx.logical_placements(ndim, *axes)
    return pl, ctx.partial_over(pl, "batch")


def mamba_train(p, x, mcfg):
    """Full-sequence forward. x [B,S,d] -> [B,S,d]."""
    u, z = _ssm_inputs(p, x)
    u = shard(u, "batch", None, "tp")
    if ctx.is_dtensor(u):
        u, y = _local_conv_scan(p, u, mcfg)
    else:
        u, _ = _conv_silu(p, u, mcfg)
        dt, Bc, Cc, A = _ssm_params(p, u, mcfg)
        y = _scan(u, dt, Bc, Cc, A, p["D"], mcfg)
    y = y.to(x.dtype) * F.silu(z)
    y = shard(y, "batch", None, "tp")
    return torch.matmul(y, p["out_proj"].to(x.dtype))


def mamba_init_state(p, mcfg, batch, dtype=torch.float32):
    di = p["conv_w"].shape[-1]
    dev = p["conv_w"].device
    return {
        "conv": torch.zeros((batch, mcfg.d_conv - 1, di), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, di, mcfg.d_state), dtype=torch.float32,
                           device=dev),
    }


def _ssm_step(u, dt, Bc, Cc, A, D, h):
    """One recurrent step of every channel: u, dt [B,1,di], Bc/Cc [B,1,ds],
    A [di,ds], D [di], the state h [B,di,ds] f32 -> (y [B,1,di] f32, the
    new state)."""
    dA = torch.exp(dt[:, 0, :, None] * A)                     # [B,di,ds]
    dBx = (dt[:, 0] * u[:, 0].float())[..., None] * Bc[:, 0, None, :]
    h = dA * h + dBx
    y = torch.einsum("bis,bs->bi", h, Cc[:, 0])[:, None, :]
    return y + D * u.float(), h


def mamba_decode(p, x, mcfg, state):
    """One-token step. x [B,1,d] -> ([B,1,d], new state). On DTensors (a
    placed cache: ``conv`` [B, d_conv - 1, di] and ``ssm`` [B, di, ds]
    with d_inner over "model", as ``cache_specs`` places them) the conv
    and the recurrence run on each rank's local rows and channels
    (``local_map``), as :func:`mamba_train`'s chunk scan does."""
    u, z = _ssm_inputs(p, x)
    if ctx.is_dtensor(u):
        u = shard(u, "batch", None, "tp")
        chans = ctx.logical_placements(3, "batch", None, "tp")
        w, _ = _over_channels(2, -1)
        b, _ = _over_channels(1, -1)
        u, conv_state = ctx.local_map(
            lambda u, w, b, c: _conv_silu({"conv_w": w, "conv_b": b}, u,
                                          mcfg, conv_state=c),
            (chans, chans), (chans, w, b, chans))(
                u, p["conv_w"], p["conv_b"], state["conv"])
        dt, Bc, Cc, A = _ssm_params(p, u, mcfg)
        rows = ctx.logical_placements(3, "batch", None, None)
        a, _ = _over_channels(2, 0)
        dvec, _ = _over_channels(1, 0)
        hp = ctx.logical_placements(3, "batch", "tp", None)
        y, h = ctx.local_map(_ssm_step, (chans, hp),
                             (chans, chans, rows, rows, a, dvec, hp))(
                                 u, dt, Bc, Cc, A, p["D"], state["ssm"])
    else:
        u, conv_state = _conv_silu(p, u, mcfg, conv_state=state["conv"])
        dt, Bc, Cc, A = _ssm_params(p, u, mcfg)
        y, h = _ssm_step(u, dt, Bc, Cc, A, p["D"], state["ssm"])
    y = y.to(x.dtype) * F.silu(z)
    y = shard(y, "batch", None, "tp")
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    return out, {"conv": conv_state.to(state["conv"].dtype), "ssm": h}
