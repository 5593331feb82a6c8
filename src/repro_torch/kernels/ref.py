"""Plain-PyTorch oracles for the port's kernels (same shapes & semantics)."""
from __future__ import annotations

import torch


def gain_scan_ref(rem, start, dur, work, lo, hi, *, mu: int = 10):
    """Oracle for :func:`repro_torch.kernels.gain_scan.gain_scan`, by the
    direct definition: total deficit of the timeline after the move minus
    before, over every (task, shift) pair (identical to the kernel's
    symmetric-difference form).

    ``rem`` f32[T]; ``start``, ``dur``, ``work``, ``lo``, ``hi`` f32[N]
    (absolute bounds). Returns f32[N, 2*mu+1].
    """
    T = rem.shape[0]
    t = torch.arange(T, dtype=torch.float32, device=rem.device)   # [T]
    s, d, w = start[:, None, None], dur[:, None, None], work[:, None, None]
    old = ((s <= t) & (t < s + d)).to(torch.float32)              # [N,1,T]
    base = rem + w * old                  # timeline without the task
    deltas = torch.arange(-mu, mu + 1, dtype=torch.float32,
                          device=rem.device)[None, :, None]       # [1,D,1]
    ns = s + deltas                                               # [N,D,1]
    new = ((ns <= t) & (t < ns + d)).to(torch.float32)            # [N,D,T]
    before = torch.clamp(-(base - w * old), min=0.0).sum(-1)      # [N,1]
    after = torch.clamp(-(base - w * new), min=0.0).sum(-1)       # [N,D]
    ns = ns[..., 0]
    legal = ((lo[:, None] <= ns) & (ns <= hi[:, None])
             & (deltas[..., 0] != 0) & (work[:, None] > 0))
    return torch.where(legal, before - after,
                       torch.full((), -1e30, device=rem.device))
