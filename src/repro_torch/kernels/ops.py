"""Public entry points of the port's kernels on array-like inputs.

Inputs that are not tensors are placed on ``device`` (None = the card,
raising when there is none; pass ``device="cpu"`` for the plain version on
the CPU). Tensors keep their own device, which picks the executor
(:func:`repro_torch.kernels.backend.resolve_mode`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.carbon_cost import deficit_timeline_from_durs
from repro_torch.kernels.gain_scan import gain_scan, gain_scan_batched


def _target(device, first) -> torch.device:
    if isinstance(first, torch.Tensor) and device is None:
        return first.device
    return resolve_device(device)


def _f32(device, *arrays):
    dev = _target(device, arrays[0])
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in arrays]


def carbon_cost(starts, durs, works, g_eff, *, device=None):
    """Total carbon cost of a schedule (0-dim f32 tensor).

    ``ends = starts + durs`` is formed after casting both to f32, as the
    reference does; the cost is the sum of the deficit timeline
    (:func:`repro_torch.kernels.carbon_cost.deficit_timeline_from_durs`).
    Host inputs bound for the card go there packed, in one copy.
    """
    arrays = (starts, durs, works, g_eff)
    dev = _target(device, starts)
    if dev.type == "cuda" and not any(
            isinstance(a, torch.Tensor) and a.is_cuda for a in arrays):
        parts = [np.asarray(a) for a in arrays]
        if any(p.ndim != 1 for p in parts):
            raise ValueError(
                "carbon_cost takes vectors: starts, durs, works [N] and "
                f"g_eff [T]; got ranks {tuple(p.ndim for p in parts)}")
        sizes = [p.shape[0] for p in parts]
        packed = np.empty(sum(sizes), np.float32)
        at = 0
        for p, n in zip(parts, sizes):
            packed[at:at + n] = p          # the cast to f32, on the host
            at += n
        starts, durs, works, g_eff = torch.from_numpy(packed).to(dev).split(
            sizes)
    else:
        starts, durs, works, g_eff = (
            torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in arrays)
    return deficit_timeline_from_durs(starts, durs, works, g_eff).sum()


def ls_gains(rem, start, dur, work, lo, hi, *, mu: int = 10, device=None):
    """Local-search gain matrix f32[N, 2*mu+1] (illegal moves = -1e30)."""
    return gain_scan(*_f32(device, rem, start, dur, work, lo, hi), mu=mu)


def ls_gains_batched(rem, start, dur, work, lo, hi, *, mu: int = 10,
                     device=None):
    """Batched gain matrices f32[B, N, 2*mu+1] in ONE call.

    ``rem``/``start``/``lo``/``hi`` carry a leading batch axis [B, ...]
    (one row per portfolio variant); ``dur``/``work`` are shared [N].
    """
    return gain_scan_batched(*_f32(device, rem, start, dur, work, lo, hi),
                             mu=mu)
