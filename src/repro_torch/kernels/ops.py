"""Public entry points of the port's kernels on array-like inputs.

Inputs that are not tensors are placed on ``device`` (None = the card,
raising when there is none; pass ``device="cpu"`` for the plain version on
the CPU). Tensors keep their own device, which picks the executor
(:func:`repro_torch.kernels.backend.resolve_mode`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.carbon_cost import deficit_timeline
from repro_torch.kernels.gain_scan import gain_scan, gain_scan_batched


def _f32(device, *arrays):
    if isinstance(arrays[0], torch.Tensor) and device is None:
        dev = arrays[0].device
    else:
        dev = resolve_device(device)
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in arrays]


def carbon_cost(starts, durs, works, g_eff, *, device=None):
    """Total carbon cost of a schedule (0-dim f32 tensor).

    ``ends = starts + durs`` is formed after casting both to f32, as the
    reference does; the cost is the sum of
    :func:`repro_torch.kernels.carbon_cost.deficit_timeline`.
    """
    starts, durs, works, g_eff = _f32(device, starts, durs, works, g_eff)
    return deficit_timeline(starts, starts + durs, works, g_eff).sum()


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
