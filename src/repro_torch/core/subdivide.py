"""Refined interval subdivision (paper §5.2, "Subdivision of the intervals").

On each processor chain, every block of at most ``k`` consecutive tasks is
tentatively aligned to start or end at each original interval boundary; the
induced task start times become additional candidate interval boundaries.

Times are integers in ``[0, T]``, so the candidate set is returned as a
boolean mask over ``[0, T]`` (equivalent to the paper's sorted subdivision,
cheaper to maintain).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dag import Instance
from repro_torch.core.carbon import PowerProfile


def candidate_mask(inst: Instance, profile: PowerProfile,
                   refined: bool, k: int = 3) -> np.ndarray:
    """Boolean mask over [0, T]: True where a task may be started."""
    T = profile.T
    mask = np.zeros(T + 1, dtype=bool)
    mask[np.clip(profile.bounds, 0, T)] = True
    if not refined:
        return mask
    bounds = profile.bounds.astype(np.int64)
    for chain in inst.proc_chains:
        durs = inst.dur[np.asarray(chain, dtype=np.int64)]
        pref = np.concatenate([[0], np.cumsum(durs)])       # [len+1]
        n = len(chain)
        for size in range(1, k + 1):
            if n < size:
                break
            # blocks (i .. i+size-1); member offset within the block starting
            # at i is pref[i+j] - pref[i]
            i = np.arange(n - size + 1)[:, None]
            j = np.arange(size)[None, :]
            off = pref[i + j] - pref[i]                     # [B, size]
            L = (pref[i + size] - pref[i])                  # [B, 1] block length
            # block starts at boundary e: member start = e + off
            p1 = bounds[None, None, :] + off[:, :, None]
            # block ends at boundary e: member start = e - (L - off)
            p2 = bounds[None, None, :] - (L - off)[:, :, None]
            pts = np.concatenate([p1.ravel(), p2.ravel()])
            pts = pts[(pts >= 0) & (pts <= T)]
            mask[pts] = True
    return mask
