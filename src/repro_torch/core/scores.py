"""Task scores (paper §5.2): slack, pressure, and power-weighted variants."""
from __future__ import annotations

import numpy as np

from repro_torch.core.dag import Instance


def weight_factor(inst: Instance, platform) -> np.ndarray:
    """wf(i) = (P_idle^i + P_work^i) / max_j (P_idle^j + P_work^j), per task."""
    total = platform.p_idle + platform.p_work
    return total[inst.proc] / total.max()


def task_order(inst: Instance, est: np.ndarray, lst: np.ndarray,
               score: str, weighted: bool, platform) -> np.ndarray:
    """Processing order of tasks for the greedy (most urgent first).

    slack:    s(v) = LST - EST, sorted non-decreasing;
    pressure: rho(v) = w / (s + w), sorted non-increasing.
    Weighted versions multiply pressure by wf(i) and slack by 1/wf(i).
    Ties break by task id (the paper's "basic implementation without special
    tie-breaking").
    """
    slack = (lst - est).astype(np.float64)
    if score == "slack":
        val = slack
        if weighted:
            val = val / weight_factor(inst, platform)
        key = val                      # ascending
    elif score == "press":
        val = inst.dur / (slack + inst.dur)
        if weighted:
            val = val * weight_factor(inst, platform)
        key = -val                     # descending
    else:
        raise ValueError(f"unknown score {score!r}")
    return np.lexsort((np.arange(inst.num_tasks), key))
