"""Power profiles and carbon-cost oracles (paper §3, §6.1, Appendix A.1).

A profile is a partition of the horizon ``[0, T)`` into ``J`` intervals with
a constant green budget per time unit. The schedule-independent idle draw
``sum_i P_idle^i`` folds into an *effective* budget ``g_eff = G_j - idle``;
profile generation guarantees ``G_j >= idle`` (paper §6.1), so
``cost_t = max(work_power(t) - g_eff(t), 0)``.

Two cost oracles, both exact and mutually validated:
  * :func:`schedule_cost`      -- numpy, subinterval sweep of Appendix A.1;
  * :func:`cost_timeline`      -- numpy, per-time-unit (pseudo-polynomial).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dag import Instance


@dataclasses.dataclass(frozen=True)
class PowerProfile:
    """Green power budget, piecewise constant over J intervals."""

    bounds: np.ndarray   # [J+1] interval boundaries, bounds[0]=0, bounds[J]=T
    budget: np.ndarray   # [J] raw green budget per time unit
    scenario: str = "custom"

    @property
    def T(self) -> int:
        return int(self.bounds[-1])

    @property
    def J(self) -> int:
        return len(self.budget)

    def effective(self, idle_total: int) -> np.ndarray:
        """Effective green budget (work power the profile can absorb)."""
        return self.budget - idle_total

    def unit_budget(self, idle_total: int) -> np.ndarray:
        """Per-time-unit effective budget, shape [T] (pseudo-poly; tests/kernels)."""
        g = self.effective(idle_total)
        lens = np.diff(self.bounds)
        return np.repeat(g, lens)


SCENARIOS = ("S1", "S2", "S3", "S4")


def generate_profile(scenario: str, T: int, platform, J: int = 48,
                     seed: int = 0, perturb: float = 0.1,
                     work_capacity: int | None = None) -> PowerProfile:
    """Paper §6.1 profiles: S1 x^2-bump, S2 midday-shifted, S3 sin, S4 const.

    Budgets span ``[idle, idle + 0.8 * work_capacity]`` so that scheduling
    decisions matter (paper's rationale). ``work_capacity`` defaults to the
    platform's total work power; benchmarks pass the workload's ASAP peak
    draw instead, which reproduces the paper's tightness on scaled-down
    matrices.
    """
    rng = np.random.default_rng(seed)
    J = min(J, T)
    bounds = np.round(np.linspace(0, T, J + 1)).astype(np.int64)
    bounds = np.unique(bounds)
    J = len(bounds) - 1
    x = (np.arange(J) + 0.5) / J
    if scenario == "S1":
        frac = 1.0 - (2.0 * x - 1.0) ** 2          # parabola peaking mid-day
    elif scenario == "S2":
        xs = (x + 0.5) % 1.0                        # same, starting from midday
        frac = 1.0 - (2.0 * xs - 1.0) ** 2
    elif scenario == "S3":
        frac = 0.5 * (1.0 + np.sin(2.0 * np.pi * x - 0.5 * np.pi))
    elif scenario == "S4":
        frac = np.full(J, 0.55)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    frac = np.clip(frac + rng.normal(0.0, perturb, size=J), 0.0, 1.0)
    idle = platform.idle_total
    work_total = int(platform.p_work.sum()) if work_capacity is None \
        else int(work_capacity)
    budget = (idle + np.round(frac * 0.8 * work_total)).astype(np.int64)
    return PowerProfile(bounds=bounds, budget=budget, scenario=scenario)


# ---------------------------------------------------------------------------
# Cost oracles
# ---------------------------------------------------------------------------

def schedule_cost(inst: Instance, profile: PowerProfile,
                  start: np.ndarray) -> int:
    """Exact total carbon cost, polynomial subinterval sweep (Appendix A.1).

    Breakpoints = interval bounds + every task start/end; the active work
    power is constant between consecutive breakpoints.
    """
    start = np.asarray(start, dtype=np.int64)
    end = start + inst.dur
    pts = np.concatenate([profile.bounds, start, end])
    pts = np.unique(np.clip(pts, 0, profile.T))
    # work power delta encoding
    deltas = np.zeros(len(pts), dtype=np.int64)
    si = np.searchsorted(pts, np.minimum(start, profile.T))
    ei = np.searchsorted(pts, np.minimum(end, profile.T))
    np.add.at(deltas, si, inst.task_work)
    np.add.at(deltas, ei, -inst.task_work)
    power = np.cumsum(deltas)[:-1]                       # per segment
    seg_len = np.diff(pts)
    g = profile.effective(inst.idle_total)
    seg_budget = g[np.searchsorted(profile.bounds, pts[:-1], side="right") - 1]
    return int((seg_len * np.maximum(power - seg_budget, 0)).sum())


def work_timeline(inst: Instance, T: int, start: np.ndarray) -> np.ndarray:
    """Per-time-unit total active work power, shape [T] (pseudo-polynomial)."""
    start = np.asarray(start, dtype=np.int64)
    deltas = np.zeros(T + 1, dtype=np.int64)
    s = np.clip(start, 0, T)
    e = np.clip(start + inst.dur, 0, T)
    np.add.at(deltas, s, inst.task_work)
    np.add.at(deltas, e, -inst.task_work)
    return np.cumsum(deltas[:-1])


def cost_timeline(inst: Instance, profile: PowerProfile,
                  start: np.ndarray) -> int:
    """Exact cost via the per-unit timeline (cross-check oracle)."""
    P = work_timeline(inst, profile.T, start)
    g = profile.unit_budget(inst.idle_total)
    return int(np.maximum(P - g, 0).sum())


def validate_schedule(inst: Instance, profile: PowerProfile,
                      start: np.ndarray) -> None:
    """Assert precedence + deadline feasibility of a schedule."""
    start = np.asarray(start, dtype=np.int64)
    end = start + inst.dur
    assert (start >= 0).all(), "negative start time"
    assert (end <= profile.T).all(), "deadline violated"
    u = np.repeat(np.arange(inst.num_tasks),
                  np.diff(inst.succ_ptr))
    v = inst.succ_idx
    assert (start[v] >= end[u]).all(), "precedence violated"

