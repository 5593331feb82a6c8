"""CaWoSched greedy scheduler (paper §5.2), paper-faithful numpy path.

Processes tasks in score order; each task starts at the beginning of the
feasible (refined) interval with the highest remaining green budget
(earliest on ties), budgets are decremented where the task runs, intervals
are split at the task's endpoints, and EST/LST of unscheduled tasks are
updated through the DAG.

Two interval representations, bit-identical by construction (and by test):

* :func:`greedy_schedule` — per-unit timelines: ``rem[t]`` = remaining
  effective budget at time ``t`` and a candidate-start mask over ``[0, T]``.
  O(T) per task; the pseudo-polynomial reference.
* :func:`greedy_schedule_segments` — the paper's actual data structure: a
  sorted breakpoint list (candidate points) with the budget value of the
  segment starting at each point. Budgets are constant between breakpoints
  (profile bounds and all task endpoints are breakpoints), so placement is
  an argmax over the breakpoints inside ``[EST, LST]`` and a task placement
  inserts its two endpoints and decrements the covered breakpoints —
  O((n + |E|)·log + |candidates in window|) instead of O(n·T). This is the
  big-horizon fast path the portfolio engine uses.
"""
from __future__ import annotations

import numpy as np

from repro_torch.cluster import Platform
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import Instance
from repro_torch.core.estlst import (
    compute_est,
    compute_lst,
    lower_lst_from,
    raise_est_from,
)
from repro_torch.core.scores import task_order
from repro_torch.core.subdivide import candidate_mask


def greedy_schedule(inst: Instance, profile: PowerProfile, platform: Platform,
                    score: str = "press", weighted: bool = False,
                    refined: bool = False, k: int = 3) -> np.ndarray:
    """Compute a greedy carbon-aware schedule. Returns start times [N]."""
    T = profile.T
    est = compute_est(inst)
    lst = compute_lst(inst, T)
    if (est > lst).any():
        raise ValueError("infeasible: deadline below ASAP makespan")

    order = task_order(inst, est, lst, score, weighted, platform)
    mask = candidate_mask(inst, profile, refined=refined, k=k)
    rem = profile.unit_budget(inst.idle_total).astype(np.int64).copy()

    start = np.zeros(inst.num_tasks, dtype=np.int64)
    scheduled = np.zeros(inst.num_tasks, dtype=bool)

    for v in order:
        a, b = int(est[v]), int(lst[v])
        cand = np.flatnonzero(mask[a:b + 1])
        if len(cand) == 0:
            s = a
        else:
            cand = cand + a
            # budget of the interval starting at candidate point t is rem[t];
            # argmax returns the first (earliest) maximum — the paper's tie
            # break.
            s = int(cand[np.argmax(rem[cand])])
        e = s + int(inst.dur[v])
        start[v] = s
        scheduled[v] = True
        # decrement budgets where the task runs; its endpoints split the
        # intervals, becoming candidate start points for later tasks.
        rem[s:e] -= int(inst.task_work[v])
        mask[s] = True
        if e <= T:
            mask[e] = True
        raise_est_from(inst, est, int(v), s, scheduled)
        lower_lst_from(inst, lst, int(v), s, scheduled)

    return start


def segment_state(inst: Instance, profile: PowerProfile,
                  refined: bool = False, k: int = 3, mask=None):
    """Initial (breakpoints, values) of the segment timeline.

    Breakpoints are exactly the candidate-mask points; the value at point
    ``p`` is the effective budget of the unit at ``p`` (constant on the
    segment up to the next breakpoint). ``mask`` optionally reuses a
    precomputed candidate mask (the profile overlay's bounds-keyed cache).
    """
    if mask is None:
        mask = candidate_mask(inst, profile, refined=refined, k=k)
    pts = np.flatnonzero(mask).astype(np.int64)
    g = profile.effective(inst.idle_total).astype(np.int64)
    seg = np.clip(np.searchsorted(profile.bounds, pts, side="right") - 1,
                  0, profile.J - 1)
    return pts, g[seg]


def adjacency_lists(inst: Instance) -> tuple[list[list[int]], list[list[int]]]:
    """(successor, predecessor) python adjacency — fast worklist iteration."""
    succ_l = [inst.succs(v).tolist() for v in range(inst.num_tasks)]
    pred_l = [inst.preds(v).tolist() for v in range(inst.num_tasks)]
    return succ_l, pred_l


def greedy_core_segments(inst: Instance, T: int, est: np.ndarray,
                         lst: np.ndarray, order: np.ndarray,
                         pts0: np.ndarray, vals0: np.ndarray,
                         adj: tuple[list[list[int]], list[list[int]]]
                         | None = None) -> np.ndarray:
    """Segment-list greedy over precomputed state (portfolio fast path).

    Inputs are not mutated (EST/LST evolve on private copies), so a
    :class:`~repro_torch.core.portfolio.PreparedInstance` can hand the same arrays
    to every variant. Bit-identical to :func:`greedy_schedule`; the EST/LST
    worklist updates are the reference's, inlined over python adjacency.
    """
    N = inst.num_tasks
    cap = len(pts0) + 2 * N
    pts = np.empty(cap, dtype=np.int64)
    vals = np.empty(cap, dtype=np.int64)
    m = len(pts0)
    pts[:m] = pts0
    vals[:m] = vals0

    succ_l, pred_l = adj or adjacency_lists(inst)
    dur = inst.dur.tolist()
    work = inst.task_work.tolist()
    est_l = [int(x) for x in est]
    lst_l = [int(x) for x in lst]
    start = np.zeros(N, dtype=np.int64)
    scheduled = [False] * N
    searchsorted = np.searchsorted

    for v in order:
        v = int(v)
        a, b = est_l[v], lst_l[v]
        i0 = int(searchsorted(pts[:m], a))
        i1 = int(searchsorted(pts[:m], b, side="right"))
        if i0 == i1:
            s = a
            js = i0                                 # insertion slot of s
            s_present = False
        else:
            # budget of the interval starting at breakpoint p is vals[p];
            # argmax returns the first (earliest) maximum — the paper's tie
            # break.
            js = i0 + int(np.argmax(vals[i0:i1]))
            s = int(pts[js])
            s_present = True
        e = s + dur[v]
        start[v] = s
        scheduled[v] = True
        # the task's endpoints split their intervals (e only inside the
        # horizon), then every breakpoint it covers loses its work power.
        if not s_present:
            pts[js + 1:m + 1] = pts[js:m]           # overlap-safe right shift
            vals[js + 1:m + 1] = vals[js:m]
            pts[js] = s
            vals[js] = vals[js - 1] if js > 0 else 0   # pts[0]==0 covers s
            m += 1
        if e <= T:
            je = js + int(searchsorted(pts[js:m], e))
            if je == m or pts[je] != e:
                pts[je + 1:m + 1] = pts[je:m]
                vals[je + 1:m + 1] = vals[je:m]
                pts[je] = e
                vals[je] = vals[je - 1]             # je > js >= 0
                m += 1
        else:
            je = m - 1                              # pts[m-1] == T always
        vals[js:je] -= work[v]
        # pin v and propagate EST up / LST down (== raise_est_from /
        # lower_lst_from on the reference path, over python adjacency)
        if s > est_l[v]:
            est_l[v] = s
        stack = [v]
        while stack:
            u = stack.pop()
            ready = est_l[u] + dur[u]
            for t in succ_l[u]:
                if ready > est_l[t]:
                    est_l[t] = ready
                    if not scheduled[t]:
                        stack.append(t)
        if s < lst_l[v]:
            lst_l[v] = s
        stack = [v]
        while stack:
            u = stack.pop()
            lu = lst_l[u]
            for t in pred_l[u]:
                bound = lu - dur[t]
                if bound < lst_l[t]:
                    lst_l[t] = bound
                    if not scheduled[t]:
                        stack.append(t)

    return start


def greedy_schedule_segments(inst: Instance, profile: PowerProfile,
                             platform: Platform, score: str = "press",
                             weighted: bool = False, refined: bool = False,
                             k: int = 3) -> np.ndarray:
    """Segment-list greedy; same contract (and output) as
    :func:`greedy_schedule`."""
    T = profile.T
    est = compute_est(inst)
    lst = compute_lst(inst, T)
    if (est > lst).any():
        raise ValueError("infeasible: deadline below ASAP makespan")
    order = task_order(inst, est, lst, score, weighted, platform)
    pts0, vals0 = segment_state(inst, profile, refined=refined, k=k)
    return greedy_core_segments(inst, T, est, lst, order, pts0, vals0)
