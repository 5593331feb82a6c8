"""Uniprocessor dynamic programs (paper §4.1, Appendix A.2).

* :func:`dp_pseudo` — the pseudo-polynomial DP over all t in [0, T]
  (Eq. (1)); oracle for tests.
* :func:`dp_poly` — the fully polynomial DP restricted to the E'-schedule
  end-time set of size O(n^3 J) (Lemma 4.2).

Both return (optimal cost, optimal start times). The instance must map all
tasks on one processor; the fixed order is the processor chain.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import Instance


def is_uniprocessor(inst: Instance) -> bool:
    """True when the fixed mapping is one processor chain covering every
    task AND all tasks share one work power — the §4.1 DP regime (the
    DP's cost prefix assumes a single active draw; a one-processor
    mapping gives uniform work by construction, the explicit check only
    guards hand-built instances). The dispatch test of ``solver="exact"``
    (:class:`repro_torch.core.solvers.ExactSolver`): DP here, ILP otherwise."""
    chains = [c for c in inst.proc_chains if len(c)]
    if len(chains) != 1 or len(chains[0]) != inst.num_tasks:
        return False
    w = inst.task_work
    return bool((w == w[0]).all()) if len(w) else True


def _chain(inst: Instance) -> np.ndarray:
    if not is_uniprocessor(inst):
        raise ValueError("dp_uniproc requires a single processor chain "
                         "covering every task with one shared work power "
                         "(see is_uniprocessor)")
    return np.asarray([c for c in inst.proc_chains if len(c)][0],
                      dtype=np.int64)


def _unit_task_cost(inst: Instance, profile: PowerProfile) -> np.ndarray:
    """prefix[t] = cost of one active task during [0, t) (single processor)."""
    w = int(inst.task_work.max())
    assert (inst.task_work == w).all(), "single processor => single work power"
    g = profile.unit_budget(inst.idle_total)
    per_unit = np.maximum(w - g, 0)
    return np.concatenate([[0], np.cumsum(per_unit)])


def dp_pseudo(inst: Instance, profile: PowerProfile):
    """Pseudo-polynomial DP (Eq. (1)): Opt(i, t), t in [0, T]."""
    chain = _chain(inst)
    T = profile.T
    pref = _unit_task_cost(inst, profile)
    INF = np.iinfo(np.int64).max // 4

    durs = inst.dur[chain]
    n = len(chain)
    # opt[t] = best cost with tasks 0..i-1 done, task i-1 ending exactly at t
    prev = np.zeros(T + 1, dtype=np.int64)       # virtual task 0 ends anywhere
    prev_min = np.zeros(T + 1, dtype=np.int64)   # prefix-min over end times
    choice = np.full((n, T + 1), -1, dtype=np.int64)
    for i in range(n):
        w = int(durs[i])
        cur = np.full(T + 1, INF, dtype=np.int64)
        t = np.arange(int(durs[:i + 1].sum()), T + 1)
        if len(t):
            cc = pref[t] - pref[t - w]
            best_prev = prev_min[t - w]
            cur[t] = np.where(best_prev >= INF, INF, best_prev + cc)
        # argmin bookkeeping: earliest prefix-min position
        pos = np.zeros(T + 1, dtype=np.int64)
        best = prev[0]
        b_at = 0
        for tt in range(T + 1):
            if prev[tt] < best:
                best = prev[tt]
                b_at = tt
            pos[tt] = b_at
        if len(t):
            choice[i, t] = pos[t - w]
        prev = cur
        prev_min = np.minimum.accumulate(cur)
    best_t = int(np.argmin(prev))
    best_cost = int(prev[best_t])
    assert best_cost < INF, "infeasible deadline"
    # backtrack
    start = np.zeros(inst.num_tasks, dtype=np.int64)
    t = best_t
    for i in range(n - 1, -1, -1):
        v = int(chain[i])
        start[v] = t - int(durs[i])
        t = int(choice[i, t])
    return best_cost, start


def _candidate_end_times(inst: Instance, profile: PowerProfile,
                         chain: np.ndarray) -> list[np.ndarray]:
    """Appendix A.2: E'-aligned candidate end times per task, O(n^2 J) each."""
    T = profile.T
    E = profile.bounds
    durs = inst.dur[chain]
    n = len(chain)
    pref = np.concatenate([[0], np.cumsum(durs)])
    cands: list[set[int]] = [set() for _ in range(n)]
    for r in range(n):
        for s in range(r, n):
            # block chain[r..s]; u in block ends at:
            #   block starts at e: e + (pref[u+1] - pref[r])
            #   block ends at e:   e - (pref[s+1] - pref[u+1])
            for u in range(r, s + 1):
                off_s = int(pref[u + 1] - pref[r])
                off_e = int(pref[s + 1] - pref[u + 1])
                for e in E:
                    for t in (int(e) + off_s, int(e) - off_e):
                        if int(durs[u]) <= t <= T:
                            cands[u].add(t)
    return [np.asarray(sorted(c), dtype=np.int64) for c in cands]


def dp_poly(inst: Instance, profile: PowerProfile):
    """Fully polynomial DP over the restricted end-time set E' (Lemma 4.2)."""
    chain = _chain(inst)
    T = profile.T
    pref = _unit_task_cost(inst, profile)
    INF = np.iinfo(np.int64).max // 4
    durs = inst.dur[chain]
    n = len(chain)
    ends = _candidate_end_times(inst, profile, chain)

    prev_t = np.asarray([0], dtype=np.int64)     # end times of "task -1"
    prev_c = np.asarray([0], dtype=np.int64)
    back: list[np.ndarray] = []
    for i in range(n):
        w = int(durs[i])
        t = ends[i]
        # prefix-min of prev costs over non-decreasing end time
        pm = np.minimum.accumulate(prev_c)
        # earliest index achieving each prefix-min (for backtracking)
        arg = np.zeros(len(prev_c), dtype=np.int64)
        bi = 0
        for j in range(1, len(prev_c)):
            if prev_c[j] < prev_c[bi]:
                bi = j
            arg[j] = bi
        k = np.searchsorted(prev_t, t - w, side="right") - 1
        ok = k >= 0
        cost = np.full(len(t), INF, dtype=np.int64)
        cc = pref[t] - pref[t - w]
        cost[ok] = pm[k[ok]] + cc[ok]
        back.append(np.where(ok, arg[np.maximum(k, 0)], -1))
        keep = cost < INF
        prev_t, prev_c = t[keep], cost[keep]
        back[-1] = back[-1][keep]
        ends[i] = t[keep]
        if len(prev_t) == 0:
            raise ValueError("infeasible deadline")
    bi = int(np.argmin(prev_c))
    best_cost = int(prev_c[bi])
    start = np.zeros(inst.num_tasks, dtype=np.int64)
    idx = bi
    for i in range(n - 1, -1, -1):
        v = int(chain[i])
        start[v] = int(ends[i][idx]) - int(durs[i])
        idx = int(back[i][idx])
    return best_cost, start
