"""Earliest/latest start times on G_c (paper §5.1/§5.2).

Numpy Kahn-style propagation (the paper's algorithm, the reference).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dag import Instance


def compute_est(inst: Instance, start_fixed: np.ndarray | None = None,
                fixed_mask: np.ndarray | None = None) -> np.ndarray:
    """EST(v) = max over preds (EST(u) + dur(u)); fixed tasks pin their start."""
    est = np.zeros(inst.num_tasks, dtype=np.int64)
    for v in inst.topo:
        ps = inst.preds(v)
        if len(ps):
            est[v] = int((est[ps] + inst.dur[ps]).max())
        if fixed_mask is not None and fixed_mask[v]:
            est[v] = start_fixed[v]
    return est


def compute_lst(inst: Instance, T: int, start_fixed: np.ndarray | None = None,
                fixed_mask: np.ndarray | None = None) -> np.ndarray:
    """LST(v) = min over succs LST(s) - dur(v); init T - dur(v)."""
    lst = T - inst.dur
    for v in inst.topo[::-1]:
        ss = inst.succs(v)
        if len(ss):
            lst[v] = min(int(lst[ss].min() - inst.dur[v]), int(lst[v]))
        if fixed_mask is not None and fixed_mask[v]:
            lst[v] = start_fixed[v]
    return lst


def asap_schedule(inst: Instance) -> np.ndarray:
    """The ASAP baseline (paper §5.1): start every task at its EST.

    Served on the Planner's solver axis as ``PlanRequest(solver="asap")``
    (:class:`repro_torch.core.solvers.AsapSolver`, the regression floor of the
    heuristics-vs-baseline-vs-exact evaluation)."""
    return compute_est(inst)


def makespan(inst: Instance, start: np.ndarray) -> int:
    return int((np.asarray(start) + inst.dur).max())


# ---------------------------------------------------------------------------
# Incremental worklist updates used inside the greedy (paper: "updates have
# to be made possibly for the whole graph ... O(n + |E_c|)"). We propagate
# only where values actually change, which is equivalent but cheaper.
# ---------------------------------------------------------------------------

def raise_est_from(inst: Instance, est: np.ndarray, v: int,
                   new_start: int, scheduled: np.ndarray) -> None:
    """Pin task v's start and push the EST increase through its successors."""
    if new_start > est[v]:
        est[v] = new_start
    work = [v]
    while work:
        u = work.pop()
        ready = est[u] + inst.dur[u]
        for s in inst.succs(u):
            if ready > est[s]:
                est[s] = ready
                if not scheduled[s]:
                    work.append(int(s))


def lower_lst_from(inst: Instance, lst: np.ndarray, v: int,
                   new_start: int, scheduled: np.ndarray) -> None:
    """Pin task v's start and push the LST decrease through its predecessors."""
    if new_start < lst[v]:
        lst[v] = new_start
    work = [v]
    while work:
        u = work.pop()
        for p in inst.preds(u):
            bound = lst[u] - inst.dur[p]
            if bound < lst[p]:
                lst[p] = bound
                if not scheduled[p]:
                    work.append(int(p))

