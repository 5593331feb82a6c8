"""Earliest/latest start times on G_c (paper §5.1/§5.2).

Two implementations:
  * numpy Kahn-style propagation (the paper's algorithm, the reference);
  * a level-synchronous edge relaxation on a device (:func:`est_lst_torch`,
    the counterpart of the reference's ``est_lst_jnp``): topological
    levels are bucketed once on the host, then one scatter-max (EST) or
    scatter-min (LST) per level relaxes all edges of that level at once.
"""
from __future__ import annotations

import numpy as np
import torch

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



# ---------------------------------------------------------------------------
# torch level-synchronous relaxation
# ---------------------------------------------------------------------------

def _level_buckets(level: np.ndarray, u: np.ndarray, v: np.ndarray,
                   n_levels: int):
    """Edges ``(u, v)`` grouped by ``level`` (one row per level), each row
    padded to the widest bucket with invalid ``(0, 0)`` edges."""
    order = np.argsort(level, kind="stable")
    u_s, v_s = u[order], v[order]
    counts = np.bincount(level, minlength=n_levels)
    width = int(counts.max(initial=1))
    eu = np.zeros((n_levels, width), dtype=np.int64)
    ev = np.zeros((n_levels, width), dtype=np.int64)
    valid = np.zeros((n_levels, width), dtype=bool)
    off = 0
    for lvl in range(n_levels):
        c = counts[lvl]
        eu[lvl, :c] = u_s[off:off + c]
        ev[lvl, :c] = v_s[off:off + c]
        valid[lvl, :c] = True
        off += c
    return eu, ev, valid


def est_lst_torch(inst: Instance, T: int, *, device=None):
    """EST/LST on a device: one scatter-max/min per topological level.

    Returns ``(est, lst)`` as int32 tensors. Edges are bucketed by the
    target's level (EST) and, in reverse level order, by the source's level
    (LST); the padded ``(0, 0)`` edges relax slot 0 with ``0`` (EST) or
    ``big`` (LST), which the old value (included in the reduction) always
    dominates, so they leave the result unchanged.
    """
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    N = inst.num_tasks
    u = np.repeat(np.arange(N), np.diff(inst.succ_ptr))
    v = inst.succ_idx.copy()
    n_levels = int(inst.level.max(initial=0)) + 1
    dur = torch.as_tensor(inst.dur.astype(np.int32), device=dev)

    def tensors(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    eu, ev, valid = tensors(*_level_buckets(inst.level[v], u, v, n_levels))
    est = torch.zeros(N, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for lvl in range(n_levels):
        cand = torch.where(valid[lvl], est[eu[lvl]] + dur[eu[lvl]], zero)
        est.scatter_reduce_(0, ev[lvl], cand, "amax", include_self=True)

    fu, fv, fvalid = tensors(*_level_buckets(
        n_levels - 1 - inst.level[u], u, v, n_levels))
    big = torch.tensor(np.iinfo(np.int32).max // 4, dtype=torch.int32,
                       device=dev)
    lst = torch.as_tensor((T - inst.dur).astype(np.int32), device=dev)
    for lvl in range(n_levels):
        cand = torch.where(fvalid[lvl], lst[fv[lvl]] - dur[fu[lvl]], big)
        lst.scatter_reduce_(0, fu[lvl], cand, "amin", include_self=True)
    return est, lst
