"""Exact time-indexed ILP (paper §4.3 / Appendix A.4), solved with HiGHS.

Variables: binary start indicators ``s[v,t]`` (t in [0, T - w_v]) and
continuous brown-power ``bu[t] >= 0``. The paper's ``e``/``r``/``alpha``
variables and Big-M machinery are eliminated without changing the integer
optimum:

* running indicator  r(v,t) = sum_{tau in (t-w_v, t]} s[v,tau]  (linear);
* ``bu_t >= gamma_t - G_t`` with a min-objective pins bu_t to
  max(0, gamma_t - G_t) at any optimum, so no alpha/epsilon/M is needed;
* precedence uses the aggregated start-time form
  sum_t t*s[v,t] >= sum_t (t + w_u)*s[u,t], valid and integral-equivalent
  (weaker LP bound, dramatically fewer nonzeros than Eq. (12)).

Paper's own scope note applies: exact solves are only run on small
instances (<= ~200 tasks).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.optimize import LinearConstraint, milp

from repro_torch import obs
from repro_torch.core.cancel import checkpoint
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import Instance


@dataclasses.dataclass
class ILPResult:
    cost: float
    start: np.ndarray
    status: int
    message: str
    # HiGHS dual bound: a valid lower bound on the optimal cost even when
    # the solve exits on time_limit/mip_gap; == cost at a proven optimum.
    lower_bound: float = float("-inf")
    mip_gap: float = float("nan")


def solve_ilp(inst: Instance, profile: PowerProfile,
              time_limit: float = 300.0, mip_gap: float = 0.0,
              cancel=None) -> ILPResult:
    # Cooperative cancellation: scipy's milp wrapper exposes no HiGHS
    # interrupt callback, so an in-flight MILP cannot be stopped from
    # outside — the token's deadline therefore CLAMPS time_limit before
    # the solve starts (the solve can never outlive the budget by more
    # than HiGHS's limit-check granularity), and the model build below
    # polls the token between row families.
    checkpoint(cancel)
    if cancel is not None and cancel.deadline is not None:
        time_limit = min(float(time_limit),
                         max(cancel.remaining() or 0.0, 0.1))
    build_span = obs.start_span("ilp_build", N=int(inst.num_tasks),
                                T=int(profile.T))
    try:
        return _build_and_solve(inst, profile, cancel, build_span,
                                time_limit, mip_gap)
    finally:
        build_span.end()      # idempotent: normal path already ended it


def _build_and_solve(inst: Instance, profile: PowerProfile, cancel,
                     build_span, time_limit: float,
                     mip_gap: float) -> ILPResult:
    N = inst.num_tasks
    T = profile.T
    dur = inst.dur
    w = inst.task_work.astype(np.float64)
    g_unit = profile.unit_budget(inst.idle_total).astype(np.float64)

    # variable layout: s[v, t] for t in [0, T - dur_v]  |  bu[t]
    offs = np.zeros(N + 1, dtype=np.int64)
    for v in range(N):
        n_t = T - int(dur[v]) + 1
        if n_t <= 0:
            raise ValueError("task longer than horizon")
        offs[v + 1] = offs[v] + n_t
    n_s = int(offs[N])
    n_var = n_s + T

    def svar(v: int, t: int) -> int:
        return int(offs[v]) + t

    rows, cols, vals = [], [], []
    lo, hi = [], []
    r = 0

    # (5)-(6): each task starts exactly once, in time
    for v in range(N):
        for t in range(T - int(dur[v]) + 1):
            rows.append(r); cols.append(svar(v, t)); vals.append(1.0)
        lo.append(1.0); hi.append(1.0)
        r += 1

    # precedence (aggregated start-time form), one row per edge of G_c
    checkpoint(cancel)
    for v in range(N):
        for u in inst.preds(v):
            u = int(u)
            for t in range(T - int(dur[v]) + 1):
                rows.append(r); cols.append(svar(v, t)); vals.append(float(t))
            for t in range(T - int(dur[u]) + 1):
                rows.append(r); cols.append(svar(u, t))
                vals.append(-float(t + int(dur[u])))
            lo.append(0.0); hi.append(np.inf)
            r += 1

    # power rows: bu_t - sum_v w_v * r(v,t) >= -g_unit[t]
    checkpoint(cancel)
    for t in range(T):
        rows.append(r); cols.append(n_s + t); vals.append(1.0)
        for v in range(N):
            if w[v] == 0:
                continue
            t_lo = max(0, t - int(dur[v]) + 1)
            t_hi = min(t, T - int(dur[v]))
            for tau in range(t_lo, t_hi + 1):
                rows.append(r); cols.append(svar(v, tau)); vals.append(-w[v])
        lo.append(-float(g_unit[t])); hi.append(np.inf)
        r += 1

    checkpoint(cancel)                    # last poll before the MILP
    A = sp.csr_matrix((vals, (rows, cols)), shape=(r, n_var))
    c = np.concatenate([np.zeros(n_s), np.ones(T)])
    integrality = np.concatenate([np.ones(n_s), np.zeros(T)])
    bounds_lo = np.zeros(n_var)
    bounds_hi = np.concatenate([np.ones(n_s), np.full(T, np.inf)])
    build_span.end(rows=int(r), n_var=int(n_var), nnz=len(vals))

    with obs.span("ilp_milp", N=int(N), T=int(T), rows=int(r),
                  time_limit=round(time_limit, 3)) as milp_span:
        res = milp(
            c,
            constraints=LinearConstraint(A, np.asarray(lo), np.asarray(hi)),
            integrality=integrality,
            bounds=(bounds_lo, bounds_hi),
            options={"time_limit": time_limit, "mip_rel_gap": mip_gap},
        )
        milp_span.set(status=int(res.status))
    obs.registry().counter(
        "ilp_solves_total", "HiGHS MILP solves, by exit status",
        labels=("status",)).inc(status=int(res.status))
    dual = getattr(res, "mip_dual_bound", None)
    gap = getattr(res, "mip_gap", None)
    if res.x is None:
        return ILPResult(cost=np.inf, start=np.zeros(N, dtype=np.int64),
                         status=res.status, message=res.message,
                         lower_bound=float(dual) if dual is not None
                         else float("-inf"),
                         mip_gap=float(gap) if gap is not None
                         else float("nan"))
    x = res.x[:n_s]
    start = np.zeros(N, dtype=np.int64)
    for v in range(N):
        seg = x[offs[v]:offs[v + 1]]
        start[v] = int(np.argmax(seg))
    # a proven optimum (status 0, no gap slack) certifies bound == cost
    lb = float(dual) if dual is not None else (
        float(res.fun) if res.status == 0 else float("-inf"))
    return ILPResult(cost=float(res.fun), start=start, status=res.status,
                     message=res.message, lower_bound=lb,
                     mip_gap=float(gap) if gap is not None
                     else float("nan"))
