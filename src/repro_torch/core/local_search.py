"""Local search (paper §5.3): hill-climbing task shifts of up to ±mu units.

Numpy reference implements the paper exactly: processors in non-increasing
P_work order, tasks left-to-right per processor, candidate new starts
scanned earliest-to-latest, *first* improving legal move applied, rounds
until a full gainless round.

The implementation is round-batched but *bit-identical* to the scalar
reference (tests assert equality): at the head of each round, one vectorized
pass (:func:`_batch_proposals`) computes every task's first improving legal
shift against the round-start timeline — all ±mu gains fall out of four
prefix sums over released/incurred unit contributions around each task's
start and end, the same integer arithmetic as :func:`move_gain`. The
sequential visit then commits a task's cached proposal only while it is
provably fresh: a commit dirties the touched time window and marks the task
moved, and any later task whose ±mu window intersects a dirty interval — or
that has a moved DAG neighbour (legal bounds changed) — is re-evaluated
exactly (:func:`_first_improving`). Commits are rare after the first rounds,
so almost every visit is a cache hit; this is what makes the 17-variant
portfolio engine fast on CPU.

Legality of a move uses the current schedule: the new execution window must
respect the current start times of DAG neighbours (which include the fixed
per-processor chains) and the deadline.

`repro_torch.core.local_search_torch` provides the batched device version that
uses the CUDA gain-sweep kernel as a move proposer and this module's
`move_gain`/`apply_move` arithmetic for exact commits.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.carbon import PowerProfile, work_timeline
from repro_torch.core.dag import Instance


def dyn_bounds(inst: Instance, start: np.ndarray, v: int,
               T: int) -> tuple[int, int]:
    """Legal start-time range of task v given the rest of the schedule."""
    lo, hi = 0, T - int(inst.dur[v])
    ps = inst.preds(v)
    if len(ps):
        lo = max(lo, int((start[ps] + inst.dur[ps]).max()))
    ss = inst.succs(v)
    if len(ss):
        hi = min(hi, int(start[ss].min()) - int(inst.dur[v]))
    return lo, hi


def move_gain(rem: np.ndarray, s: int, e: int, new_s: int, w: int) -> int:
    """Exact cost gain of moving a task from [s,e) to [new_s,new_s+e-s).

    ``rem`` is the remaining-budget timeline *including* the task at its old
    position. Positive gain = cost decreases. Only the symmetric difference
    of the two windows contributes.
    """
    d = new_s - s
    if d == 0:
        return 0
    ln = min(abs(d), e - s)
    if d > 0:
        vac_lo, vac_hi = s, s + ln              # vacated units
        occ_hi = new_s + (e - s)                # newly occupied units
        occ_lo = occ_hi - ln
    else:
        vac_lo, vac_hi = e - ln, e
        occ_lo, occ_hi = new_s, new_s + ln
    # cost released on vacated units: deficit drops by up to w
    rv = rem[vac_lo:vac_hi]
    released = np.minimum(np.maximum(-rv, 0), w).sum()
    # cost incurred on newly occupied units
    ro = rem[occ_lo:occ_hi]
    incurred = np.minimum(np.maximum(w - np.maximum(ro, 0), 0), w).sum()
    return int(released - incurred)


def apply_move(rem: np.ndarray, s: int, e: int, new_s: int, w: int) -> None:
    """Update the remaining-budget timeline for the move."""
    rem[s:e] += w
    rem[new_s:new_s + (e - s)] -= w


def _first_improving(rem_pad, pad, s, e, dur, w, lo, hi, mu, dpos, dneg):
    """Earliest improving legal shift of the task at [s, e), or None.

    Bit-identical to scanning ``new_s = lo..hi`` ascending with
    :func:`move_gain`: the released/incurred unit contributions around the
    start and end are prefix-summed once, giving every shift's exact integer
    gain; the first positive one wins. ``rem_pad`` is the remaining-budget
    timeline padded by ``pad >= mu`` zeros on both sides (zero padding
    contributes 0 released — matching the reference's silent slice clipping —
    and out-of-horizon incurred units only arise for illegal shifts).
    """
    m1 = min(mu, dur)
    o = pad
    rel_s = np.minimum(np.maximum(-rem_pad[o + s:o + s + m1], 0), w)
    inc_e = np.minimum(np.maximum(
        w - np.maximum(rem_pad[o + e:o + e + mu], 0), 0), w)
    rel_e = np.minimum(np.maximum(-rem_pad[o + e - m1:o + e], 0), w)
    inc_s = np.minimum(np.maximum(
        w - np.maximum(rem_pad[o + s - mu:o + s], 0), 0), w)
    pr_s = np.concatenate(([0], np.cumsum(rel_s)))
    pi_e = np.concatenate(([0], np.cumsum(inc_e)))
    pr_e = np.concatenate(([0], np.cumsum(rel_e)))
    pi_s = np.concatenate(([0], np.cumsum(inc_s)))

    g = np.empty(2 * mu + 1, dtype=np.int64)
    ln_p = np.minimum(dpos, dur)                  # shift right by dpos
    g[mu + 1:] = pr_s[ln_p] - (pi_e[dpos] - pi_e[dpos - ln_p])
    ln_n = np.minimum(-dneg, dur)                 # shift left by -dneg
    g[:mu] = (pr_e[m1] - pr_e[m1 - ln_n]) \
        - (pi_s[mu + dneg + ln_n] - pi_s[mu + dneg])
    g[mu] = 0

    lo_i = lo - s + mu                            # legal window in delta grid
    hi_i = hi - s + mu
    window = g[lo_i:hi_i + 1] > 0
    if lo_i <= mu <= hi_i:
        window[mu - lo_i] = False                 # delta == 0
    j = int(np.argmax(window))
    if not window[j]:
        return None
    return s + (lo_i + j - mu), int(g[lo_i + j])


def _batch_proposals(rem_pad, pad, start, dur, work, lo, hi, mu, T):
    """Every task's first improving legal shift vs the current timeline.

    Vectorized over (task, shift): same prefix-sum identities as
    :func:`_first_improving`, all tasks at once. Returns (proposal, fresh):
    ``proposal[v]`` = first improving new start (or -1 = none), ``fresh[v]``
    False marks rows the batch could not evaluate (out-of-horizon tasks).
    """
    N = len(start)
    s = start
    e = start + dur
    okrow = e <= T                      # out-of-horizon rows -> scalar path
    m1 = np.minimum(mu, dur)
    j = np.arange(mu)[None, :]
    top = rem_pad.shape[0] - 1

    win = rem_pad[np.minimum(pad + s[:, None] + j, top)]
    rel_s = np.where(j < m1[:, None],
                     np.minimum(np.maximum(-win, 0), work[:, None]), 0)
    win = rem_pad[np.minimum(pad + e[:, None] + j, top)]
    inc_e = np.minimum(np.maximum(
        work[:, None] - np.maximum(win, 0), 0), work[:, None])
    win = rem_pad[np.minimum(pad + (e - m1)[:, None] + j, top)]
    rel_e = np.where(j < m1[:, None],
                     np.minimum(np.maximum(-win, 0), work[:, None]), 0)
    win = rem_pad[np.maximum(pad + (s - mu)[:, None] + j, 0)]
    inc_s = np.minimum(np.maximum(
        work[:, None] - np.maximum(win, 0), 0), work[:, None])

    z = np.zeros((N, 1), dtype=np.int64)
    pr_s = np.concatenate([z, np.cumsum(rel_s, axis=1)], axis=1)
    pi_e = np.concatenate([z, np.cumsum(inc_e, axis=1)], axis=1)
    pr_e = np.concatenate([z, np.cumsum(rel_e, axis=1)], axis=1)
    pi_s = np.concatenate([z, np.cumsum(inc_s, axis=1)], axis=1)

    g = np.zeros((N, 2 * mu + 1), dtype=np.int64)
    dpos = np.arange(1, mu + 1)[None, :]
    ln_p = np.minimum(dpos, dur[:, None])
    g[:, mu + 1:] = (np.take_along_axis(pr_s, ln_p, 1)
                     - (pi_e[:, 1:] - np.take_along_axis(pi_e, dpos - ln_p, 1)))
    dneg = np.arange(-mu, 0)[None, :]
    ln_n = np.minimum(-dneg, dur[:, None])
    g[:, :mu] = ((np.take_along_axis(pr_e, m1[:, None], 1)
                  - np.take_along_axis(pr_e, m1[:, None] - ln_n, 1))
                 - (np.take_along_axis(pi_s, mu + dneg + ln_n, 1)
                    - pi_s[:, :mu]))

    dgrid = np.arange(-mu, mu + 1)[None, :]
    legal = ((dgrid >= (lo - s)[:, None]) & (dgrid <= (hi - s)[:, None])
             & (dgrid != 0) & (g > 0) & okrow[:, None]
             & (work > 0)[:, None])
    first = np.argmax(legal, axis=1)
    has = legal[np.arange(N), first]
    proposal = np.where(has, s + first - mu, -1)
    return proposal, okrow


def dyn_bounds_all(start, dur, T, edges):
    """Vectorized :func:`dyn_bounds` for every task at once.

    ``edges`` is the ``(v_of_pred, u_pred, u_of_succ, v_succ)`` tuple from
    :func:`ls_context` (shared with the batched device climbers).
    """
    v_of_pred, u_pred, u_of_succ, v_succ = edges
    N = len(start)
    lo = np.zeros(N, dtype=np.int64)
    np.maximum.at(lo, v_of_pred, start[u_pred] + dur[u_pred])
    hi = np.full(N, np.iinfo(np.int64).max // 4, dtype=np.int64)
    np.minimum.at(hi, u_of_succ, start[v_succ])
    hi = np.minimum(hi, T) - dur
    return lo, hi


def ls_graph_context(inst: Instance, platform=None) -> dict:
    """The profile-independent half of :func:`ls_context`.

    A :class:`~repro_torch.core.portfolio.PreparedGraph` computes this once; each
    profile overlay completes it with its own ``unit_budget``. ``platform``
    is optional: a chain's P_work equals the task_work of any of its tasks
    (``task_work[v] == p_work[proc[v]]`` by construction), so the visit
    order is derivable from the instance alone.
    """
    N = inst.num_tasks
    if platform is not None:
        chain_power = platform.p_work[inst.chain_proc_ids]
    else:
        chain_power = np.asarray(
            [inst.task_work[c[0]] for c in inst.proc_chains], dtype=np.int64)
    chain_order = np.argsort(-chain_power, kind="stable")
    return {
        "visit": [int(v) for ci in chain_order
                  for v in inst.proc_chains[ci]],
        "edges": (np.repeat(np.arange(N), np.diff(inst.pred_ptr)),
                  inst.pred_idx,
                  np.repeat(np.arange(N), np.diff(inst.succ_ptr)),
                  inst.succ_idx),
        "nbrs": [inst.preds(v).tolist() + inst.succs(v).tolist()
                 for v in range(N)],
        "work_l": inst.task_work.tolist(),
        "dur_l": inst.dur.tolist(),
    }


def ls_context(inst: Instance, profile: PowerProfile, platform) -> dict:
    """Schedule-independent local-search state, reusable across variants.

    A :class:`~repro_torch.core.portfolio.PreparedInstance` computes this once and
    every ``-LS`` variant's :func:`local_search` call shares it.
    """
    ctx = ls_graph_context(inst, platform)
    ctx["unit_budget"] = profile.unit_budget(inst.idle_total).astype(np.int64)
    return ctx


def local_search(inst: Instance, profile: PowerProfile, platform,
                 start: np.ndarray, mu: int = 10,
                 max_rounds: int | None = None,
                 ctx: dict | None = None) -> np.ndarray:
    """Paper §5.3 local search; returns improved start times.

    ``ctx`` optionally reuses :func:`ls_context` precompute (the portfolio
    engine's amortization); results are identical with or without it.
    """
    T = profile.T
    ctx = ctx or ls_context(inst, profile, platform)
    start = np.asarray(start, dtype=np.int64).copy()
    pad = mu
    rem_pad = np.zeros(T + 2 * pad, dtype=np.int64)
    rem_pad[pad:pad + T] = ctx["unit_budget"] - work_timeline(inst, T, start)

    rounds = 0
    while True:
        any_gain = reference_round(inst, T, rem_pad, pad, start, mu, ctx)
        rounds += 1
        if not any_gain or (max_rounds is not None and rounds >= max_rounds):
            break
    return start


def reference_round(inst: Instance, T: int, rem_pad: np.ndarray, pad: int,
                    start: np.ndarray, mu: int, ctx: dict) -> bool:
    """ONE round of the paper's §5.3 hill climb, in place.

    Exactly the loop body of :func:`local_search` (which delegates here):
    batch-propose every task's first improving legal shift against the
    round-start timeline, then visit tasks in processor order, committing
    fresh proposals and re-evaluating stale ones exactly. Mutates ``start``
    and the timeline behind ``rem_pad``; returns whether any move committed.

    Shared with the batched device climbers
    (:mod:`repro_torch.core.local_search_torch`), whose per-variant
    termination rule is "a reference round commits nothing" — the same
    criterion that ends the sequential climb, so no variant stops while the
    sequential reference could still improve it.
    """
    dur = inst.dur
    work = inst.task_work
    rem = rem_pad[pad:pad + T]                    # writes go through the view
    dpos = np.arange(1, mu + 1)
    dneg = np.arange(-mu, 0)
    # processors visited in non-increasing P_work order (compute + links);
    # edge arrays for the vectorized dynamic bounds; DAG neighbour lists
    # (which include the chain edges) for the moved-neighbour staleness check
    visit = ctx["visit"]
    edges = ctx["edges"]
    nbrs = ctx["nbrs"]
    work_l = ctx["work_l"]
    dur_l = ctx["dur_l"]

    any_gain = False
    # round-start snapshot: cached proposals valid until invalidated
    lo_all, hi_all = dyn_bounds_all(start, dur, T, edges)
    lo_all = np.maximum(lo_all, start - mu)
    hi_all = np.minimum(hi_all, start + mu)
    proposal, fresh_row = _batch_proposals(
        rem_pad, pad, start, dur, work, lo_all, hi_all, mu, T)
    prop_l = proposal.tolist()
    fresh_l = fresh_row.tolist()
    start_l = start.tolist()
    moved: set[int] = set()
    dirty: list[tuple[int, int]] = []             # committed-move windows

    for v in visit:
        w = work_l[v]
        if w == 0:
            continue
        s = start_l[v]
        e = s + dur_l[v]
        stale = (not fresh_l[v]
                 or any(u in moved for u in nbrs[v])
                 or any(a < e + mu and s - mu < b for a, b in dirty))
        if not stale:
            new_s = prop_l[v]
            if new_s < 0:
                continue
        else:
            lo, hi = dyn_bounds(inst, start, v, T)
            lo = max(lo, s - mu)
            hi = min(hi, s + mu)
            if lo > hi:
                continue
            if e <= T:
                got = _first_improving(rem_pad, pad, s, e, dur_l[v], w,
                                       lo, hi, mu, dpos, dneg)
                if got is None:
                    continue
                new_s = got[0]
            else:
                # out-of-horizon task (pathological placements): keep the
                # reference scalar scan, whose slices clip at T.
                new_s = -1
                for cand_s in range(lo, hi + 1):
                    if cand_s == s:
                        continue
                    if move_gain(rem, s, e, cand_s, w) > 0:
                        new_s = cand_s
                        break
                if new_s < 0:
                    continue
        apply_move(rem, s, e, new_s, w)
        start[v] = new_s
        any_gain = True
        moved.add(v)
        dirty.append((min(s, new_s), max(e, new_s + dur_l[v])))
    return any_gain


def timeline_cost(rem: np.ndarray) -> int:
    """Cost of a remaining-budget timeline: sum of per-unit deficits."""
    return int(np.maximum(-rem, 0).sum())
