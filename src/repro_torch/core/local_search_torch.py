"""Batched local search: device-resident gain/commit rounds + exact polish.

The port of ``repro.core.local_search_jax``'s portfolio climber. The
paper's local search walks tasks sequentially and applies the first
improving +-mu shift; the device climb instead evaluates *all* (task,
shift) gains at once and commits proposals in gain order with exact integer
re-evaluation. ALL rows (``-LS`` variants x ensemble profiles of one
instance) advance together:

* each round computes the round-start legal bounds, then the gain matrix
  through :func:`repro_torch.kernels.gain_scan.gain_sweep` — the CUDA
  kernel on the card, its plain version on the CPU;
* each row proposes its best shift per task (first max), orders the tasks
  by gain (a STABLE sort, as ``jnp.argsort``), and commits up to
  ``commit_k`` proposals one after another, each re-clamped to the
  current bounds and committed only when its exact integer gain is > 0;
* a row whose round commits nothing freezes (the reference's batched
  ``while_loop`` keeps finished rows unchanged); ``rounds`` counts each
  row's own rounds.

The reference runs the round loop as one ``lax.while_loop``; here it is a
Python loop with one host sync per round (is any row still climbing). A
round's commits are one call of
:func:`repro_torch.kernels.commit_scan.commit_scan`: one launch of the CUDA
kernel on the card, one batched torch step per commit slot on the CPU.

After the device climb converges, every row is *polished* with the exact
sequential reference (:func:`repro_torch.core.local_search.reference_round`)
until a full reference round commits nothing, so no variant stops earlier
than its sequential reference would, while cost stays monotonically
non-increasing throughout.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cancel import checkpoint
from repro_torch.core.carbon import PowerProfile, work_timeline
from repro_torch.core.dag import Instance
from repro_torch.core.greedy_torch import N_BUCKET, T_BUCKET, _bucket_up
from repro_torch.core.local_search import apply_move, dyn_bounds, \
    ls_graph_context, move_gain, reference_round
from repro_torch.core.local_search import dyn_bounds_all as _dyn_windows
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.commit_scan import DenseAdjacency, \
    PaddedAdjacency, commit_scan
from repro_torch.kernels.gain_scan import gain_sweep

_COMMIT_K = 32       # default device commits per row per round


def auto_commit_k(n_candidates: int,
                  lo: int = 8, hi: int = 128) -> int:
    """Pick the device commit width from instance gain density: one commit
    slot per ~4 candidate segments (``n_candidates`` = the instance's
    candidate-point count), clamped to [lo, hi]. Any width keeps the
    termination guarantee — the sequential-reference polish runs
    regardless."""
    return int(np.clip(int(n_candidates) // 4, lo, hi))


def _commit_round(inst, T, rem, start, gains, mu) -> bool:
    """Commit this round's kernel proposals in gain order, exactly."""
    dur = inst.dur
    work = inst.task_work
    best_delta = np.argmax(gains, axis=1) - mu
    best_gain = gains.max(axis=1)
    cand = np.flatnonzero(best_gain > 0)
    committed = False
    for v in cand[np.argsort(-best_gain[cand], kind="stable")]:
        v = int(v)
        s = int(start[v])
        e = s + int(dur[v])
        new_s = s + int(best_delta[v])
        dlo, dhi = dyn_bounds(inst, start, v, T)
        new_s = min(max(new_s, dlo), dhi)
        if new_s == s or dlo > dhi:
            continue
        g = move_gain(rem, s, e, new_s, int(work[v]))
        if g <= 0:
            continue
        apply_move(rem, s, e, new_s, int(work[v]))
        start[v] = new_s
        committed = True
    return committed


def local_search_batched(inst: Instance, profile: PowerProfile,
                         start: np.ndarray, mu: int = 10,
                         max_rounds: int = 200, cancel=None,
                         device=None) -> np.ndarray:
    """The host-loop climb of one schedule: one gain sweep a round on
    ``device`` (:func:`repro_torch.kernels.ops.ls_gains`; None = the
    card), its proposals committed on the host in gain order with exact
    integer re-evaluation, until a round commits nothing. The port of the
    reference's ``local_search_batched``; the portfolio engine climbs with
    :func:`local_search_portfolio_multi` instead."""
    from repro_torch.kernels.ops import ls_gains

    T = profile.T
    start = np.asarray(start, dtype=np.int64).copy()
    rem = (profile.unit_budget(inst.idle_total)
           - work_timeline(inst, T, start)).astype(np.int64)
    dur = inst.dur
    work = inst.task_work
    N = inst.num_tasks

    # edge arrays for vectorized dynamic bounds
    edges = (np.repeat(np.arange(N), np.diff(inst.pred_ptr)), inst.pred_idx,
             np.repeat(np.arange(N), np.diff(inst.succ_ptr)), inst.succ_idx)

    for _ in range(max_rounds):
        checkpoint(cancel)               # per-round cancellation rung
        lo, hi = _dyn_windows(start, dur, T, edges)
        gains = ls_gains(
            rem.astype(np.float32), start.astype(np.float32),
            dur.astype(np.float32), work.astype(np.float32),
            lo.astype(np.float32), hi.astype(np.float32), mu=mu,
            device=device).cpu().numpy()
        if not _commit_round(inst, T, rem, start, gains, mu):
            return start
    return start


def climb(rem, start, t_real: int, dur, work, adj, *, mu: int,
          max_rounds: int, commit_k: int = _COMMIT_K, cancel=None):
    """The device hill climb of R rows (``_climb_impl`` of the reference,
    with the row axis written out).

    Args:
      rem:   int32 [R, Tp] per-row remaining-budget timelines (updated in
        place).
      start: int32 [R, Np] per-row start times (updated in place).
      t_real: the real horizon (Tp may be padded).
      dur, work: int32 [Np].
      adj:   :class:`~repro_torch.kernels.commit_scan.DenseAdjacency` or
        :class:`~repro_torch.kernels.commit_scan.PaddedAdjacency`.
    Returns:
      ``(start, rounds)``: int32 [R, Np] climbed starts and int32 [R]
      device rounds per row.
    """
    R, Np = start.shape
    dev = rem.device
    workf = work.to(torch.float32)
    rounds = torch.zeros(R, dtype=torch.int32, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    k = min(int(commit_k), Np)
    while True:
        live = active & (rounds < max_rounds)
        if not bool(live.any()):
            break
        checkpoint(cancel)               # per-round cancellation rung
        # round-start dynamic bounds, as in dyn_bounds_all
        lo, succ_hi = adj.bounds(start, dur, t_real)
        hi = succ_hi - dur
        g = gain_sweep(rem.to(torch.float32), start, dur, workf,
                       (lo - start).to(torch.float32),
                       (hi - start).to(torch.float32), mu=mu)
        best_gain, best_idx = g.max(dim=2)      # first max, as jnp.argmax
        best_delta = best_idx.to(torch.int32) - mu
        order = torch.argsort(-best_gain, dim=1, stable=True)
        any_commit = commit_scan(rem, start, order[:, :k], best_delta,
                                 best_gain, live, dur, work, t_real, adj)
        rounds += live.to(torch.int32)
        active = torch.where(live, any_commit, active)
    return start, rounds


def _dense_adjacency(inst: Instance, ctx: dict | None):
    """bool [N, N] (pred, succ) masks of the direct G_c edges, cached."""
    if ctx is not None and "adj_dense" in ctx:
        return ctx["adj_dense"]
    N = inst.num_tasks
    u = np.repeat(np.arange(N), np.diff(inst.succ_ptr))
    v = inst.succ_idx
    pred = np.zeros((N, N), dtype=bool)
    succ = np.zeros((N, N), dtype=bool)
    pred[v, u] = True
    succ[u, v] = True
    if ctx is not None:
        ctx["adj_dense"] = (pred, succ)
    return pred, succ


def _padded_adjacency(inst: Instance, ctx: dict | None):
    """Padded-CSR gather tables of the direct G_c edges, cached:
    ``(pidx, pok, sidx, sok)``, int32/bool [N, D] with D the max degree
    bucketed up to a multiple of 8 — the O(N * D) twin of
    :func:`_dense_adjacency`'s O(N^2) masks."""
    if ctx is not None and "adj_padded" in ctx:
        return ctx["adj_padded"]
    N = inst.num_tasks
    pdeg = np.diff(inst.pred_ptr)
    sdeg = np.diff(inst.succ_ptr)
    D = _bucket_up(max(int(pdeg.max(initial=1)),
                       int(sdeg.max(initial=1)), 1), 8)
    pidx = np.zeros((N, D), dtype=np.int32)
    pok = np.zeros((N, D), dtype=bool)
    sidx = np.zeros((N, D), dtype=np.int32)
    sok = np.zeros((N, D), dtype=bool)
    r = np.repeat(np.arange(N), pdeg)
    c = np.arange(len(inst.pred_idx)) - np.repeat(inst.pred_ptr[:-1], pdeg)
    pidx[r, c] = inst.pred_idx
    pok[r, c] = True
    r = np.repeat(np.arange(N), sdeg)
    c = np.arange(len(inst.succ_idx)) - np.repeat(inst.succ_ptr[:-1], sdeg)
    sidx[r, c] = inst.succ_idx
    sok[r, c] = True
    out = (pidx, pok, sidx, sok)
    if ctx is not None:
        ctx["adj_padded"] = out
    return out


def _device_adjacency(inst: Instance, ctx: dict, Np: int, padded: bool,
                      dev: torch.device):
    """Bucket-padded adjacency on ``dev`` (padded tasks have no edges)."""
    N = inst.num_tasks
    if padded:
        tables = []
        for a in _padded_adjacency(inst, ctx):
            p = np.zeros((Np, a.shape[1]), dtype=a.dtype)
            p[:N] = a
            tables.append(torch.from_numpy(p).to(dev))
        return PaddedAdjacency(*tables)
    masks = []
    for a in _dense_adjacency(inst, ctx):
        p = np.zeros((Np, Np), dtype=bool)
        p[:N, :N] = a
        masks.append(torch.from_numpy(p).to(dev))
    return DenseAdjacency(*masks)


def local_search_portfolio_multi(inst: Instance, T: int,
                                 unit_budgets: np.ndarray,
                                 starts: np.ndarray, mu: int = 10,
                                 max_rounds: int = 200,
                                 ctx: dict | None = None,
                                 polish: bool = True,
                                 commit_k: int | None = None,
                                 adjacency: str | None = None,
                                 cancel=None, device=None,
                                 timings: dict | None = None) -> np.ndarray:
    """Hill-climb a batch of schedule rows of one instance at once.

    The portfolio engine's climber: rows are any mix of ``-LS`` variants
    and ensemble profiles (each row has its own budget timeline). The round
    loop runs on ``device``, then each row is polished on the host to
    sequential-reference local optimality with its own round budget.

    Args:
      unit_budgets: int [R, T] per-row effective budget timelines.
      starts:       int [R, N] one greedy schedule per row.
      ctx:          optional shared graph context (``ls_graph_context``).
      commit_k:     device commits per row per round (None = 32).
      adjacency:    ``"dense"`` (None, the default) keeps O(N^2) bool edge
        masks on device; ``"padded"`` uses O(N * D) padded-CSR gather
        tables — identical bounds, the form of the blocked-lp path.
      cancel:       optional :class:`repro_torch.core.cancel.CancelToken`,
        polled before the climb, between its rounds and between polish
        rounds.
      device:       where the climb runs (None = the card).
      timings:      optional dict; ``"climb"`` and ``"polish"`` seconds
        are added to it.
    Returns:
      int64 [R, N] improved schedules; per-row cost is monotonically
      non-increasing, and no row terminates while a sequential reference
      round could still improve it.
    """
    if adjacency not in (None, "dense", "padded"):
        raise ValueError(f"unknown adjacency form {adjacency!r}")
    dev = resolve_device(device)
    starts = np.asarray(starts, dtype=np.int64).copy()
    R, N = starts.shape
    unit_budgets = np.asarray(unit_budgets, dtype=np.int64)
    ctx = ctx if ctx is not None else ls_graph_context(inst)

    t0 = time.perf_counter()
    rems = unit_budgets - np.stack(
        [work_timeline(inst, T, starts[i]) for i in range(R)])
    # bucket-padded device inputs: padded tasks have work 0 (never legal),
    # padded rows repeat row 0 (computed, discarded), padded time units are
    # unreachable (moves clamp to the real horizon t_real)
    Np = _bucket_up(N, N_BUCKET)
    Tp = _bucket_up(T, T_BUCKET)
    Rp = _bucket_up(R, 8)
    rem_p = np.zeros((Rp, Tp), dtype=np.int32)
    rem_p[:R, :T] = rems
    rem_p[R:] = rem_p[0]
    start_p = np.zeros((Rp, Np), dtype=np.int32)
    start_p[:R, :N] = starts
    start_p[R:] = start_p[0]
    dur_p = np.zeros(Np, dtype=np.int32)
    dur_p[:N] = inst.dur
    work_p = np.zeros(Np, dtype=np.int32)
    work_p[:N] = inst.task_work
    padded = adjacency == "padded"
    adj = _device_adjacency(inst, ctx, Np, padded, dev)

    checkpoint(cancel)                   # last rung before the device climb
    ck = _COMMIT_K if commit_k is None else int(commit_k)
    with obs.span("ls_device_climb", rows=int(R), N=int(N), T=int(T),
                  commit_k=ck, padded=padded) as climb_span:
        climbed, rounds_dev = climb(
            torch.from_numpy(rem_p).to(dev),
            torch.from_numpy(start_p).to(dev), int(T),
            torch.from_numpy(dur_p).to(dev),
            torch.from_numpy(work_p).to(dev), adj, mu=mu,
            max_rounds=max_rounds, commit_k=ck, cancel=cancel)
        starts = climbed[:R, :N].cpu().numpy().astype(np.int64)
        rounds_dev = rounds_dev[:R].cpu().numpy()
        climb_span.set(rounds_max=int(rounds_dev.max(initial=0)))
    rounds_hist = obs.registry().histogram(
        "ls_device_rounds", "device while_loop rounds per climb row",
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256), reservoir=256)
    for r in rounds_dev:
        rounds_hist.observe(int(r))
    t1 = time.perf_counter()

    if polish:
        pad = mu
        polish_rounds = 0
        with obs.span("ls_polish", rows=int(R)) as polish_span:
            for i in range(R):
                rem_pad = np.zeros(T + 2 * pad, dtype=np.int64)
                rem_pad[pad:pad + T] = unit_budgets[i] - work_timeline(
                    inst, T, starts[i])
                budget = max_rounds               # per-variant round budget
                while budget > 0 and reference_round(inst, T, rem_pad, pad,
                                                     starts[i], mu, ctx):
                    budget -= 1
                    polish_rounds += 1
                    checkpoint(cancel)   # per-polish-round rung
            polish_span.set(rounds=polish_rounds)
        obs.registry().counter(
            "ls_polish_rounds_total",
            "sequential-reference polish rounds run after device climbs"
        ).inc(polish_rounds)
    if timings is not None:
        timings["climb"] = timings.get("climb", 0.0) + (t1 - t0)
        timings["polish"] = timings.get("polish", 0.0) \
            + (time.perf_counter() - t1)
    return starts


def local_search_portfolio(inst: Instance, profile: PowerProfile,
                           starts: np.ndarray, mu: int = 10,
                           max_rounds: int = 200,
                           ctx: dict | None = None,
                           polish: bool = True,
                           commit_k: int | None = None,
                           adjacency: str | None = None,
                           cancel=None, device=None) -> np.ndarray:
    """Hill-climb a whole portfolio of schedules of one instance against
    one profile (``starts`` int [V, N], one greedy schedule per ``-LS``
    variant); the single-profile slice of
    :func:`local_search_portfolio_multi`."""
    starts = np.asarray(starts, dtype=np.int64)
    V = starts.shape[0]
    if ctx is not None and "unit_budget" in ctx:
        unit = np.asarray(ctx["unit_budget"], dtype=np.int64)
    else:
        unit = profile.unit_budget(inst.idle_total).astype(np.int64)
    budgets = np.broadcast_to(unit, (V, profile.T))
    return local_search_portfolio_multi(
        inst, profile.T, budgets, starts, mu=mu, max_rounds=max_rounds,
        ctx=ctx, polish=polish, commit_k=commit_k, adjacency=adjacency,
        cancel=cancel, device=device)
