"""Device-path greedy: the paper's §5.2 loop as a batched torch loop.

The port of ``repro.core.greedy_jax``. Semantically identical to
``core.greedy.greedy_schedule`` (same score order, same max-budget/
earliest-tie placement, same dynamic splits, same endpoint rule: a task end
``e`` becomes a candidate point only when ``e <= T``), with the per-step
EST/LST relaxation in closed form: a host-precomputed longest-path matrix
``lp`` (:func:`longest_path_matrix`) turns the worklist update into two
vectorized ops per placement::

    est = max(est, s + lp[v, :])      # descendants of v move right
    lst = min(lst, s - lp[:, v])      # ancestors of v move left

Where the reference scans the placement order with ``lax.scan`` under
three ``vmap`` levels (variants, profiles, instances), the port runs one
Python iteration per placement step over a row axis written out: every
(instance, profile, variant) row of a shape bucket advances together, with
``lp`` and its transpose resident on the device so the step's ``lp`` row
and column are two row gathers.

All inputs are padded to the reference's shape buckets (:func:`pad_dims` —
N to multiples of 128, T to multiples of 256); padding is output-invariant
(padded tasks have zero duration/work and are placed last; padded time
units are never feasible starts). Instances past the ``lp_budget_bytes``
envelope stream their longest paths through :class:`BlockedLP` chunk by
chunk instead of holding the dense matrix, bit-identically.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cluster import Platform
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import Instance
from repro_torch.core.estlst import compute_est, compute_lst
from repro_torch.core.scores import task_order
from repro_torch.core.subdivide import candidate_mask
from repro_torch.kernels.backend import resolve_device

NEG_PATH = -(1 << 30)                  # "no path" marker in lp (int32-safe)

N_BUCKET = 128                         # task-axis shape bucket
T_BUCKET = 256                         # time-axis shape bucket

# Device envelope for the dense longest-path matrix: O(N^2) int32 (64 MiB
# at N=4000); bigger instances stream through the blocked form (BlockedLP)
# or use engine="numpy" (no matrix at all).
LP_MAX_BYTES = 128 * 2**20

_BIG = np.iinfo(np.int32).max // 4     # "infeasible" budget marker

# (Npad, Tp) shape buckets the fan-out has run in this process: the
# counterpart of the reference's compiled jit signatures (a new bucket is
# the torch engine's "cache miss"; see buckets_run)
_BUCKETS_RUN: set[tuple[int, int]] = set()
_BUCKETS_LOCK = threading.Lock()


def buckets_run() -> frozenset:
    """The distinct ``(Npad, Tp)`` buckets :func:`greedy_fanout_grid_torch`
    has run in this process."""
    with _BUCKETS_LOCK:
        return frozenset(_BUCKETS_RUN)


def lp_matrix_bytes(num_tasks: int) -> int:
    """Bytes the dense int32 longest-path matrix of ``num_tasks`` needs."""
    return 4 * int(num_tasks) * int(num_tasks)


def lp_block_bytes(block: int, n_orders: int, num_tasks: int) -> int:
    """Bytes one streamed chunk of the blocked form needs on device:
    ``block`` steps x ``n_orders`` score orders x an lp row AND an lp
    column of padded width ``num_tasks``, int32 each."""
    return 2 * 4 * int(block) * int(n_orders) * int(num_tasks)


def longest_path_matrix(inst: Instance,
                        max_bytes: int | None = None) -> np.ndarray:
    """``lp[u, t]`` = max over u->t paths of the path's duration sum
    (excluding ``dur[t]``); ``lp[v, v] = 0``; unreachable = ``NEG_PATH``
    exactly (canonical, so the dense matrix is bit-comparable with
    :class:`BlockedLP` blocks).

    Profile-independent: one host sweep per instance serves every profile,
    variant and replanning round. The byte cost is checked up front against
    ``max_bytes`` (default :data:`LP_MAX_BYTES`).
    """
    N = inst.num_tasks
    limit = LP_MAX_BYTES if max_bytes is None else int(max_bytes)
    need = lp_matrix_bytes(N)
    if need > limit:
        raise MemoryError(
            f"longest-path matrix needs {need / 2**20:.1f} MiB "
            f"(N={N} tasks, O(N^2) int32), over the "
            f"{limit / 2**20:.0f} MiB lp budget; the torch engine streams "
            f"such instances through the blocked form instead — raise "
            f"lp_budget_bytes (prepare_graph / schedule_portfolio_grid / "
            f"Planner) or build a BlockedLP(inst) directly; engine="
            f"'numpy' needs no matrix at all")
    # the dense matrix IS the all-rows block of the blocked form, so the
    # two representations cannot drift
    return BlockedLP(inst, budget_bytes=limit).rows(np.arange(N))


@dataclasses.dataclass
class BlockedLP:
    """Blocked longest-path relaxation: the O(N*B) streaming form.

    Holds no matrix at all — :meth:`rows` and :meth:`cols` run the
    forward/backward max-plus sweep over the topo-ordered adjacency for
    just the requested tasks, and :meth:`chunk_tensors` assembles the
    bucket-padded per-chunk inputs the blocked greedy consumes. Values are
    bit-identical to the dense :func:`longest_path_matrix` entries.

    ``budget_bytes`` bounds the streamed chunk buffers
    (:func:`lp_block_bytes`); :meth:`chunk_width` turns it into the chunk
    width and raises ``MemoryError`` when even a single-step chunk does
    not fit.
    """

    inst: Instance
    budget_bytes: int = LP_MAX_BYTES

    def rows(self, tasks) -> np.ndarray:
        """``lp[tasks, :N]`` — descendant distances, one forward sweep."""
        inst = self.inst
        tasks = np.asarray(tasks, dtype=np.int64)
        N = inst.num_tasks
        d = np.full((len(tasks), N), NEG_PATH, dtype=np.int32)
        d[np.arange(len(tasks)), tasks] = 0
        dur = inst.dur.astype(np.int32)
        for v in inst.topo:
            ps = inst.preds(v)
            if len(ps):
                cand = d[:, ps] + dur[ps][None, :]
                np.maximum(d[:, v], cand.max(axis=1), out=d[:, v])
        # canonicalize: phantom entries (sentinel plus dur drift picked up
        # along no-path chains) all become NEG_PATH
        d[d < 0] = NEG_PATH
        d[np.arange(len(tasks)), tasks] = 0
        return d

    def cols(self, tasks) -> np.ndarray:
        """``lp[:N, tasks].T`` — ancestor distances, one backward sweep."""
        inst = self.inst
        tasks = np.asarray(tasks, dtype=np.int64)
        N = inst.num_tasks
        d = np.full((len(tasks), N), NEG_PATH, dtype=np.int32)
        d[np.arange(len(tasks)), tasks] = 0
        dur = inst.dur.astype(np.int32)
        for v in inst.topo[::-1]:
            ss = inst.succs(v)
            if len(ss):
                cand = d[:, ss] + dur[v]
                np.maximum(d[:, v], cand.max(axis=1), out=d[:, v])
        d[d < 0] = NEG_PATH
        d[np.arange(len(tasks)), tasks] = 0
        return d

    def chunk_width(self, n_orders: int, padded_n: int) -> int:
        """Chunk width B for ``n_orders`` score orders at padded task count
        ``padded_n``: the largest width whose chunk buffers fit
        ``budget_bytes``, clamped to a power-of-two divisor of
        ``padded_n`` (the reference's rule, so chunking matches)."""
        floor = lp_block_bytes(1, n_orders, padded_n)
        width = int(self.budget_bytes) // floor
        if width < 1:
            raise MemoryError(
                f"blocked longest-path streaming needs at least {floor} "
                f"bytes (one step x {n_orders} orders x 2 lp vectors of "
                f"padded width {padded_n}, int32), over the "
                f"{self.budget_bytes} byte lp budget; raise "
                f"lp_budget_bytes or use engine='numpy'")
        if width >= padded_n:
            return padded_n
        B = 1
        while B * 2 <= width and padded_n % (B * 2) == 0:
            B *= 2
        return B

    def chunk_tensors(self, vs: np.ndarray, padded_n: int):
        """Per-chunk inputs for order chunk ``vs`` [V, B]: int32
        (rows, cols), each [V, B, padded_n]. Padded task ids (>= N) get the
        padded identity row/column (``NEG_PATH`` off-diagonal, 0 on it),
        exactly the dense padded matrix's entries."""
        V, B = vs.shape
        flat = np.asarray(vs, dtype=np.int64).ravel()
        N = self.inst.num_tasks
        rows = np.full((V * B, padded_n), NEG_PATH, dtype=np.int32)
        cols = np.full((V * B, padded_n), NEG_PATH, dtype=np.int32)
        real = flat < N
        if real.any():
            uniq, inv = np.unique(flat[real], return_inverse=True)
            rows[real, :N] = self.rows(uniq)[inv]
            cols[real, :N] = self.cols(uniq)[inv]
        rows[np.arange(V * B), flat] = 0
        cols[np.arange(V * B), flat] = 0
        return rows.reshape(V, B, padded_n), cols.reshape(V, B, padded_n)

    def materialize(self, block: int = 64) -> np.ndarray:
        """Assemble the full dense matrix from row blocks (tests only)."""
        N = self.inst.num_tasks
        out = np.empty((N, N), dtype=np.int32)
        for c in range(0, N, max(int(block), 1)):
            idx = np.arange(c, min(c + max(int(block), 1), N))
            out[idx] = self.rows(idx)
        return out


def lp_for(inst: Instance, budget_bytes: int | None = None):
    """The dense matrix when it fits the budget
    (:func:`repro_torch.kernels.backend.resolve_lp_form`), else a
    :class:`BlockedLP` handle — every lp consumer accepts either."""
    from repro_torch.kernels.backend import resolve_lp_form

    limit = LP_MAX_BYTES if budget_bytes is None else int(budget_bytes)
    if resolve_lp_form(inst.num_tasks, limit) == "dense":
        return longest_path_matrix(inst, max_bytes=limit)
    return BlockedLP(inst, budget_bytes=limit)


def _bucket_up(x: int, q: int) -> int:
    return max(((int(x) + q - 1) // q) * q, q)


def pad_dims(N: int, T: int) -> tuple[int, int]:
    """Shape bucket for an (N tasks, T horizon) instance."""
    return _bucket_up(N, N_BUCKET), _bucket_up(T, T_BUCKET)


def pad_orders(orders: np.ndarray, order_tail: np.ndarray) -> np.ndarray:
    """[V, N] score orders -> [V, Np]: padded tasks placed last (no-ops)."""
    V = orders.shape[0]
    return np.concatenate(
        [np.asarray(orders, np.int32),
         np.broadcast_to(order_tail, (V, len(order_tail)))], axis=1)


def pad_masks(masks: np.ndarray, Tp: int) -> np.ndarray:
    """[..., T+1] candidate masks -> [..., Tp+1]: padded units never start."""
    T = masks.shape[-1] - 1
    pad = [(0, 0)] * (masks.ndim - 1) + [(0, Tp - T)]
    return np.pad(np.asarray(masks, bool), pad)


def pad_budget(unit_budget: np.ndarray, Tp: int) -> np.ndarray:
    """[..., T] per-unit budgets -> [..., Tp] (padding value is never read)."""
    T = unit_budget.shape[-1]
    pad = [(0, 0)] * (unit_budget.ndim - 1) + [(0, Tp - T)]
    return np.pad(np.asarray(unit_budget, np.int32), pad)


def padded_shared(inst: Instance, est0, lst0, lp=None, device=None,
                  Np: int | None = None):
    """Bucket-padded profile-independent tensors on ``device``.

    Returns ``(dur, work, lp, est, lst, order_tail)`` at the
    :func:`pad_dims` bucket of ``inst``, or at ``Np`` tasks when given (a
    larger bucket: padded tasks are zero-width no-ops, so the starts do
    not change); ``order_tail`` is the suffix of padded task ids every
    padded score order must end with. ``lp`` may be a precomputed dense
    matrix OR a :class:`BlockedLP` — the blocked handle passes through in
    the lp slot (no device matrix exists).
    """
    dev = resolve_device(device)
    N = inst.num_tasks
    if Np is None:
        Np, _ = pad_dims(N, 1)
    elif Np < N:
        raise ValueError(f"a bucket of {Np} tasks cannot hold {N}")
    if lp is None:
        lp = longest_path_matrix(inst)
    if isinstance(lp, BlockedLP):
        lp_t = lp
    else:
        lp_p = np.full((Np, Np), NEG_PATH, dtype=np.int32)
        lp_p[:N, :N] = lp
        np.fill_diagonal(lp_p[N:, N:], 0)
        lp_t = torch.from_numpy(lp_p).to(dev)

    def vec(x):
        out = np.zeros(Np, dtype=np.int32)
        out[:N] = x
        return torch.from_numpy(out).to(dev)

    return (vec(inst.dur), vec(inst.task_work), lp_t, vec(est0), vec(lst0),
            np.arange(N, Np, dtype=np.int32))


class _Rows:
    """The greedy state of R rows advancing together, one placement step
    at a time: budget ``rem`` int32 [R, Tp], candidate ``mask`` bool
    [R, Tp+1], ``est``/``lst``/``start`` int32 [R, Np]. The port of
    ``greedy_jax._placement_step`` with the batch axis written out; one
    step body serves the dense and the blocked form, so the two cannot
    drift."""

    def __init__(self, rem, mask, est, lst):
        R, Tp = rem.shape
        dev = rem.device
        self.rem, self.mask, self.est, self.lst = rem, mask, est, lst
        self.start = torch.zeros_like(est)
        self.tgrid = torch.arange(Tp, dtype=torch.int32, device=dev)
        self.ar = torch.arange(R, device=dev)
        self.neg = torch.tensor(-_BIG, dtype=torch.int32, device=dev)

    def step(self, v, row, col, dur_v, work_v):
        """Place task ``v[r]`` of every row r (v int64 [R]); ``row``/
        ``col`` int32 [R, Np] are its lp row and column, ``dur_v``/
        ``work_v`` int32 [R] its duration and work power."""
        rem, mask, ar, tgrid = self.rem, self.mask, self.ar, self.tgrid
        Tp = rem.shape[1]
        est_v = self.est[ar, v]
        lst_v = self.lst[ar, v]
        feas = mask[:, :-1] & (tgrid >= est_v[:, None]) \
            & (tgrid <= lst_v[:, None])
        val = torch.where(feas, rem, self.neg)
        # argmax takes the FIRST max, as jnp.argmax does: earliest tie
        s = torch.where(feas.any(dim=1),
                        val.argmax(dim=1).to(torch.int32), est_v)
        e = s + dur_v
        run = (tgrid >= s[:, None]) & (tgrid < e[:, None])
        rem.sub_(torch.where(run, work_v[:, None], 0).to(rem.dtype))
        # mask.at[s].set(True), dropping an out-of-range s as jnp does
        si = s.clamp(0, Tp).to(torch.int64)
        mask[ar, si] = mask[ar, si] | (s <= Tp)
        # numpy endpoint rule: e splits an interval only when e <= T (the
        # PADDED horizon, as in the reference); an overrunning task must
        # not spuriously mark T a candidate point
        ei = e.clamp(max=Tp).to(torch.int64)
        mask[ar, ei] = mask[ar, ei] | (e <= Tp)
        torch.maximum(self.est, s[:, None] + row, out=self.est)
        torch.minimum(self.lst, s[:, None] - col, out=self.lst)
        self.start[ar, v] = s


class _DenseShard:
    """The dense-lp rows of some instances of one bucket on one device.

    ``rows``: per-instance tuples ``(dur, work, lp, budgets [P, Tp],
    masks [P, V, Tp+1], est, lst, orders [V, Np])``; :meth:`step` places
    the ``t``-th task of every row's order.
    """

    def __init__(self, rows, dev):
        I = len(rows)
        P, Tp = rows[0][3].shape
        V, Np = rows[0][7].shape
        self.shape = (I, P, V, Np)

        def stack(a, dtype=None):
            return torch.stack([torch.as_tensor(r[a], dtype=dtype).to(dev)
                                for r in rows])

        dur, work = stack(0), stack(1)                      # [I, Np]
        self.lp = stack(2)                                  # [I, Np, Np]
        self.lp_t = self.lp.transpose(1, 2).contiguous()    # columns as rows
        R = I * P * V
        budgets = stack(3, torch.int32)                     # [I, P, Tp]
        rem = budgets[:, :, None, :].expand(I, P, V, Tp).reshape(R, Tp) \
            .clone()
        mask = stack(4, torch.bool).reshape(R, Tp + 1).clone()
        est = stack(5)[:, None, None, :].expand(I, P, V, Np).reshape(R, Np)
        lst = stack(6)[:, None, None, :].expand(I, P, V, Np).reshape(R, Np)
        orders = stack(7, torch.int64)[:, None].expand(I, P, V, Np) \
            .reshape(R, Np)
        self.inst_of = torch.arange(I, device=dev).repeat_interleave(P * V)
        # per-step inputs gathered once: order, duration and work by step
        self.steps = orders.t().contiguous()                # [Np, R]
        self.durs = dur[self.inst_of[:, None], orders].t().contiguous()
        self.works = work[self.inst_of[:, None], orders].t().contiguous()
        self.state = _Rows(rem, mask, est.clone(), lst.clone())

    def step(self, t: int) -> None:
        v, inst_of = self.steps[t], self.inst_of
        self.state.step(v, self.lp[inst_of, v], self.lp_t[inst_of, v],
                        self.durs[t], self.works[t])

    def starts(self) -> torch.Tensor:
        return self.state.start.reshape(self.shape)


def _dense_grid(rows, devs) -> torch.Tensor:
    """All rows of the dense-lp instances of one bucket, the instance axis
    split over ``devs`` (the port of the reference's ``_grid_launch``).

    ``rows`` as for :class:`_DenseShard`. The instances split into
    ``len(devs)`` contiguous shards, uneven where they do not divide; an
    empty shard is skipped. Every shard advances in one lockstep host loop
    over the placement steps, each issuing its launches on its own device
    (a step synchronizes nothing, so shards on separate cards run
    concurrently). Rows are independent int32 arithmetic, so the starts
    are bitwise those of one unsplit loop. Returns int32 [I, P, V, Np]
    start times on ``devs[0]``.
    """
    parts = torch.tensor_split(torch.arange(len(rows)), len(devs))
    shards = [_DenseShard([rows[i] for i in idx.tolist()], d)
              for idx, d in zip(parts, devs) if len(idx)]
    for t in range(shards[0].shape[3]):
        for s in shards:
            s.step(t)
    return torch.cat([s.starts().to(devs[0]) for s in shards])


def _blocked_fanout_padded(dur, work, blp: BlockedLP, budgets, masks,
                           est, lst, orders, device=None) -> torch.Tensor:
    """All (profile, variant) greedy schedules of one blocked-lp instance,
    chunk-streamed; every input already bucket-padded.

    Args:
      budgets: int [P, Tp]; masks: bool [P, V, Tp+1]; orders: int [V, Np];
      dur/work/est/lst: [Np] (tensors or numpy).
    Returns:
      int32 [P, V, Np] start times on the device.
    """
    dev = resolve_device(device)
    budgets = np.asarray(budgets, dtype=np.int32)
    orders = np.asarray(orders, dtype=np.int64)
    P, Tp = budgets.shape
    V, Np = orders.shape
    R = P * V
    B = blp.chunk_width(V, Np)

    def vec(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.int32)

    dur, work = vec(dur), vec(work)
    rem = torch.from_numpy(np.repeat(budgets, V, axis=0)).to(dev)
    mask = torch.from_numpy(np.asarray(masks, bool).reshape(R, Tp + 1)) \
        .to(dev)
    state = _Rows(rem, mask, vec(est)[None].repeat(R, 1),
                  vec(lst)[None].repeat(R, 1))
    col_of = torch.arange(V, device=dev).repeat(P)          # row -> variant
    orders_t = torch.from_numpy(orders).to(dev)
    n_chunks = -(-Np // B)
    with obs.span("blocked_chunk_sweep", N=int(Np), chunk_width=int(B),
                  chunks=n_chunks, rows=int(P * V)):
        for c in range(0, Np, B):
            vs = orders[:, c:c + B]
            rows, cols = blp.chunk_tensors(vs, Np)
            rows = torch.from_numpy(rows).to(dev)
            cols = torch.from_numpy(cols).to(dev)
            for j in range(vs.shape[1]):
                v = orders_t[col_of, c + j]
                state.step(v, rows[col_of, j], cols[col_of, j], dur[v],
                           work[v])
    obs.registry().counter(
        "blocked_lp_chunks_total",
        "device chunk launches of the blocked longest-path sweep"
    ).inc(n_chunks)
    return state.start.reshape(P, V, Np)


def greedy_schedule_torch(inst: Instance, profile: PowerProfile,
                          platform: Platform, score: str = "press",
                          weighted: bool = False, refined: bool = False,
                          k: int = 3, lp_budget_bytes: int | None = None,
                          device=None) -> torch.Tensor:
    """One variant's greedy; returns start times (int32 [N] on the
    device). Instances past the ``lp_budget_bytes`` dense envelope stream
    through the blocked form (:class:`BlockedLP`), bit-identically."""
    T = profile.T
    est0 = compute_est(inst)
    lst0 = compute_lst(inst, T)
    if (est0 > lst0).any():
        raise ValueError("infeasible: deadline below ASAP makespan")
    order = task_order(inst, est0, lst0, score, weighted, platform)
    mask0 = candidate_mask(inst, profile, refined=refined, k=k)
    starts = greedy_fanout_multi_torch(
        inst, T, profile.unit_budget(inst.idle_total)[None],
        mask0[None, None], np.asarray(order)[None], est0, lst0,
        lp=lp_for(inst, lp_budget_bytes), device=device)
    return starts[0, 0]


def greedy_fanout_torch(inst: Instance, profile: PowerProfile, est0, lst0,
                        masks: np.ndarray, orders: np.ndarray, lp=None,
                        shared=None, device=None) -> torch.Tensor:
    """All variants of one instance against one profile in one batched
    loop; the single-profile slice of :func:`greedy_fanout_multi_torch`.

    Args:
      masks:  bool [V, T+1] per-variant candidate masks.
      orders: int  [V, N] per-variant score orders.
      lp:     optional precomputed :func:`longest_path_matrix`.
      shared: optional :func:`padded_shared` output (device-resident reuse).
    Returns:
      int32 [V, N] start times on the device.
    """
    return greedy_fanout_multi_torch(
        inst, profile.T, profile.unit_budget(inst.idle_total)[None],
        np.asarray(masks)[None], orders, est0, lst0, lp=lp, shared=shared,
        device=device)[0]


def greedy_fanout_grid_torch(bucket_rows, device=None,
                             mesh=None) -> torch.Tensor:
    """All (instance, profile, variant) greedy schedules of one shape
    bucket: every dense-lp row advances in ONE batched loop.

    Args:
      bucket_rows: per-instance tuples of bucket-padded inputs ``(dur,
        work, lp, rem0 [P, Tp], mask0 [P, V, Tp+1], est0, lst0, order
        [V, Np])``; every row must already be padded to the same
        :func:`pad_dims` bucket (same P, V). A row's ``lp`` slot may hold a
        :class:`BlockedLP` instead of the dense matrix — such rows stream
        through the chunked loop, one instance at a time.
      mesh: optional 1-D :class:`repro_torch.sharding.ctx.Mesh`
        (:func:`~repro_torch.sharding.ctx.grid_mesh`): the dense rows'
        instance axis splits over its devices (:func:`_dense_grid`);
        blocked rows stream on its first device, unsplit.
    Returns:
      int32 [I, P, V, Np] start times on the device (the mesh's first
      device when split; caller slices off the task padding).
    """
    devs = [resolve_device(device)] if mesh is None \
        else list(mesh.devices.flat)
    dev = devs[0]
    rows = list(bucket_rows)
    with _BUCKETS_LOCK:
        _BUCKETS_RUN.add((int(rows[0][7].shape[1]),     # order [V, Np]
                          int(rows[0][3].shape[1])))    # rem0 [P, Tp]
    blocked = [isinstance(r[2], BlockedLP) for r in rows]
    out: list = [None] * len(rows)
    dense_idx = [i for i, b in enumerate(blocked) if not b]
    if dense_idx:
        dense = _dense_grid([rows[i] for i in dense_idx], devs)
        for j, i in enumerate(dense_idx):
            out[i] = dense[j]
    for i, r in enumerate(rows):
        if blocked[i]:
            dur, work, blp, budgets, masks, est, lst, orders = r
            out[i] = _blocked_fanout_padded(dur, work, blp, budgets, masks,
                                            est, lst, orders, device=dev)
    return torch.stack(out)


def greedy_fanout_multi_torch(inst: Instance, T: int,
                              unit_budgets: np.ndarray, masks: np.ndarray,
                              orders: np.ndarray, est0=None, lst0=None,
                              lp=None, shared=None,
                              device=None) -> torch.Tensor:
    """All (profile, variant) greedy schedules of one instance at once.

    Args:
      unit_budgets: int [P, T] per-profile effective budget timelines.
      masks:        bool [P, V, T+1] per-(profile, variant) candidate masks.
      orders:       int [V, N] score orders (profile-independent given T).
    Returns:
      int32 [P, V, N] start times on the device.
    """
    _, Tp = pad_dims(inst.num_tasks, T)
    if shared is None:
        shared = padded_shared(inst, est0, lst0, lp, device=device)
    dur, work, lp_t, est_t, lst_t, tail = shared
    row = (dur, work, lp_t, pad_budget(unit_budgets, Tp),
           pad_masks(masks, Tp), est_t, lst_t, pad_orders(orders, tail))
    starts = greedy_fanout_grid_torch([row], device=dur.device)
    return starts[0, :, :, :inst.num_tasks]
