"""Portfolio scheduling engine: every CaWoSched variant of an instance,
against one carbon forecast or a whole ensemble of them, in one pass.

The port of ``repro.core.portfolio``. The precompute splits along the
profile axis:

* :class:`PreparedGraph` — the profile-INDEPENDENT half, a pure function of
  ``(inst, platform, T, k)``: EST/LST, the four score orders, adjacency
  lists, the graph half of the local-search context, and (lazily) the
  longest-path relaxation + padded device tensors of the torch fan-out —
  the dense matrix when it fits ``lp_budget_bytes``, the streamed
  ``greedy_torch.BlockedLP`` form past it.
* :class:`ProfileOverlay` — the cheap per-profile remainder: candidate
  masks and the segment skeleton, segment budget values and the per-unit
  budget timeline, and the completed local-search context.
* :class:`PreparedInstance` — graph + overlay glued back together; no
  field is ever mutated by the schedulers.

:func:`schedule_portfolio_grid` is THE scheduling pass: an I x P x V
(instances x profiles x variants) grid in one call. ``engine="numpy"`` runs
the 8 unique greedy configurations once per cell on the segment-list fast
path and the exact sequential local search for each ``-LS`` variant;
``engine="torch"`` runs the greedy fan-out ONCE per padded shape bucket —
all (instance, profile, variant) rows of a bucket advance together on the
device — and advances each instance's (profile, ``-LS``-variant) rows as
one batched device hill climb
(:func:`repro_torch.core.local_search_torch.local_search_portfolio_multi`:
gain/commit rounds on the device, then an exact sequential polish).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.cluster import Platform
from repro_torch.core.cancel import checkpoint
from repro_torch.core.carbon import PowerProfile, schedule_cost, \
    validate_schedule
from repro_torch.core.cawosched import ALL_VARIANTS, VARIANTS_BY_NAME, \
    ScheduleResult
from repro_torch.core.dag import Instance
from repro_torch.core.estlst import compute_est, compute_lst
from repro_torch.core.greedy import adjacency_lists, greedy_core_segments, \
    segment_state
from repro_torch.core.local_search import local_search, ls_graph_context
from repro_torch.core.scores import task_order
from repro_torch.core.subdivide import candidate_mask

PORTFOLIO_VARIANTS: tuple[str, ...] = \
    ("asap",) + tuple(v.name for v in ALL_VARIANTS)

# the 8 unique greedy configurations behind the 16 variants
_COMBOS: tuple[tuple[str, bool, bool], ...] = tuple(
    (s, w, r) for s in ("slack", "press") for w in (False, True)
    for r in (False, True))


@dataclasses.dataclass
class PreparedGraph:
    """Profile-independent scheduling state of ``(inst, platform, T, k)``."""

    inst: Instance
    platform: Platform
    T: int
    k: int
    est0: np.ndarray                  # [N] EST  (== the ASAP schedule)
    lst0: np.ndarray                  # [N] LST
    feasible: bool                    # est0 <= lst0 everywhere
    orders: dict                      # lazy (score, weighted) -> int64 [N]
    adj: tuple                        # (succ_lists, pred_lists)
    lp_budget_bytes: int | None = None   # None -> greedy_torch.LP_MAX_BYTES
    _ls_graph: dict | None = None     # lazy ls_graph_context()
    _masks: dict = dataclasses.field(default_factory=dict)
    _lp: object | None = None         # lazy dense matrix OR BlockedLP
    _shared: dict = dataclasses.field(default_factory=dict)  # by device

    _MASK_CACHE = 8                   # bounds keys kept (FIFO)

    @property
    def ls_graph(self) -> dict:
        """ls_graph_context() (no unit_budget), computed on first use."""
        if self._ls_graph is None:
            self._ls_graph = ls_graph_context(self.inst, self.platform)
        return self._ls_graph

    def masks_for(self, profile: PowerProfile,
                  refined_values=(False, True)) -> dict:
        """refined -> bool [T+1] candidate masks; cached by interval bounds
        (bounded FIFO), and only for the requested ``refined_values``."""
        key = profile.bounds.tobytes()
        if key not in self._masks:
            while len(self._masks) >= self._MASK_CACHE:
                self._masks.pop(next(iter(self._masks)))
            self._masks[key] = {}
        masks = self._masks[key]
        for r in refined_values:
            if r not in masks:
                masks[r] = candidate_mask(self.inst, profile, refined=r,
                                          k=self.k)
        return masks

    def order_for(self, score: str, weighted: bool) -> np.ndarray:
        """The (score, weighted) task order, computed on first use."""
        if not self.feasible:
            raise ValueError("infeasible: deadline below ASAP makespan")
        key = (score, weighted)
        if key not in self.orders:
            self.orders[key] = task_order(
                self.inst, self.est0, self.lst0, score, weighted,
                self.platform)
        return self.orders[key]

    def lp(self):
        """The longest-path relaxation of the torch path: the dense matrix
        when it fits ``lp_budget_bytes``
        (:func:`repro_torch.kernels.backend.resolve_lp_form`), else a
        streamed :class:`repro_torch.core.greedy_torch.BlockedLP`."""
        if self._lp is None:
            from repro_torch.core.greedy_torch import lp_for
            self._lp = lp_for(self.inst, self.lp_budget_bytes)
        return self._lp

    @property
    def lp_is_blocked(self) -> bool:
        """Whether the torch path streams this graph's longest paths in
        blocks (the big-instance form) instead of holding the dense
        matrix on the device."""
        from repro_torch.core.greedy_torch import BlockedLP
        return isinstance(self.lp(), BlockedLP)

    def shared(self, device):
        """Bucket-padded tensors on ``device``, resident across calls."""
        key = str(device)
        if key not in self._shared:
            from repro_torch.core.greedy_torch import padded_shared
            self._shared[key] = padded_shared(
                self.inst, self.est0, self.lst0, self.lp(), device=device)
        return self._shared[key]


@dataclasses.dataclass
class ProfileOverlay:
    """Per-profile overlay completing a :class:`PreparedGraph`."""

    profile: PowerProfile
    masks: dict                       # refined -> bool [T+1] candidate mask
    segs: dict                        # refined -> (pts0, vals0) segment state
    unit_budget: np.ndarray           # int64 [T] effective per-unit budget
    graph: PreparedGraph | None = None
    _ls: dict | None = None           # lazy completed ls_context()

    @property
    def ls(self) -> dict:
        """Completed ls_context(): the graph context + this profile's
        budget timeline, built on first use."""
        if self._ls is None:
            ls = dict(self.graph.ls_graph)
            ls["unit_budget"] = self.unit_budget
            self._ls = ls
        return self._ls


def prepare_graph(inst: Instance, platform: Platform, T: int,
                  k: int = 3,
                  lp_budget_bytes: int | None = None) -> PreparedGraph:
    """Run the profile-independent precompute once per (instance, horizon).

    ``lp_budget_bytes`` bounds the torch path's longest-path memory (None =
    :data:`repro_torch.core.greedy_torch.LP_MAX_BYTES`); instances whose
    dense matrix exceeds it stream through the blocked form.
    """
    est0 = compute_est(inst)
    lst0 = compute_lst(inst, T)
    feasible = bool((est0 <= lst0).all())
    return PreparedGraph(
        inst=inst, platform=platform, T=T, k=k,
        est0=est0, lst0=lst0, feasible=feasible, orders={},
        adj=adjacency_lists(inst), lp_budget_bytes=lp_budget_bytes)


def overlay_profile(graph: PreparedGraph, profile: PowerProfile,
                    refined_values=(False, True)) -> ProfileOverlay:
    """Complete ``graph`` for one profile; see :class:`ProfileOverlay`."""
    if profile.T != graph.T:
        raise ValueError(
            f"profile horizon {profile.T} != prepared horizon {graph.T}")
    masks = graph.masks_for(profile, refined_values)
    segs = {r: segment_state(graph.inst, profile, mask=masks[r])
            for r in refined_values}
    unit_budget = profile.unit_budget(graph.inst.idle_total).astype(np.int64)
    return ProfileOverlay(profile=profile, masks=masks, segs=segs,
                          unit_budget=unit_budget, graph=graph)


@dataclasses.dataclass
class PreparedInstance:
    """Graph + overlay: the amortized per-(instance, profile) state, with
    the flat attribute surface the schedulers consume."""

    graph: PreparedGraph
    overlay: ProfileOverlay

    inst = property(lambda self: self.graph.inst)
    platform = property(lambda self: self.graph.platform)
    k = property(lambda self: self.graph.k)
    est0 = property(lambda self: self.graph.est0)
    lst0 = property(lambda self: self.graph.lst0)
    feasible = property(lambda self: self.graph.feasible)
    orders = property(lambda self: self.graph.orders)
    adj = property(lambda self: self.graph.adj)
    profile = property(lambda self: self.overlay.profile)
    masks = property(lambda self: self.overlay.masks)
    segs = property(lambda self: self.overlay.segs)
    ls = property(lambda self: self.overlay.ls)


def prepare_instance(inst: Instance, profile: PowerProfile,
                     platform: Platform, k: int = 3) -> PreparedInstance:
    """Graph + overlay in one call; see :class:`PreparedInstance`."""
    graph = prepare_graph(inst, platform, profile.T, k=k)
    return PreparedInstance(graph=graph,
                            overlay=overlay_profile(graph, profile))


def _greedy_starts_numpy(prep: PreparedInstance, combos) -> dict:
    """One segment-greedy run per unique (score, weighted, refined)."""
    out = {}
    for (score, weighted, refined) in combos:
        t0 = time.perf_counter()
        pts0, vals0 = prep.segs[refined]
        start = greedy_core_segments(
            prep.inst, prep.profile.T, prep.est0, prep.lst0,
            prep.graph.order_for(score, weighted), pts0, vals0, prep.adj)
        out[(score, weighted, refined)] = (start, time.perf_counter() - t0)
    return out


def bucket_entries_total() -> int:
    """Distinct ``(Npad, Tp)`` shape buckets the torch fan-out has run
    in this process (the counterpart of the reference's
    ``jit_entries_total``): sampled before and after a bucket run, the
    delta is that run's bucket misses, which the mapping search records
    per evaluation batch."""
    from repro_torch.core.greedy_torch import buckets_run
    return len(buckets_run())


def _needed_combos(names) -> list[tuple[str, bool, bool]]:
    need = []
    for name in names:
        if name == "asap":
            continue
        v = VARIANTS_BY_NAME[name]
        key = (v.score, v.weighted, v.refined)
        if key not in need:
            need.append(key)
    return need


def _assemble(names, prep: PreparedInstance, greedy: dict, ls_done: dict,
              mu: int, validate: bool,
              cancel=None) -> dict[str, ScheduleResult]:
    """Finish a portfolio pass: -LS fallbacks, validation, costs."""
    checkpoint(cancel)    # per-cell rung (numpy -LS climbs run below)
    out: dict[str, ScheduleResult] = {}
    for name in names:
        if name == "asap":
            t0 = time.perf_counter()
            start = prep.est0.copy()
            secs = time.perf_counter() - t0
        else:
            v = VARIANTS_BY_NAME[name]
            start, secs = greedy[(v.score, v.weighted, v.refined)]
            if v.ls:
                if name in ls_done:
                    ls_start, ls_secs = ls_done[name]
                    start, secs = ls_start, secs + ls_secs
                else:
                    t0 = time.perf_counter()
                    start = local_search(prep.inst, prep.profile,
                                         prep.platform, start, mu=mu,
                                         ctx=prep.ls)
                    secs += time.perf_counter() - t0
        if validate:
            validate_schedule(prep.inst, prep.profile, start)
        out[name] = ScheduleResult(
            variant=name, start=start,
            cost=schedule_cost(prep.inst, prep.profile, start), seconds=secs)
    return out


def _add(timings: dict | None, key: str, t0: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + (time.perf_counter() - t0)


def schedule_portfolio_grid(instances, profile_grid, platform: Platform,
                            variants=None, k: int = 3, mu: int = 10,
                            validate: bool = True, engine: str = "numpy",
                            graphs=None,
                            commit_k: int | str | None = None,
                            ls_max_rounds: int = 200,
                            lp_budget_bytes: int | None = None,
                            cancel=None, device=None,
                            timings: dict | None = None
                            ) -> list[list[dict[str, ScheduleResult]]]:
    """THE (instances x profiles x variants) scheduling pass.

    ``profile_grid[i]`` lists instance i's profiles; every instance carries
    the same number P of profiles, and an instance's profiles share its
    horizon T. Returns an I x P nested list of ``{variant:
    ScheduleResult}`` dicts.

    Engines: ``"numpy"`` runs the segment-list greedy + exact sequential
    local search per cell. ``"torch"`` runs the greedy fan-out ONCE per
    padded shape bucket (:func:`repro_torch.core.greedy_torch.pad_dims`) —
    all (instance, profile, variant) rows of a bucket advance together on
    ``device`` — and advances each instance's (profile, ``-LS``-variant)
    rows as one batched device hill climb (committing up to ``commit_k``
    proposals per row per round; ``"auto"`` scales the width with the
    instance's candidate-segment count via
    :func:`repro_torch.core.local_search_torch.auto_commit_k`), polished
    to sequential-reference local optimality.

    ``lp_budget_bytes`` (None = ``greedy_torch.LP_MAX_BYTES``) bounds the
    torch engine's per-instance longest-path memory: bigger instances
    stream the blocked form (``BlockedLP`` fan-out + padded-CSR climb
    adjacency) bit-identically. Applies to graphs built here — prebuilt
    ``graphs`` carry their own budget.

    ``cancel`` (an optional :class:`repro_torch.core.cancel.CancelToken`)
    is polled between greedy cells (numpy) / device bucket runs (torch)
    and before every per-instance local-search climb.

    ``device`` is where the torch engine runs (None = the card); the
    numpy engine ignores it. ``timings``, when given, accumulates host
    wall seconds per phase: ``"overlay"`` (per-profile precompute),
    ``"rows"`` (longest paths and padded device inputs), ``"greedy"``,
    ``"climb"``, ``"polish"`` and ``"assemble"`` (validation and costs).

    Rows whose ``(instance, profile row)`` repeats earlier entries BY
    IDENTITY are deduped host-side: graphs, overlays, local-search climbs,
    assembly, and validation run once per unique row, and duplicates alias
    the results; the padded device run keeps its bucket shape.
    """
    if engine not in ("numpy", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    instances = list(instances)
    I = len(instances)
    if I == 0:
        return []
    profile_grid = [list(ps) for ps in profile_grid]
    if len(profile_grid) != I:
        raise ValueError("profile_grid must list one profile set "
                         "per instance")
    P = len(profile_grid[0])
    if any(len(ps) != P for ps in profile_grid):
        raise ValueError("every instance needs the same number of "
                         "profiles (dense grid)")
    if P == 0:
        return [[] for _ in range(I)]
    names = PORTFOLIO_VARIANTS if variants is None else tuple(variants)
    heur = any(n != "asap" for n in names)
    if engine == "torch":
        from repro_torch.kernels.backend import resolve_device
        device = resolve_device(device)

    # identity dedupe (see docstring): dup_of[i] == i marks a unique row;
    # duplicates point at the first occurrence (always a lower index)
    uniq: dict[tuple, int] = {}
    dup_of: list[int] = []
    for inst, ps in zip(instances, profile_grid):
        key = (id(inst), tuple(id(p) for p in ps))
        dup_of.append(uniq.setdefault(key, len(dup_of)))
    n_dup = sum(1 for i, d in enumerate(dup_of) if d != i)
    if n_dup:
        obs.registry().counter(
            "portfolio_rows_deduped_total",
            "duplicate (instance, profile-row) grid rows aliased to a "
            "unique row's results instead of recomputed host-side").inc(
                n_dup)

    t0 = time.perf_counter()
    if graphs is None:
        graphs = [None] * I
    graphs = list(graphs)
    for i, (inst, ps) in enumerate(zip(instances, profile_grid)):
        if graphs[i] is None:
            graphs[i] = graphs[dup_of[i]] if dup_of[i] != i else \
                prepare_graph(inst, platform, ps[0].T, k=k,
                              lp_budget_bytes=lp_budget_bytes)
    need = _needed_combos(names)
    # overlays only precompute the interval subdivisions the requested
    # variants use (an asap-only request skips masks/segments entirely)
    rvals = tuple(sorted({r for (_, _, r) in need}))
    overlays: list = []
    for i, (g, ps) in enumerate(zip(graphs, profile_grid)):
        overlays.append(
            overlays[dup_of[i]] if dup_of[i] != i else
            [overlay_profile(g, p, refined_values=rvals) for p in ps])
    if heur and not all(g.feasible for g in graphs):
        raise ValueError("infeasible: deadline below ASAP makespan")
    _add(timings, "overlay", t0)

    # --- greedy: all (instance, profile, unique-combo) starts -------------
    greedys: list[list[dict]] = [[{} for _ in range(P)] for _ in range(I)]
    if need and engine == "numpy":
        t0 = time.perf_counter()
        with obs.span("greedy_numpy", cells=I * P, combos=len(need)):
            for i in range(I):
                if dup_of[i] != i:
                    greedys[i] = greedys[dup_of[i]]
                    continue
                for p in range(P):
                    checkpoint(cancel)   # per-cell cancellation rung
                    prep = PreparedInstance(graph=graphs[i],
                                            overlay=overlays[i][p])
                    greedys[i][p] = _greedy_starts_numpy(prep, need)
        _add(timings, "greedy", t0)
    elif need:                                     # engine == "torch"
        from repro_torch.core.greedy_torch import greedy_fanout_grid_torch, \
            pad_budget, pad_dims, pad_masks, pad_orders

        buckets: dict[tuple, list[int]] = {}
        for i, (inst, g) in enumerate(zip(instances, graphs)):
            buckets.setdefault(pad_dims(inst.num_tasks, g.T), []).append(i)
        for (Npad, Tp), idx in buckets.items():
            checkpoint(cancel)           # per-bucket rung
            t0 = time.perf_counter()
            launch_span = obs.start_span(
                "bucket_launch", bucket=f"{Npad}x{Tp}",
                instances=len(idx), rows=len(idx) * P * len(need))
            misses0 = bucket_entries_total()
            # duplicate rows reuse the unique row's host-built tuple (the
            # dedupe target shares the instance object, hence the bucket,
            # so it was built earlier in this idx walk)
            row_cache: dict[int, tuple] = {}
            rows = []
            for i in idx:
                if dup_of[i] in row_cache:
                    rows.append(row_cache[dup_of[i]])
                    continue
                g = graphs[i]
                dur, work, lp, est_t, lst_t, tail = g.shared(device)
                budgets = pad_budget(np.stack(
                    [ov.unit_budget for ov in overlays[i]]), Tp)
                masks = pad_masks(np.stack(
                    [np.stack([ov.masks[r] for (_, _, r) in need])
                     for ov in overlays[i]]), Tp)
                orders = pad_orders(np.stack(
                    [g.order_for(s, w) for (s, w, _) in need]), tail)
                row_cache[dup_of[i]] = (dur, work, lp, budgets, masks,
                                        est_t, lst_t, orders)
                rows.append(row_cache[dup_of[i]])
            _add(timings, "rows", t0)
            t0 = time.perf_counter()
            try:
                starts = greedy_fanout_grid_torch(rows, device=device) \
                    .cpu().numpy().astype(np.int64)
            finally:
                # a bucket's first run in this process is its miss
                misses = max(bucket_entries_total() - misses0, 0)
                if misses:
                    obs.registry().counter(
                        "torch_bucket_misses_total",
                        "first runs of a padded (Npad, Tp) fan-out bucket "
                        "in this process (steady state stays at 0)",
                        labels=("bucket",)).inc(misses,
                                                bucket=f"{Npad}x{Tp}")
                launch_span.end(cache_misses=misses)
            _add(timings, "greedy", t0)
            dt = (time.perf_counter() - t0) / (len(idx) * P * len(need))
            for b, i in enumerate(idx):
                N = instances[i].num_tasks
                for p in range(P):
                    greedys[i][p] = {c: (starts[b, p, ci, :N], dt)
                                     for ci, c in enumerate(need)}

    # --- local search: one batched climb per instance (torch), else exact
    # sequential search inside _assemble (numpy) --------------------------
    ls_names = [n for n in names
                if n != "asap" and VARIANTS_BY_NAME[n].ls]
    ls_dones: list[list[dict]] = [[{} for _ in range(P)] for _ in range(I)]
    if ls_names and engine == "torch":
        from repro_torch.core.local_search_torch import auto_commit_k, \
            local_search_portfolio_multi

        keys = [VARIANTS_BY_NAME[n] for n in ls_names]
        for i in range(I):
            if dup_of[i] != i:
                ls_dones[i] = ls_dones[dup_of[i]]
                continue
            checkpoint(cancel)           # per-climb rung
            ck = commit_k
            if ck == "auto":
                # commit width from this instance's gain density: scale
                # with its candidate-segment count (max over the grid row)
                ck = auto_commit_k(max(
                    len(overlays[i][p].segs[r][0])
                    for p in range(P) for r in rvals))
            t0 = time.perf_counter()
            rows = np.stack(
                [greedys[i][p][(v.score, v.weighted, v.refined)][0]
                 for p in range(P) for v in keys])
            row_budgets = np.stack([overlays[i][p].unit_budget
                                    for p in range(P) for _ in keys])
            # ctx = the graph dict, so the adjacency cache of the device
            # climb survives across profiles; blocked-lp instances use the
            # padded-CSR adjacency so the climb holds no N x N tensor
            with obs.span("ls_climb", instance=i, rows=len(rows)):
                improved = local_search_portfolio_multi(
                    instances[i], graphs[i].T, row_budgets, rows, mu=mu,
                    max_rounds=ls_max_rounds, ctx=graphs[i].ls_graph,
                    commit_k=ck,
                    adjacency="padded" if graphs[i].lp_is_blocked
                    else "dense",
                    cancel=cancel, device=device, timings=timings)
            dt = (time.perf_counter() - t0) / len(rows)
            for p in range(P):
                ls_dones[i][p] = {n: (improved[p * len(keys) + j], dt)
                                  for j, n in enumerate(ls_names)}

    obs.registry().counter(
        "portfolio_cells_total",
        "grid cells served by the portfolio pass, by engine",
        labels=("engine",)).inc(I * P, engine=engine)
    t0 = time.perf_counter()
    out_rows: list = []
    for i in range(I):
        if dup_of[i] != i:
            out_rows.append(out_rows[dup_of[i]])
            continue
        out_rows.append(
            [_assemble(names,
                       PreparedInstance(graph=graphs[i],
                                        overlay=overlays[i][p]),
                       greedys[i][p], ls_dones[i][p], mu, validate,
                       cancel=cancel)
             for p in range(P)])
    _add(timings, "assemble", t0)
    return out_rows


def schedule_portfolio(inst: Instance, profile: PowerProfile,
                       platform: Platform, variants=None, k: int = 3,
                       mu: int = 10, validate: bool = True,
                       engine: str = "numpy",
                       prep: PreparedInstance | None = None,
                       device=None) -> dict[str, ScheduleResult]:
    """Schedule all requested variants (default: asap + all 16) in one pass.

    .. deprecated:: legacy shim over :class:`repro_torch.api.Planner` (the
       1 instance x 1 profile slice of one :meth:`~repro_torch.api.Planner
       .plan` call); prefer ``Planner(platform).plan(PlanRequest(...))``.
       ``prep`` may be passed to reuse the precompute across calls (it
       must match ``(inst, profile, platform, k)``). ``device`` is the
       planner's (None = the card).
    """
    from repro_torch.api import LocalSearchConfig, Planner, PlanRequest

    planner = Planner(platform, engine=engine, k=k,
                      ls=LocalSearchConfig(mu=mu), validate=validate,
                      device=device)
    if prep is not None:
        planner.seed_graph(prep.graph)
    res = planner.plan(PlanRequest(instances=inst, profiles=profile,
                                   variants=variants))
    return res.results[0][0]


def schedule_portfolio_multi(inst: Instance, profiles, platform: Platform,
                             variants=None, k: int = 3, mu: int = 10,
                             validate: bool = True, engine: str = "numpy",
                             graph: PreparedGraph | None = None,
                             device=None) -> list[dict[str, ScheduleResult]]:
    """One instance x N profiles x all variants; the replanning fan-out.

    .. deprecated:: legacy shim over :class:`repro_torch.api.Planner` (the
       1 instance x P profiles slice of one :meth:`~repro_torch.api
       .Planner.plan` call). Returns one ``{variant: ScheduleResult}`` dict
       per profile, each equal to ``schedule_portfolio(inst, profile_i,
       platform, engine=engine)``.
    """
    from repro_torch.api import LocalSearchConfig, Planner, PlanRequest

    profiles = list(profiles)
    if not profiles:
        return []
    planner = Planner(platform, engine=engine, k=k,
                      ls=LocalSearchConfig(mu=mu), validate=validate,
                      device=device)
    if graph is not None:
        planner.seed_graph(graph)
    res = planner.plan(PlanRequest(instances=inst, profiles=profiles,
                                   variants=variants))
    return res.results[0]


def portfolio_cost_matrix(results, variants=None):
    """[P, V] cost matrix from one instance's row of grid results.

    Returns ``(costs, names)``; ``costs[p, v]`` is profile p's carbon cost
    under variant ``names[v]``. The robust (min over variants of max over
    profiles) pick is ``names[costs.max(axis=0).argmin()]``.
    """
    if not results:
        return np.zeros((0, 0), dtype=np.int64), ()
    names = tuple(variants) if variants is not None else tuple(results[0])
    costs = np.array([[res[n].cost for n in names] for res in results],
                     dtype=np.int64)
    return costs, names


def heuristic_indices(names) -> list[int]:
    """Variant columns competing for best/robust picks: the heuristics,
    unless ``asap`` is the sole variant requested (a caller pinned to the
    baseline still gets a pick)."""
    heur = [i for i, n in enumerate(names) if n != "asap"]
    return heur or list(range(len(names)))


def robust_pick(costs: np.ndarray, names) -> tuple[str, int]:
    """The min-max variant of an ensemble cost matrix.

    Returns ``(variant, worst_cost)``: the heuristic variant whose worst
    cost across the ensemble rows is smallest (competing columns per
    :func:`heuristic_indices`).
    """
    names = tuple(names)
    if not names or not len(costs):
        raise ValueError("empty cost matrix")
    heur = heuristic_indices(names)
    worst = np.asarray(costs)[:, heur].max(axis=0)
    j = int(worst.argmin())
    return names[heur[j]], int(worst[j])


def portfolio_starts_batch(preps: list[PreparedInstance], combos=_COMBOS,
                           device=None) -> list[np.ndarray]:
    """Greedy starts for a batch of instances x all variants on the device.

    Instances are grouped by padded shape bucket
    (:func:`repro_torch.core.greedy_torch.pad_dims`); each group runs as
    ONE :func:`~repro_torch.core.greedy_torch.greedy_fanout_grid_torch`
    pass, as the reference's doubly-vmapped jitted call. Returns, aligned
    with ``preps``, int64 arrays of shape [len(combos), N_i].
    """
    from repro_torch.core.greedy_torch import greedy_fanout_grid_torch, \
        pad_budget, pad_dims, pad_masks, pad_orders
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    results: list[np.ndarray | None] = [None] * len(preps)
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(preps):
        groups.setdefault(pad_dims(p.inst.num_tasks, p.profile.T),
                          []).append(i)
    for (_, Tp), idx in groups.items():
        rows = []
        for i in idx:
            p = preps[i]
            if p.graph.lp_is_blocked:
                raise TypeError(
                    "portfolio_starts_batch batches dense-lp instances "
                    "only; blocked-lp (big) instances go through "
                    "greedy_fanout_grid_torch / schedule_portfolio_grid")
            dur, work, lp, est, lst, tail = p.graph.shared(dev)
            masks = pad_masks(np.stack(
                [p.masks[r] for (_, _, r) in combos]), Tp)
            orders = pad_orders(np.stack(
                [p.graph.order_for(s, w) for (s, w, _) in combos]), tail)
            rem0 = pad_budget(
                p.profile.unit_budget(p.inst.idle_total), Tp)
            rows.append((dur, work, lp, rem0[None], masks[None], est, lst,
                         orders))
        starts = greedy_fanout_grid_torch(rows, device=dev)[:, 0]
        starts = starts.cpu().numpy().astype(np.int64)
        for b, i in enumerate(idx):
            results[i] = starts[b][:, :preps[i].inst.num_tasks]
    return results
