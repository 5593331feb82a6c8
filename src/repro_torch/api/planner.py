"""The Planner facade: one ``plan(PlanRequest) -> PlanResult`` surface.

The port of ``repro.api.planner``. ``Planner(platform)`` owns everything
amortizable across plan calls — a bounded cache of
:class:`~repro_torch.core.portfolio.PreparedGraph` precomputes (keyed by
instance identity and horizon), the engine, the device and the
local-search configuration — and serves every request shape through ONE
code path (:func:`repro_torch.core.portfolio.schedule_portfolio_grid`):
``1 x 1 x 1``, ``1 x 1 x 17``, ``1 x P x 17`` and ``I x P x 17`` grids.

``engine="auto"`` resolves per request through
:func:`repro_torch.kernels.backend.resolve_engine`: the device engine
(``"torch"``) as soon as the request has more than one (instance,
profile) cell. The planner runs on the card unless it is given
``device="cpu"``: ``device=None`` resolves to ``cuda`` and raises when no
GPU is present.
"""
from __future__ import annotations

import collections
import threading
import time

from repro_torch.api.request import LocalSearchConfig, PlanRequest
from repro_torch.api.result import PlanResult
from repro_torch.core.portfolio import PreparedGraph, prepare_graph
from repro_torch.kernels.backend import resolve_device, resolve_engine, \
    resolve_solver


class Planner:
    """Compile instances once, then serve any (I x P x V) plan request.

    Args:
      platform: the fixed-mapping platform every request schedules on.
      engine: ``"numpy"``, ``"torch"``, or ``"auto"`` (the device engine as
        soon as the request has more than one (instance, profile) cell).
      k: refined-subdivision granularity (paper's k).
      ls: :class:`LocalSearchConfig` — mu, round budget, and the device
        climb's commit width.
      validate: assert precedence + deadline feasibility of every
        produced schedule.
      graph_cache: how many ``PreparedGraph`` precomputes to keep (FIFO).
        A cached graph pins its instance, so equal ``id()`` keys cannot
        collide while an entry lives.
      lp_budget_bytes: the torch engine's per-instance longest-path memory
        envelope (None = :data:`repro_torch.core.greedy_torch.LP_MAX_BYTES`);
        bigger instances stream the blocked form bit-identically.
      device: where the torch engine runs. ``None`` means the card
        (``cuda``) and raises when no GPU is present; pass ``"cpu"`` to run
        the plain PyTorch path on the CPU.
    """

    def __init__(self, platform, engine: str = "auto", k: int = 3,
                 ls: LocalSearchConfig | None = None, validate: bool = True,
                 graph_cache: int = 32,
                 lp_budget_bytes: int | None = None, device=None):
        resolve_engine(engine)              # fail fast on unknown engines
        self.device = resolve_device(device)
        self.platform = platform
        self.engine = engine
        self.k = int(k)
        self.ls = ls if ls is not None else LocalSearchConfig()
        self.validate = validate
        self.lp_budget_bytes = lp_budget_bytes
        self._graph_cache = int(graph_cache)
        self._graphs: collections.OrderedDict[tuple, PreparedGraph] = \
            collections.OrderedDict()
        # the graph cache is shared mutable state; only its bookkeeping is
        # locked, planning itself runs outside the lock
        self._cache_lock = threading.Lock()

    def clone(self, *, engine: str | None = None,
              lp_budget_bytes: int | None = None) -> "Planner":
        """A planner with this one's configuration but its own caches."""
        return Planner(self.platform,
                       engine=self.engine if engine is None else engine,
                       k=self.k, ls=self.ls, validate=self.validate,
                       graph_cache=self._graph_cache,
                       lp_budget_bytes=self.lp_budget_bytes
                       if lp_budget_bytes is None else lp_budget_bytes,
                       device=self.device)

    # --- PreparedGraph cache ---------------------------------------------

    def prepared(self, inst, T: int) -> PreparedGraph:
        """The cached profile-independent precompute of ``(inst, T)``."""
        key = (id(inst), int(T), self.k)
        with self._cache_lock:
            g = self._graphs.get(key)
            if g is not None and g.inst is inst:
                self._graphs.move_to_end(key)
                return g
        g = prepare_graph(inst, self.platform, int(T), k=self.k,
                          lp_budget_bytes=self.lp_budget_bytes)
        self.seed_graph(g)
        return g

    def seed_graph(self, graph: PreparedGraph) -> None:
        """Adopt an externally prepared graph; it must match this
        planner's platform and k."""
        with self._cache_lock:
            cap = max(self._graph_cache, 1)  # always hold the current graph
            while self._graphs and len(self._graphs) >= cap:
                self._graphs.popitem(last=False)
            self._graphs[(id(graph.inst), graph.T, graph.k)] = graph

    # --- planning --------------------------------------------------------

    def plan(self, request: PlanRequest | None = None, /,
             cancel=None, **kw) -> PlanResult:
        """Evaluate one request grid; see :class:`PlanRequest`.

        ``plan(instances=..., profiles=..., ...)`` builds the request
        inline; passing a prebuilt :class:`PlanRequest` is equivalent.
        ``cancel`` (an optional :class:`repro_torch.core.cancel
        .CancelToken`) is threaded into the solver, which polls it at its
        chunk boundaries.
        """
        if request is None:
            request = PlanRequest(**kw)
        elif kw:
            raise TypeError("pass a PlanRequest or keywords, not both")
        t0 = time.perf_counter()
        instances, grid, names = request.resolve()
        solver = resolve_solver(request.solver)
        I = len(instances)
        P = len(grid[0]) if I else 0
        # engine= is the heuristic solver's sub-knob; only graph-consuming
        # solvers pay for (and cache) the PreparedGraph precompute
        engine = resolve_engine(self.engine, fanout=I * P) \
            if solver.name == "heuristic" else "numpy"
        t_graph = time.perf_counter()
        graphs = [self.prepared(inst, ps[0].T)
                  for inst, ps in zip(instances, grid)] \
            if solver.uses_graphs else None
        t_graph = time.perf_counter() - t_graph
        out = solver.solve_grid(
            instances, grid, self.platform, names, k=self.k,
            mu=self.ls.mu, validate=self.validate, engine=engine,
            graphs=graphs, commit_k=self.ls.commit_k,
            ls_max_rounds=self.ls.max_rounds,
            options=request.solver_options, cancel=cancel,
            device=self.device)
        return PlanResult(variants=names, results=out.cells,
                          costs=out.cost_tensor(names), engine=engine,
                          seconds=time.perf_counter() - t0,
                          robust_requested=bool(request.robust),
                          solver=solver.name, lower_bound=out.lower,
                          mip_gap=out.mip_gap,
                          mapping_mode=request.mapping,
                          phase_seconds={"graphs": t_graph, **out.timings})
