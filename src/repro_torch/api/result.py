"""Dense result surface of the Planner API.

The port of ``repro.api.result``: a dense integer cost tensor indexed
``[instance, profile, variant]`` plus the per-cell schedules and timings,
with accessors for the common reads (nominal best, robust min-max pick, a
printable table).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cawosched import ScheduleResult
from repro_torch.core.portfolio import heuristic_indices, robust_pick


def _mapping_info_from_wire(m: dict | None):
    if not m or m.get("info") is None:
        return None
    from repro_torch.mapping.search import MappingSearchInfo

    return tuple(MappingSearchInfo.from_dict(x) for x in m["info"])


@dataclasses.dataclass
class PlanResult:
    """The (instances x profiles x variants) planning grid, densely.

    ``costs[i, p, v]`` is the carbon cost of scheduling instance i against
    profile p under variant ``variants[v]``; ``results[i][p]`` maps each
    variant name to its full :class:`ScheduleResult` (start times, cost,
    seconds). ``engine`` records the backend that actually ran (after
    ``"auto"`` resolution); ``seconds`` is the wall clock of the whole
    plan call.

    ``solver`` is the registered backend that produced the grid
    (:mod:`repro_torch.core.solvers`); exact solvers fill ``lower_bound`` with
    a valid per-cell bound on the optimal cost (``lower_bound == cost``
    certifies a proven optimum), which :meth:`gap` and :meth:`compare`
    consume to report heuristic-vs-optimal quality. ``mip_gap`` is the
    MILP backend's relative per-cell gap (0.0 proven, >0 on time-limit
    exits, NaN unknown) — present only on ilp/exact results.

    ``degraded``/``fallback_stage``/``attempts`` are the reference's
    serving-tier degradation record; plans straight from
    :meth:`Planner.plan` leave them at their defaults. ``phase_seconds``
    holds the host wall seconds per phase of the heuristic solver (see
    :func:`repro_torch.core.portfolio.schedule_portfolio_grid`).
    """

    variants: tuple[str, ...]
    results: list                       # I x P of {variant: ScheduleResult}
    costs: np.ndarray                   # int64 [I, P, V]
    engine: str
    seconds: float
    robust_requested: bool = False
    solver: str = "heuristic"
    lower_bound: np.ndarray | None = None   # int64 [I, P] (exact solvers)
    mip_gap: np.ndarray | None = None       # float [I, P] (ilp/exact)
    degraded: bool = False                  # service fallback record
    fallback_stage: str | None = None
    attempts: tuple[str, ...] = ()
    # mapping axis (repro_torch.mapping): how the task->processor mapping
    # was chosen. "fixed" = baked into the request's Instances (the paper's
    # setting); "heft"/"search" resolved it inside the plan — `mappings`
    # then carries the winning FixedMapping per instance and
    # `mapping_info` the search provenance (rounds, candidates evaluated,
    # improvement trace). Schedules in `results` are under the winning
    # mapping's instance.
    mapping_mode: str = "fixed"
    mappings: tuple | None = None           # FixedMapping per instance
    mapping_info: tuple | None = None       # MappingSearchInfo per instance
    phase_seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> tuple[int, int, int]:
        """(instances, profiles, variants)."""
        return tuple(self.costs.shape)

    # --- RPC-ready wire shape -------------------------------------------

    def summary_dict(self) -> dict:
        """The JSON-safe wire summary of this result (no schedules).

        Everything an RPC front needs to route on — the cost tensor, the
        degradation record (``degraded``/``fallback_stage``/``attempts``),
        and the bound certificates — as plain lists/ints/floats/None:
        ``json.dumps`` round-trips it byte-for-byte, and
        :meth:`summary_from_dict` restores an equivalent summary-level
        result (``restored.summary_dict() == d``). NaN gap cells travel
        as ``None`` (JSON has no NaN).
        """
        def grid(a, none_nan=False):
            if a is None:
                return None
            a = np.asarray(a)
            if none_nan:
                return [[None if not np.isfinite(x) else float(x)
                         for x in row] for row in a]
            return [[int(x) for x in row] for row in a]

        return {
            "variants": list(self.variants),
            "costs": [grid(self.costs[i]) for i in range(len(self.costs))],
            "engine": self.engine,
            "seconds": float(self.seconds),
            "robust_requested": bool(self.robust_requested),
            "solver": self.solver,
            "lower_bound": grid(self.lower_bound),
            "mip_gap": grid(self.mip_gap, none_nan=True),
            "degraded": bool(self.degraded),
            "fallback_stage": self.fallback_stage,
            "attempts": list(self.attempts),
            # FixedMappings themselves don't travel (array-heavy); the
            # mode + per-instance search provenance do
            "mapping": {
                "mode": self.mapping_mode,
                "info": None if self.mapping_info is None else
                        [inf.to_dict() for inf in self.mapping_info],
            },
        }

    @classmethod
    def summary_from_dict(cls, d: dict) -> "PlanResult":
        """Rebuild a summary-level result from :meth:`summary_dict`.

        Schedules do not travel on the wire, so ``results`` comes back
        empty; every other field (including the cost tensor and the
        degradation record) round-trips losslessly —
        ``cls.summary_from_dict(d).summary_dict() == d``.
        """
        def arr(g, dtype=np.int64, nan_none=False):
            if g is None:
                return None
            if nan_none:
                return np.array([[np.nan if x is None else float(x)
                                  for x in row] for row in g], dtype=dtype)
            return np.asarray(g, dtype=dtype)

        return cls(
            variants=tuple(d["variants"]),
            results=[],
            costs=np.asarray(d["costs"], dtype=np.int64),
            engine=d["engine"],
            seconds=float(d["seconds"]),
            robust_requested=bool(d["robust_requested"]),
            solver=d["solver"],
            lower_bound=arr(d.get("lower_bound")),
            mip_gap=arr(d.get("mip_gap"), dtype=np.float64, nan_none=True),
            degraded=bool(d["degraded"]),
            fallback_stage=d.get("fallback_stage"),
            attempts=tuple(d.get("attempts", ())),
            mapping_mode=(d.get("mapping") or {}).get("mode", "fixed"),
            mapping_info=_mapping_info_from_wire(d.get("mapping")),
        )

    def result(self, instance: int = 0, profile: int = 0,
               variant: str | None = None) -> ScheduleResult:
        """One cell's :class:`ScheduleResult` (default: the cell's best)."""
        if variant is None:
            return self.best(instance, profile)
        return self.results[instance][profile][variant]

    def starts(self, instance: int = 0, profile: int = 0) -> dict:
        """``{variant: start times}`` of one (instance, profile) cell."""
        return {n: r.start for n, r in self.results[instance][profile]
                .items()}

    def cost_matrix(self, instance: int = 0
                    ) -> tuple[np.ndarray, tuple[str, ...]]:
        """One instance's [P, V] ensemble x variant cost matrix + names
        (the shape :func:`repro_torch.core.portfolio.robust_pick` consumes)."""
        return self.costs[instance], self.variants

    def best(self, instance: int = 0, profile: int = 0) -> ScheduleResult:
        """The cheapest heuristic variant of one (instance, profile) cell
        (``asap`` competes only when it is the sole variant)."""
        heur = heuristic_indices(self.variants)
        row = self.costs[instance, profile, heur]
        name = self.variants[heur[int(np.argmin(row))]]
        return self.results[instance][profile][name]

    def robust(self, instance: int = 0) -> tuple[str, int]:
        """The min-max variant across the instance's profile axis:
        ``(variant, worst_cost)`` minimizing the worst ensemble cost."""
        return robust_pick(self.costs[instance], self.variants)

    def pick(self, instance: int = 0) -> ScheduleResult:
        """The schedule to execute, under the request's planning mode:
        the robust variant's nominal-profile schedule when the request
        asked for ``robust=True``, else the nominal-profile best."""
        if self.robust_requested:
            name, _ = self.robust(instance)
            return self.results[instance][0][name]
        return self.best(instance, 0)

    def best_costs(self) -> np.ndarray:
        """Per-cell best competing cost, int64 [I, P] (the min across the
        columns :func:`repro_torch.core.portfolio.heuristic_indices`
        admits)."""
        heur = heuristic_indices(self.variants)
        return self.costs[:, :, heur].min(axis=2)

    def gap(self, exact: "PlanResult | None" = None) -> np.ndarray:
        """Optimality-gap ratios, float [I, P]: per-cell best cost over
        the optimal-cost lower bound (1.0 = provably optimal).

        The bound comes from ``exact`` — a second :class:`PlanResult` of
        the same (instances x profiles) grid planned with an exact solver
        (``plan(request, solver="exact")``) — or, when ``exact`` is
        omitted, from this result's own ``lower_bound`` (set when this
        result itself came from an exact solver). Cells with a zero bound
        follow the paper's convention: 1.0 when the best cost is also
        zero, ``inf`` otherwise.
        """
        if exact is not None:
            if exact.costs.shape[:2] != self.costs.shape[:2]:
                raise ValueError(
                    f"grid shapes differ: {self.costs.shape[:2]} vs "
                    f"{exact.costs.shape[:2]}")
            lb = exact.lower_bound if exact.lower_bound is not None \
                else exact.best_costs()
        else:
            lb = self.lower_bound
        if lb is None:
            raise ValueError(
                "no lower bound available: pass an exact PlanResult "
                "(e.g. plan(..., solver='exact')) to gap()")
        best = self.best_costs().astype(np.float64)
        lb = np.asarray(lb, dtype=np.float64)
        out = np.where(best <= 0, 1.0, np.inf)
        pos = lb > 0
        out[pos] = best[pos] / lb[pos]
        return out

    def compare(self, other: "PlanResult", instance: int = 0,
                profile: int = 0) -> str:
        """Printable quality table of one cell: every variant of this
        result against ``other``'s best cost in the same cell (typically
        an exact plan — the paper's heuristics-vs-baseline-vs-exact
        evaluation in one string). Ratios follow :meth:`gap`'s zero-cost
        conventions; a trailing line reports whether ``other``'s bound
        certifies optimality for the cell.
        """
        ref = int(other.best_costs()[instance, profile])
        lines = [f"{'variant':<12} {'cost':>10} {other.solver:>10} "
                 f"{'ratio':>8}"]
        for v, name in enumerate(self.variants):
            c = int(self.costs[instance, profile, v])
            r = c / ref if ref > 0 else (1.0 if c <= 0 else float("inf"))
            lines.append(f"{name:<12} {c:>10} {ref:>10} {r:>8.3f}")
        if other.lower_bound is not None:
            lb = int(other.lower_bound[instance, profile])
            lines.append(f"[{other.solver}] lower bound {lb} "
                         f"({'proven optimal' if lb >= ref else 'gap open'})")
        return "\n".join(lines)

    def table(self, instance: int = 0) -> str:
        """Printable per-variant summary of one instance: nominal cost,
        worst ensemble cost, and mean planning seconds per profile."""
        lines = [f"{'variant':<12} {'nominal':>10} {'worst':>10} "
                 f"{'ms':>8}"]
        P = self.costs.shape[1]
        for v, name in enumerate(self.variants):
            col = self.costs[instance, :, v]
            secs = sum(self.results[instance][p][name].seconds
                       for p in range(P)) / max(P, 1)
            lines.append(f"{name:<12} {int(col[0]):>10} "
                         f"{int(col.max()):>10} {secs * 1e3:>8.1f}")
        return "\n".join(lines)
