"""Pluggable solver layer: one registry behind ``PlanRequest(solver=...)``.

The port of ``repro.core.solvers``. The paper's central experiment
compares the 16 CaWoSched heuristics against a carbon-unaware baseline and
exact oracles; every solver consumes the same ``(instances x profiles)``
grid and returns the same per-cell ``{variant: ScheduleResult}`` shape.
Registered here:

* ``heuristic`` — the portfolio engine (greedy fan-out + local search);
  the only solver with a variant axis wider than one column, and the only
  one the ``engine=`` knob (numpy/torch/auto) applies to.
* ``exact``     — the dispatching oracle: the §4.1 polynomial DP when an
  instance maps onto a single processor chain, the time-indexed ILP
  otherwise. Fills :attr:`SolveOutput.lower` so
  :meth:`repro_torch.api.PlanResult.gap` can report heuristic-vs-optimal
  ratios.
* ``ilp``       — the time-indexed HiGHS MILP (paper §4.3) per cell;
  ``options={"time_limit": s, "mip_gap": g}`` plumb through, and the
  HiGHS dual bound is kept as a valid lower bound even on time-limit
  exits (``lower == cost`` certifies a proven optimum).
* ``dp``        — the §4.1 fully polynomial uniprocessor DP
  (:func:`repro_torch.core.dp_uniproc.dp_poly`); ``options={"check":
  True}`` cross-validates every cell against the pseudo-polynomial oracle
  :func:`~repro_torch.core.dp_uniproc.dp_pseudo`.
* ``asap``      — the paper's §5.1 earliest-start baseline.

The exact oracles run on the host (numpy, scipy's HiGHS) whatever the
planner's device, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.cancel import checkpoint
from repro_torch.core.carbon import schedule_cost, validate_schedule
from repro_torch.core.cawosched import ScheduleResult
from repro_torch.core.dp_uniproc import dp_poly, dp_pseudo, is_uniprocessor
from repro_torch.core.estlst import asap_schedule
from repro_torch.core.portfolio import PORTFOLIO_VARIANTS, \
    schedule_portfolio_grid


@dataclasses.dataclass
class SolveOutput:
    """What every solver returns: the dense cell grid + optional bounds.

    ``cells[i][p]`` maps variant name -> :class:`ScheduleResult`;
    ``lower[i, p]`` is a valid int64 lower bound on cell (i, p)'s optimal
    cost, or ``None`` for solvers that cannot certify one (heuristic,
    asap); ``lower == cost`` certifies a proven optimum for that cell.
    ``mip_gap[i, p]`` is the relative optimality gap the MILP backend
    reported for the cell (0.0 at a proven optimum, >0 on a time-limit /
    mip-gap exit, NaN where the sub-solver reports none). ``timings``
    holds host wall seconds per phase where the solver reports them.
    """

    cells: list                        # I x P of {variant: ScheduleResult}
    lower: np.ndarray | None = None    # int64 [I, P] or None
    mip_gap: np.ndarray | None = None  # float [I, P] or None
    timings: dict = dataclasses.field(default_factory=dict)

    def cost_tensor(self, names) -> np.ndarray:
        """Dense int64 cost tensor ``[I, P, V]`` over the cell grid."""
        names = tuple(names)
        I = len(self.cells)
        P = len(self.cells[0]) if I else 0
        return np.array(
            [[[self.cells[i][p][n].cost for n in names] for p in range(P)]
             for i in range(I)],
            dtype=np.int64).reshape(I, P, len(names))


class Solver:
    """One scheduling backend serving the (instances x profiles) grid.

    Subclasses set ``name`` (the registry key and ``PlanRequest.solver``
    spelling) and ``exact``, and implement :meth:`solve_grid`.
    ``default_variants`` is the variant tuple a request gets when it does
    not pin one.
    """

    name: str = "?"
    exact: bool = False
    # whether solve_grid consumes the Planner's PreparedGraph precompute
    uses_graphs: bool = True

    def default_variants(self) -> tuple[str, ...]:
        return (self.name,)

    def solve_grid(self, instances, profile_grid, platform, names, *,
                   k: int = 3, mu: int = 10, validate: bool = True,
                   engine: str = "numpy", graphs=None, commit_k=None,
                   ls_max_rounds: int = 200,
                   options: dict | None = None, cancel=None,
                   device=None, devices: int | None = None) -> SolveOutput:
        """Serve the grid. ``cancel`` is an optional
        :class:`repro_torch.core.cancel.CancelToken` polled at the
        solver's chunk boundaries; ``device`` is where device engines
        run; ``devices`` splits the heuristic torch engine's grid run
        over that many devices (the per-cell host solvers accept and
        ignore it)."""
        raise NotImplementedError

    def _solve_cells(self, instances, profile_grid, names, validate,
                     cell_fn, cancel=None) -> SolveOutput:
        """Run ``cell_fn(i, inst, profile) -> (start, lower|None[, gap])``
        over the grid and assemble the common single-column output shape."""
        label = _single_label(names, self)
        I, P = len(instances), len(profile_grid[0]) if instances else 0
        lower = np.zeros((I, P), dtype=np.int64)
        gaps = np.full((I, P), np.nan)
        any_lower = any_gap = False
        cells = []
        for i, inst in enumerate(instances):
            row = []
            for p, profile in enumerate(profile_grid[i]):
                checkpoint(cancel)        # per-cell cancellation rung
                t0 = time.perf_counter()
                with obs.span("solve_cell", solver=self.name, i=i, p=p):
                    out = cell_fn(i, inst, profile)
                _CELLS.inc(solver=self.name)
                start, lb = out[0], out[1]
                gap = out[2] if len(out) > 2 else None
                secs = time.perf_counter() - t0
                start = np.asarray(start, dtype=np.int64)
                if validate:
                    validate_schedule(inst, profile, start)
                cost = schedule_cost(inst, profile, start)
                if lb is not None:
                    lower[i, p] = min(int(lb), cost)
                    any_lower = True
                if gap is not None and np.isfinite(gap):
                    gaps[i, p] = float(gap)
                    any_gap = True
                row.append({label: ScheduleResult(
                    variant=label, start=start, cost=cost, seconds=secs)})
            cells.append(row)
        return SolveOutput(cells=cells,
                           lower=lower if any_lower else None,
                           mip_gap=gaps if any_gap else None)


_CELLS = obs.registry().counter(
    "solver_cells_total", "grid cells served, by solver backend",
    labels=("solver",))


def _single_label(names, solver: Solver) -> str:
    names = tuple(names)
    if len(names) != 1:
        raise ValueError(
            f"solver {solver.name!r} produces exactly one variant column, "
            f"got {names!r}")
    return names[0]


class HeuristicSolver(Solver):
    """The portfolio engine (:func:`schedule_portfolio_grid`) as one
    registered backend: asap + the 16 paper variants, numpy or torch."""

    name = "heuristic"
    exact = False

    def default_variants(self) -> tuple[str, ...]:
        return tuple(PORTFOLIO_VARIANTS)

    def solve_grid(self, instances, profile_grid, platform, names, *,
                   k=3, mu=10, validate=True, engine="numpy", graphs=None,
                   commit_k=None, ls_max_rounds=200, options=None,
                   cancel=None, device=None, devices=None) -> SolveOutput:
        timings: dict = {}
        cells = schedule_portfolio_grid(
            instances, profile_grid, platform, variants=names, k=k, mu=mu,
            validate=validate, engine=engine, graphs=graphs,
            commit_k=commit_k, ls_max_rounds=ls_max_rounds, cancel=cancel,
            device=device, timings=timings, devices=devices)
        return SolveOutput(cells=cells, lower=None, timings=timings)


class AsapSolver(Solver):
    """The paper's §5.1 baseline: start every task at its EST.

    Independent of the portfolio machinery (it needs no profile overlay,
    no score orders, no masks), so the regression floor stays meaningful
    even when the heuristic engine changes underneath it.
    """

    name = "asap"
    exact = False

    def solve_grid(self, instances, profile_grid, platform, names, *,
                   k=3, mu=10, validate=True, engine="numpy", graphs=None,
                   commit_k=None, ls_max_rounds=200, options=None,
                   cancel=None, device=None, devices=None) -> SolveOutput:
        ests = [graphs[i].est0 if graphs is not None
                else asap_schedule(inst)
                for i, inst in enumerate(instances)]

        def cell(i, inst, profile):
            return ests[i].copy(), None

        return self._solve_cells(instances, profile_grid, names, validate,
                                 cell, cancel=cancel)


class DpUniprocSolver(Solver):
    """The §4.1 fully polynomial uniprocessor DP (:func:`dp_poly`).

    Exact on any instance whose fixed mapping is a single processor
    chain; ``options={"check": True}`` re-solves every cell with the
    pseudo-polynomial oracle :func:`dp_pseudo` and asserts agreement.
    """

    name = "dp"
    exact = True
    uses_graphs = False

    def solve_grid(self, instances, profile_grid, platform, names, *,
                   k=3, mu=10, validate=True, engine="numpy", graphs=None,
                   commit_k=None, ls_max_rounds=200, options=None,
                   cancel=None, device=None, devices=None) -> SolveOutput:
        check = bool((options or {}).get("check", False))
        for inst in instances:
            if not is_uniprocessor(inst):
                raise ValueError(
                    "solver='dp' requires a single-processor-chain "
                    "instance with one shared work power; use "
                    "solver='exact' (auto-dispatch) or 'ilp' for "
                    "multiprocessor instances")

        def cell(i, inst, profile):
            cost, start = dp_poly(inst, profile)
            if check:    # explicit raises: must survive python -O
                ref_cost, ref_start = dp_pseudo(inst, profile)
                if ref_cost != cost:
                    raise AssertionError(
                        f"dp_poly={cost} != dp_pseudo={ref_cost} "
                        f"(instance {i})")
                if schedule_cost(inst, profile, ref_start) != ref_cost:
                    raise AssertionError(
                        f"dp_pseudo schedule does not cost {ref_cost} "
                        f"(instance {i})")
            return start, cost

        return self._solve_cells(instances, profile_grid, names, validate,
                                 cell, cancel=cancel)


class IlpSolver(Solver):
    """The time-indexed HiGHS MILP (paper §4.3), one solve per cell.

    ``options``: ``time_limit`` (seconds, default
    :data:`IlpSolver.DEFAULT_TIME_LIMIT`) and ``mip_gap`` (relative,
    default 0) plumb straight into HiGHS. The reported cost is
    the exact integer cost of the incumbent schedule; the per-cell lower
    bound is the HiGHS dual bound (rounded up — costs are integral), so a
    time-limited solve still yields a certified gap, and ``lower == cost``
    certifies optimality. A time-limit exit WITH an incumbent is a
    degraded success, not a failure: the cell's ``mip_gap`` carries the
    HiGHS relative gap so the serving tier can flag the result degraded
    while still returning the schedule + bound certificate. Paper's own
    scope note applies: exact solves are only run on small instances.
    """

    name = "ilp"
    exact = True
    uses_graphs = False
    DEFAULT_TIME_LIMIT = 300.0

    def solve_grid(self, instances, profile_grid, platform, names, *,
                   k=3, mu=10, validate=True, engine="numpy", graphs=None,
                   commit_k=None, ls_max_rounds=200, options=None,
                   cancel=None, device=None, devices=None) -> SolveOutput:
        from repro_torch.core.ilp import solve_ilp  # lazy: needs HiGHS

        opts = options or {}
        time_limit = float(opts.get("time_limit", self.DEFAULT_TIME_LIMIT))
        mip_gap = float(opts.get("mip_gap", 0.0))

        def cell(i, inst, profile):
            res = solve_ilp(inst, profile, time_limit=time_limit,
                            mip_gap=mip_gap, cancel=cancel)
            if not np.isfinite(res.cost):
                raise ValueError(
                    f"ILP produced no feasible schedule for instance "
                    f"{i} within time_limit={time_limit}s (raise it to "
                    f"keep the rest of the grid): {res.message}")
            lb = res.lower_bound
            if not np.isfinite(lb):
                # no dual-bound progress: only a HiGHS-proven optimum may
                # certify itself; otherwise 0 is the honest valid bound
                # (never falsely reports lower == cost on an unproven
                # incumbent)
                lb = res.cost if res.status == 0 else 0.0
            gap = res.mip_gap
            if not np.isfinite(gap):
                # a proven optimum has zero gap even when HiGHS omits the
                # field; an unproven incumbent keeps NaN (gap unknown)
                gap = 0.0 if res.status == 0 else float("nan")
            # integral costs: round the continuous dual bound up
            return res.start, int(np.ceil(lb - 1e-6)), gap

        return self._solve_cells(instances, profile_grid, names, validate,
                                 cell, cancel=cancel)


class ExactSolver(Solver):
    """The auto-dispatching oracle: DP on uniprocessor chains, ILP else.

    Per-instance dispatch (one request may mix both regimes); every cell
    carries the sub-solver's lower bound under the shared ``"exact"``
    column, so one ``plan(solver="exact")`` call serves the paper's full
    gap-to-optimal evaluation regardless of the mapping shape.
    """

    name = "exact"
    exact = True
    uses_graphs = False

    def solve_grid(self, instances, profile_grid, platform, names, *,
                   k=3, mu=10, validate=True, engine="numpy", graphs=None,
                   commit_k=None, ls_max_rounds=200, options=None,
                   cancel=None, device=None, devices=None) -> SolveOutput:
        label = _single_label(names, self)
        I = len(instances)
        P = len(profile_grid[0]) if instances else 0
        cells: list = [None] * I
        lower = np.zeros((I, P), dtype=np.int64)
        gaps = np.full((I, P), np.nan)
        any_gap = False
        for i, inst in enumerate(instances):
            checkpoint(cancel)           # per-instance dispatch rung
            sub = DP if is_uniprocessor(inst) else ILP
            out = sub.solve_grid(
                [inst], [profile_grid[i]], platform, (label,), k=k, mu=mu,
                validate=validate, engine=engine,
                graphs=None if graphs is None else [graphs[i]],
                commit_k=commit_k, ls_max_rounds=ls_max_rounds,
                options=options, cancel=cancel, device=device)
            cells[i] = out.cells[0]
            lower[i] = out.lower[0]
            if out.mip_gap is not None:
                gaps[i] = out.mip_gap[0]
                any_gap = True
        return SolveOutput(cells=cells, lower=lower,
                           mip_gap=gaps if any_gap else None)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Solver] = {}


def register_solver(solver: Solver) -> Solver:
    """Add a solver to the registry (``PlanRequest(solver=name)``)."""
    if not solver.name or solver.name == "?":
        raise ValueError("solver needs a name")
    _REGISTRY[solver.name] = solver
    return solver


def get_solver(name: str) -> Solver:
    """Registry lookup; raises with the known names on a miss."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered: {solver_names()}"
        ) from None


def solver_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


HEURISTIC = register_solver(HeuristicSolver())
ASAP = register_solver(AsapSolver())
DP = register_solver(DpUniprocSolver())
ILP = register_solver(IlpSolver())
EXACT = register_solver(ExactSolver())
