"""Pluggable solver layer: one registry behind ``PlanRequest(solver=...)``.

The port of ``repro.core.solvers``. Every solver consumes the same
``(instances x profiles)`` grid and returns the same per-cell ``{variant:
ScheduleResult}`` shape. Registered here:

* ``heuristic`` — the portfolio engine (greedy fan-out + local search);
  the only solver with a variant axis wider than one column, and the only
  one the ``engine=`` knob (numpy/torch/auto) applies to.
* ``asap``      — the paper's §5.1 earliest-start baseline.

The reference's exact oracles (``exact``, ``ilp``, ``dp``) are not ported
yet: requesting one raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.cancel import checkpoint
from repro_torch.core.carbon import schedule_cost, validate_schedule
from repro_torch.core.cawosched import ScheduleResult
from repro_torch.core.estlst import asap_schedule
from repro_torch.core.portfolio import PORTFOLIO_VARIANTS, \
    schedule_portfolio_grid

NOT_PORTED = ("exact", "ilp", "dp")


@dataclasses.dataclass
class SolveOutput:
    """What every solver returns: the dense cell grid + optional bounds.

    ``cells[i][p]`` maps variant name -> :class:`ScheduleResult`;
    ``lower[i, p]`` is a valid int64 lower bound on cell (i, p)'s optimal
    cost, or ``None`` for solvers that cannot certify one. ``timings``
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
                   device=None) -> SolveOutput:
        """Serve the grid. ``cancel`` is an optional
        :class:`repro_torch.core.cancel.CancelToken` polled at the
        solver's chunk boundaries; ``device`` is where device engines
        run."""
        raise NotImplementedError

    def _solve_cells(self, instances, profile_grid, names, validate,
                     cell_fn, cancel=None) -> SolveOutput:
        """Run ``cell_fn(i, inst, profile) -> (start, lower|None)`` over
        the grid and assemble the common single-column output shape."""
        label = _single_label(names, self)
        I, P = len(instances), len(profile_grid[0]) if instances else 0
        lower = np.zeros((I, P), dtype=np.int64)
        any_lower = False
        cells = []
        for i, inst in enumerate(instances):
            row = []
            for p, profile in enumerate(profile_grid[i]):
                checkpoint(cancel)        # per-cell cancellation rung
                t0 = time.perf_counter()
                start, lb = cell_fn(i, inst, profile)
                secs = time.perf_counter() - t0
                start = np.asarray(start, dtype=np.int64)
                if validate:
                    validate_schedule(inst, profile, start)
                cost = schedule_cost(inst, profile, start)
                if lb is not None:
                    lower[i, p] = min(int(lb), cost)
                    any_lower = True
                row.append({label: ScheduleResult(
                    variant=label, start=start, cost=cost, seconds=secs)})
            cells.append(row)
        return SolveOutput(cells=cells, lower=lower if any_lower else None)


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
                   cancel=None, device=None) -> SolveOutput:
        timings: dict = {}
        cells = schedule_portfolio_grid(
            instances, profile_grid, platform, variants=names, k=k, mu=mu,
            validate=validate, engine=engine, graphs=graphs,
            commit_k=commit_k, ls_max_rounds=ls_max_rounds, cancel=cancel,
            device=device, timings=timings)
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
                   cancel=None, device=None) -> SolveOutput:
        ests = [graphs[i].est0 if graphs is not None
                else asap_schedule(inst)
                for i, inst in enumerate(instances)]

        def cell(i, inst, profile):
            return ests[i].copy(), None

        return self._solve_cells(instances, profile_grid, names, validate,
                                 cell, cancel=cancel)


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
    if name in NOT_PORTED and name not in _REGISTRY:
        raise ValueError(
            f"solver {name!r} is not yet ported to repro_torch (the exact "
            f"DP/ILP oracles come with a later slice); registered: "
            f"{solver_names()}")
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
