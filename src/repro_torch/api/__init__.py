"""Unified Planner API of the port: one ``PlanRequest -> PlanResult``
surface.

    from repro_torch.api import Planner, PlanRequest

    planner = Planner(platform)          # engine="auto", on the card
    res = planner.plan(PlanRequest(instances=inst, profiles=ensemble))
    best = res.best()                    # nominal cheapest
    variant, worst = res.robust()        # min-max across members

The ``solver=`` axis serves the paper's heuristics-vs-baseline-vs-exact
evaluation (``solver="exact"``, ``PlanResult.gap``), and
:class:`PlanningSession` (``planner.session(...)``) replans a rolling
horizon, planning window k+1 while window k executes.
"""
from repro_torch.api.planner import Planner  # noqa: F401
from repro_torch.api.request import (  # noqa: F401
    LocalSearchConfig,
    MAPPING_MODES,
    PlanRequest,
    crop_profile,
    window_profile,
)
from repro_torch.api.result import PlanResult  # noqa: F401
from repro_torch.api.session import PlanningSession  # noqa: F401
