"""Unified Planner API of the port: one ``PlanRequest -> PlanResult``
surface.

    from repro_torch.api import Planner, PlanRequest

    planner = Planner(platform)          # engine="auto", on the card
    res = planner.plan(PlanRequest(instances=inst, profiles=ensemble))
    best = res.best()                    # nominal cheapest
    variant, worst = res.robust()        # min-max across members
"""
from repro_torch.api.planner import Planner  # noqa: F401
from repro_torch.api.request import (  # noqa: F401
    LocalSearchConfig,
    MAPPING_MODES,
    PlanRequest,
    crop_profile,
)
from repro_torch.api.result import PlanResult  # noqa: F401
