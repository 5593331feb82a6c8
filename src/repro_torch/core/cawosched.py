"""CaWoSched public API: the baseline + all 16 heuristic variants (paper §5).

Variant names follow the paper: ``{slack|press}[W][R][-LS]``
  W  = power-weighted score,  R = refined interval subdivision,
  -LS = local search applied after the greedy.
``asap`` is the carbon-unaware baseline.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from repro_torch.cluster import Platform
from repro_torch.core.carbon import PowerProfile, schedule_cost, \
    validate_schedule
from repro_torch.core.dag import Instance
from repro_torch.core.estlst import asap_schedule, makespan
from repro_torch.core.greedy import greedy_schedule
from repro_torch.core.local_search import local_search


@dataclasses.dataclass(frozen=True)
class Variant:
    score: str          # "slack" | "press"
    weighted: bool
    refined: bool
    ls: bool

    @property
    def name(self) -> str:
        return (self.score + ("W" if self.weighted else "")
                + ("R" if self.refined else "")
                + ("-LS" if self.ls else ""))


ALL_VARIANTS: tuple[Variant, ...] = tuple(
    Variant(score=s, weighted=w, refined=r, ls=l)
    for s, w, r, l in itertools.product(
        ("slack", "press"), (False, True), (False, True), (False, True))
)

VARIANTS_BY_NAME = {v.name: v for v in ALL_VARIANTS}


@dataclasses.dataclass
class ScheduleResult:
    variant: str
    start: np.ndarray
    cost: int
    seconds: float


def schedule(inst: Instance, profile: PowerProfile, platform: Platform,
             variant: str = "pressWR-LS", k: int = 3, mu: int = 10,
             validate: bool = True, device=None) -> ScheduleResult:
    """Run one algorithm variant (or ``asap``) on an instance.

    .. deprecated:: legacy shim over :class:`repro_torch.api.Planner` (the
       1 x 1 x 1 request shape, numpy engine); prefer ``Planner(platform)
       .plan(PlanRequest(...))``. ``device`` is the planner's (None = the
       card). :func:`schedule_reference` is the independent sequential
       oracle.
    """
    from repro_torch.api import LocalSearchConfig, Planner, PlanRequest

    res = Planner(platform, engine="numpy", k=k,
                  ls=LocalSearchConfig(mu=mu), validate=validate,
                  device=device).plan(
        PlanRequest(instances=inst, profiles=profile, variants=(variant,)))
    return res.results[0][0][variant]


def schedule_reference(inst: Instance, profile: PowerProfile,
                       platform: Platform, variant: str = "pressWR-LS",
                       k: int = 3, mu: int = 10,
                       validate: bool = True) -> ScheduleResult:
    """The paper's sequential per-variant pipeline, verbatim.

    Kept as an independent oracle: no shared precompute, no segment lists,
    no device fan-out — the per-unit greedy plus the sequential local
    search exactly as §5 states them.
    """
    t0 = time.perf_counter()
    if variant == "asap":
        start = asap_schedule(inst)
    else:
        v = VARIANTS_BY_NAME[variant]
        start = greedy_schedule(inst, profile, platform, score=v.score,
                                weighted=v.weighted, refined=v.refined, k=k)
        if v.ls:
            start = local_search(inst, profile, platform, start, mu=mu)
    dt = time.perf_counter() - t0
    if validate:
        validate_schedule(inst, profile, start)
    return ScheduleResult(variant=variant, start=start,
                          cost=schedule_cost(inst, profile, start),
                          seconds=dt)


def deadline_from_asap(inst: Instance, factor: float) -> int:
    """Deadline = factor * ASAP makespan (paper's D, 1.5D, 2D, 3D)."""
    return int(np.ceil(factor * makespan(inst, asap_schedule(inst))))
