"""CaWoSched public API: the baseline + all 16 heuristic variants (paper §5).

Variant names follow the paper: ``{slack|press}[W][R][-LS]``
  W  = power-weighted score,  R = refined interval subdivision,
  -LS = local search applied after the greedy.
``asap`` is the carbon-unaware baseline.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.dag import Instance
from repro_torch.core.estlst import asap_schedule, makespan


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


def deadline_from_asap(inst: Instance, factor: float) -> int:
    """Deadline = factor * ASAP makespan (paper's D, 1.5D, 2D, 3D)."""
    return int(np.ceil(factor * makespan(inst, asap_schedule(inst))))
