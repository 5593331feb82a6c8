"""Typed request surface of the Planner API.

The port of ``repro.api.request``. One :class:`PlanRequest` describes a
scheduling scenario — one variant of one instance, the full 17-variant
portfolio, a forecast ensemble, or an instance suite against a profile grid
— and normalizes every accepted spelling to the dense (instances x profiles
x variants) grid that
:func:`repro_torch.core.portfolio.schedule_portfolio_grid` evaluates in one
pass. :func:`crop_profile` restricts a long forecast to a deadline window
(``PlanRequest.deadline_scale``).

This slice serves the fixed-mapping setting on one device: ``mapping``
other than ``"fixed"`` and ``devices`` above 1 raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.carbon import PowerProfile
from repro_torch.core.cawosched import VARIANTS_BY_NAME, deadline_from_asap
from repro_torch.core.dag import Instance

# the reference's mapping axis; only "fixed" (pre-built Instances under
# their baked-in mapping, the paper's setting) is ported so far
MAPPING_MODES = ("fixed", "heft", "search")


@dataclasses.dataclass(frozen=True)
class LocalSearchConfig:
    """Local-search knobs threaded from the Planner into every engine.

    ``mu`` is the paper's +-mu shift radius; ``max_rounds`` bounds the
    gain/commit rounds per hill climb; ``commit_k`` is the device climb's
    commit width — how many proposals a row commits per device round (the
    rest wait a round); ``"auto"`` picks it per instance from its gain
    density (:func:`repro_torch.core.local_search_torch.auto_commit_k`).
    """

    mu: int = 10
    max_rounds: int = 200
    commit_k: int | str = 32

    def __post_init__(self):
        if self.mu < 1 or self.max_rounds < 1:
            raise ValueError("mu, max_rounds must be >= 1")
        if self.commit_k != "auto" and (
                not isinstance(self.commit_k, int) or self.commit_k < 1):
            raise ValueError("commit_k must be an int >= 1 or 'auto'")


def crop_profile(profile: PowerProfile, T: int) -> PowerProfile:
    """Restrict a profile to the deadline window ``[0, T)``.

    The forecast must cover the window (``profile.T >= T``); interval
    structure and budgets inside the window are preserved exactly.
    """
    T = int(T)
    if profile.T == T:
        return profile
    if profile.T < T:
        raise ValueError(
            f"profile horizon {profile.T} is shorter than deadline {T}")
    keep = profile.bounds < T
    bounds = np.append(profile.bounds[keep], T)
    return PowerProfile(bounds=bounds.astype(np.int64),
                        budget=profile.budget[:len(bounds) - 1].copy(),
                        scenario=profile.scenario)


def _as_instances(instances) -> list[Instance]:
    if isinstance(instances, Instance):
        return [instances]
    out = list(instances)
    if not all(isinstance(i, Instance) for i in out):
        raise TypeError("instances must be Instance objects")
    return out


def _as_grid(profiles, I: int) -> list[list[PowerProfile]]:
    """Normalize to one profile list per instance (shared list broadcast)."""
    if isinstance(profiles, PowerProfile):
        return [[profiles] for _ in range(I)]
    rows = list(profiles)
    if not rows:
        raise ValueError("at least one profile is required")
    if isinstance(rows[0], PowerProfile):
        if not all(isinstance(p, PowerProfile) for p in rows):
            raise TypeError("mixed profile spellings in one request")
        return [list(rows) for _ in range(I)]
    grid = [list(ps) for ps in rows]
    if len(grid) != I:
        raise ValueError(
            f"per-instance profiles: got {len(grid)} lists for {I} "
            f"instances")
    return grid


@dataclasses.dataclass
class PlanRequest:
    """One request over the (instances x profiles x variants) grid.

    Accepted spellings (all normalize to the dense grid):

    * ``instances`` — one :class:`Instance` or a sequence of them.
    * ``profiles`` — one :class:`PowerProfile`, a sequence shared by every
      instance, or a per-instance sequence of sequences (every instance
      the same count P; an instance's profiles share its horizon).
    * ``variants`` — ``None`` (the solver's default columns: asap + all 16
      paper variants for the heuristic solver), one name, or a sequence.
    * ``deadline_scale`` — optional: crop every profile to the owning
      instance's deadline ``deadline_scale x ASAP-makespan``.
    * ``robust`` — plan for the min-max pick across the profile axis.
    * ``solver`` — ``"heuristic"`` (default) or ``"asap"``.
    * ``solver_options`` — solver-specific knobs (none used yet).
    * ``mapping`` — ``"fixed"`` only in this port so far; ``"heft"`` and
      ``"search"`` raise ``ValueError``.
    * ``mapping_options`` — must be None (mapping search is not ported).
    * ``devices`` — ``None`` or 1; a sharded multi-device grid is not
      ported yet.
    """

    instances: object
    profiles: object
    variants: object = None
    deadline_scale: float | None = None
    robust: bool = False
    solver: str = "heuristic"
    solver_options: dict | None = None
    mapping: str = "fixed"
    mapping_options: dict | None = None
    devices: int | None = None

    def resolve(self) -> tuple[list[Instance], list[list[PowerProfile]],
                               tuple[str, ...]]:
        """The normalized (instances, profile grid, variant names) triple."""
        if self.mapping not in MAPPING_MODES:
            raise ValueError(
                f"unknown mapping {self.mapping!r}; one of {MAPPING_MODES}")
        if self.mapping != "fixed":
            raise ValueError(
                f"mapping={self.mapping!r} is not yet ported to repro_torch "
                f"(the mapping search comes with a later slice); pass "
                f"mapped Instances with mapping='fixed'")
        if self.mapping_options:
            raise ValueError(
                "mapping_options requires mapping='heft' or 'search', "
                "which repro_torch does not serve yet")
        if self.devices is not None and (
                not isinstance(self.devices, int)
                or isinstance(self.devices, bool) or self.devices < 1):
            raise ValueError(
                f"devices must be a positive int or None, "
                f"got {self.devices!r}")
        if self.devices is not None and self.devices > 1:
            raise ValueError(
                f"devices={self.devices} is not yet ported to repro_torch "
                f"(the multi-device grid comes with a later slice); use "
                f"devices=None or 1")
        instances = _as_instances(self.instances)
        if not instances:
            raise ValueError("at least one instance is required")
        grid = _as_grid(self.profiles, len(instances))
        P = len(grid[0])
        if any(len(ps) != P for ps in grid):
            raise ValueError("every instance needs the same number of "
                             "profiles (dense grid)")
        if self.deadline_scale is not None:
            if self.deadline_scale <= 0:
                raise ValueError(
                    f"deadline_scale must be positive, "
                    f"got {self.deadline_scale!r}")
            grid = [[crop_profile(p, deadline_from_asap(
                        inst, self.deadline_scale)) for p in ps]
                    for inst, ps in zip(instances, grid)]
        for inst, ps in zip(instances, grid):
            if any(p.T != ps[0].T for p in ps):
                raise ValueError(
                    "an instance's profiles must share one horizon")
        from repro_torch.kernels.backend import resolve_solver

        solver = resolve_solver(self.solver)    # raises on unknown solvers
        if self.variants is None:
            names = solver.default_variants()
        elif isinstance(self.variants, str):
            names = (self.variants,)
        else:
            names = tuple(self.variants)
        if not names:
            raise ValueError("at least one variant is required")
        if solver.name == "heuristic":
            for n in names:
                if n != "asap" and n not in VARIANTS_BY_NAME:
                    raise ValueError(f"unknown variant {n!r}")
        elif names != solver.default_variants():
            raise ValueError(
                f"solver {solver.name!r} serves exactly the variant "
                f"column {solver.default_variants()}; drop variants= "
                f"(got {names!r})")
        return instances, grid, names
