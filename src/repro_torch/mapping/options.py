"""Validated knobs for the mapping search.

Kept dependency-free so `api.request` can validate `mapping_options`
at admission time without pulling in the search machinery.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

_OBJECTIVES = ("auto", "best", "robust")


@dataclass(frozen=True)
class MappingOptions:
    """Knobs for ``PlanRequest(mapping="search", mapping_options=...)``.

    seeds      -- size of the seed mapping population (HEFT + carbon-aware
                  variants + random perturbations), >= 1
    rounds     -- max neighborhood-improvement rounds, >= 0 (0 = seeds only)
    neighbors  -- candidate mappings generated per round, >= 1
    elite      -- elite set size carried between rounds, >= 1
    patience   -- stop after this many rounds without improvement, >= 1
    seed       -- RNG seed; the whole search is bit-reproducible per seed
    objective  -- elite ranking: "best" (min over profiles), "robust"
                  (minimax over profiles), or "auto" (follow the
                  request's `robust` flag)
    """

    seeds: int = 6
    rounds: int = 4
    neighbors: int = 12
    elite: int = 3
    patience: int = 2
    seed: int = 0
    objective: str = "auto"

    def __post_init__(self):
        for name, lo in (("seeds", 1), ("rounds", 0), ("neighbors", 1),
                         ("elite", 1), ("patience", 1), ("seed", 0)):
            val = getattr(self, name)
            if not isinstance(val, int) or isinstance(val, bool) or val < lo:
                raise ValueError(
                    f"mapping_options[{name!r}] must be an int >= {lo}, "
                    f"got {val!r}")
        if self.objective not in _OBJECTIVES:
            raise ValueError(
                f"mapping_options['objective'] must be one of "
                f"{_OBJECTIVES}, got {self.objective!r}")

    def max_candidates(self) -> int:
        """Upper bound on mappings this search evaluates: the seed
        population plus every improvement round's full neighborhood."""
        return self.seeds + self.rounds * self.neighbors

    def shrunk_to(self, budget: int) -> "MappingOptions | None":
        """The largest version of this search evaluating <= ``budget``
        candidates — the serving tier's budget-aware degradation knob
        (fallback rungs shrink the search to the remaining deadline
        budget before dropping to plain HEFT).

        Shrinks ``rounds`` first (keep the seed population, run fewer
        improvement passes), then ``neighbors``, then ``seeds``.
        Returns ``self`` when it already fits, ``None`` when even a
        2-candidate search (HEFT seed + one alternative) does not —
        callers should fall back to plain HEFT then.
        """
        if budget >= self.max_candidates():
            return self
        if budget < 2:
            return None
        seeds = min(self.seeds, budget)
        left = budget - seeds
        neighbors = min(self.neighbors, max(left, 1))
        rounds = min(self.rounds, left // neighbors)
        return MappingOptions(
            seeds=seeds, rounds=rounds, neighbors=neighbors,
            elite=min(self.elite, seeds), patience=self.patience,
            seed=self.seed, objective=self.objective)

    @classmethod
    def from_dict(cls, options: "dict | MappingOptions | None") -> "MappingOptions":
        """Build from a request-supplied dict, rejecting unknown keys."""
        if options is None:
            return cls()
        if isinstance(options, cls):
            return options
        if not isinstance(options, dict):
            raise ValueError(
                f"mapping_options must be a dict, got {type(options).__name__}")
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(options) - known)
        if unknown:
            raise ValueError(
                f"unknown mapping_options keys {unknown}; "
                f"allowed: {sorted(known)}")
        return cls(**options)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}
