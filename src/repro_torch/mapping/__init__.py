"""Joint mapping x scheduling: candidate-mapping search over the grid
(the port of the reference's ``mapping`` package).

The paper fixes the task-to-processor mapping; this subsystem makes it
a decision variable.  `seeds` builds a diverse population of
`FixedMapping`s (HEFT plus carbon-aware variants), `moves` perturbs
them (reassign / swap / critical-path migration), and `search` runs an
alternating map/schedule improvement loop that evaluates each round's
candidates as one extra fan-out dimension of the batched portfolio
grid (mappings x profiles x variants in a single shape-bucketed
launch).  Surfaced through ``PlanRequest(mapping=..., mapping_options=...)``.
"""

from repro_torch.mapping.options import MappingOptions
from repro_torch.mapping.moves import (critical_path,
                                       mapping_from_assignment,
                                       neighborhood, rank_priority,
                                       upward_ranks)
from repro_torch.mapping.seeds import (green_availability, heft_generic,
                                       seed_mappings)
from repro_torch.mapping.search import (MappingOutcome, MappingSearchInfo,
                                        resolve_mappings, search_mapping)

__all__ = [
    "MappingOptions",
    "MappingOutcome",
    "MappingSearchInfo",
    "critical_path",
    "green_availability",
    "heft_generic",
    "mapping_from_assignment",
    "neighborhood",
    "rank_priority",
    "resolve_mappings",
    "search_mapping",
    "seed_mappings",
    "upward_ranks",
]
