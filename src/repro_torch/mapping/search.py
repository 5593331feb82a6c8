"""Alternating mapping x scheduling search over the batched grid.

The port of the reference's ``mapping/search.py``. Each round evaluates a
*batch* of candidate mappings by handing them to the request's solver as
the instance axis of one ``solve_grid`` call — under the torch engine that
is the portfolio's shape-bucketed fan-out with mappings x profiles x
variants advancing together on the planner's device, then one batched
device climb per candidate (gain sweeps in the CUDA kernel on the card).
The elite set is kept by best/robust carbon cost; the loop stops on
convergence (``patience`` stale rounds), the round cap, or a
:class:`~repro_torch.core.cancel.CancelToken` firing.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.cancel import checkpoint
from repro_torch.core.cawosched import deadline_from_asap
from repro_torch.core.dag import FixedMapping, Instance, build_instance
from repro_torch.core.heft import heft_mapping
from repro_torch.core.portfolio import (bucket_entries_total,
                                        heuristic_indices, prepare_graph)
from repro_torch.kernels.backend import resolve_engine
from repro_torch.mapping.moves import (mapping_from_assignment,
                                       neighborhood, rank_priority)
from repro_torch.mapping.options import MappingOptions
from repro_torch.mapping.seeds import seed_mappings
from repro_torch.workflows.generators import Workflow

_C_BUCKET = 8                          # candidate-axis shape bucket (torch)

_CANDIDATES = obs.registry().counter(
    "mapping_candidates_total",
    "candidate mappings evaluated through the grid", labels=("workflow",))
_ROUNDS = obs.registry().counter(
    "mapping_rounds_total", "mapping-search improvement rounds",
    labels=("workflow",))
_IMPROVEMENTS = obs.registry().counter(
    "mapping_improvements_total",
    "rounds that improved the elite best cost", labels=("workflow",))


@dataclasses.dataclass(frozen=True)
class MappingSearchInfo:
    """Search provenance carried on :class:`repro_torch.api.PlanResult`.

    ``trace`` is the elite best score after the seed round and after
    every improvement round; ``candidate_costs`` aligns with
    ``candidate_labels`` (the per-mapping cost tensor reduced to the
    search objective); ``cache_misses`` is the ``torch_bucket_misses_total``
    delta of each evaluation batch (new padded ``(Npad, Tp)`` fan-out
    buckets) — steady state, later batches add zero.
    """

    mode: str
    objective: str = "best"
    label: str = ""                      # winning candidate's label
    rounds: int = 0                      # improvement rounds actually run
    candidates: int = 0                  # mappings evaluated
    infeasible: int = 0                  # mappings rejected by EST/LST
    trace: tuple = ()                    # int per round: elite best score
    cache_misses: tuple = ()             # int per evaluation batch
    candidate_labels: tuple = ()
    candidate_costs: tuple = ()          # int per evaluated candidate
    seconds: float = 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for key in ("trace", "cache_misses", "candidate_labels",
                    "candidate_costs"):
            d[key] = list(d[key])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "MappingSearchInfo":
        kw = dict(d)
        for key in ("trace", "cache_misses", "candidate_labels",
                    "candidate_costs"):
            kw[key] = tuple(kw.get(key, ()))
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class MappingOutcome:
    """Winner of the mapping resolution for one workflow."""

    mapping: FixedMapping
    instance: Instance
    graph: object | None                 # winner's PreparedGraph, if built
    cost: int                            # objective score (-1: unevaluated)
    info: MappingSearchInfo


@dataclasses.dataclass
class _Candidate:
    label: str
    mapping: FixedMapping
    instance: Instance
    graph: object
    score: int
    seq: int                             # deterministic tie-break


def _mapping_key(m: FixedMapping) -> tuple:
    return (m.proc.tobytes(), m.order, tuple(sorted(m.comm_order.items())))


def _score(costs_pv: np.ndarray, cols: list, objective: str) -> int:
    if objective == "robust":
        return int(costs_pv[:, cols].max(axis=0).min())
    return int(costs_pv[:, cols].min())


class _Evaluator:
    """Batch-evaluates labeled mappings through the request's solver."""

    def __init__(self, wf, platform, row, planner, solver, names,
                 objective, solver_options, cancel, devices=None):
        self.wf, self.platform, self.row = wf, platform, tuple(row)
        self.planner, self.solver, self.names = planner, solver, tuple(names)
        self.objective = objective
        self.solver_options, self.cancel = solver_options, cancel
        self.devices = devices
        self.cols = heuristic_indices(self.names)
        self.T = int(row[0].T)
        self.infeasible = 0
        self.cache_misses: list[int] = []
        self.evaluated: list[_Candidate] = []
        self._seq = 0

    def run(self, labeled: "list[tuple[str, FixedMapping]]") -> list[_Candidate]:
        built = []
        for label, m in labeled:
            inst = build_instance(self.wf, m, self.platform,
                                  name=f"{self.wf.name}|{label}")
            g = prepare_graph(inst, self.platform, self.T, k=self.planner.k,
                              lp_budget_bytes=self.planner.lp_budget_bytes)
            if not g.feasible:           # deadline below this mapping's ASAP
                self.infeasible += 1
                continue
            built.append((label, m, inst, g))
        if not built:
            return []
        insts = [b[2] for b in built]
        graphs = [b[3] for b in built] if self.solver.uses_graphs else None
        fanout = len(insts) * len(self.row)
        engine = resolve_engine(self.planner.engine, fanout=fanout) \
            if self.solver.name == "heuristic" else "numpy"
        if engine == "torch":
            # Pad the candidate batch to a multiple of _C_BUCKET by
            # repeating the last candidate, as the reference does for its
            # jit signatures: the fan-out's instance axis then keeps one
            # shape across rounds (stable for captured CUDA graphs), and
            # the portfolio's dedupe counter moves as the reference's.
            # The repeats are BY IDENTITY, so the portfolio pass dedupes
            # their host-side cost (graphs/overlays/climbs/assembly run
            # once; only the device fan-out rows repeat) and nothing
            # below this point sees the pad rows: ``built`` stops at the
            # real candidates, so ``evaluated`` / ``candidates`` /
            # ``candidate_costs`` count only real ones.
            pad = -len(insts) % _C_BUCKET
            insts = insts + [insts[-1]] * pad
            if graphs is not None:
                graphs = graphs + [graphs[-1]] * pad
        b0 = bucket_entries_total()
        out = self.solver.solve_grid(
            insts, [self.row] * len(insts), self.platform, self.names,
            k=self.planner.k, mu=self.planner.ls.mu,
            validate=self.planner.validate, engine=engine, graphs=graphs,
            commit_k=self.planner.ls.commit_k,
            ls_max_rounds=self.planner.ls.max_rounds,
            options=self.solver_options, cancel=self.cancel,
            device=self.planner.device, devices=self.devices)
        self.cache_misses.append(max(bucket_entries_total() - b0, 0))
        costs = out.cost_tensor(self.names)          # [C, P, V]
        batch = []
        for c, (label, m, inst, g) in enumerate(built):
            cand = _Candidate(label=label, mapping=m, instance=inst, graph=g,
                              score=_score(costs[c], self.cols,
                                           self.objective),
                              seq=self._seq)
            self._seq += 1
            batch.append(cand)
        self.evaluated.extend(batch)
        _CANDIDATES.inc(len(batch), workflow=self.wf.name)
        return batch


def search_mapping(wf: Workflow, platform, row, *, planner, solver, names,
                   options: MappingOptions, robust: bool = False,
                   solver_options: dict | None = None,
                   cancel=None, devices: int | None = None) -> MappingOutcome:
    """Run the alternating search for one workflow over one profile row."""
    t0 = time.perf_counter()
    objective = options.objective
    if objective == "auto":
        objective = "robust" if robust else "best"
    ev = _Evaluator(wf, platform, row, planner, solver, names, objective,
                    solver_options, cancel, devices=devices)
    trace: list[int] = []
    with obs.span("mapping_search", workflow=wf.name, mode="search",
                  objective=objective):
        checkpoint(cancel)
        seen: set = set()
        seeds = []
        for label, m in seed_mappings(wf, platform, list(row), options):
            key = _mapping_key(m)
            if key not in seen:
                seen.add(key)
                seeds.append((label, m))
        with obs.span("mapping_round", round=0, candidates=len(seeds)):
            batch = ev.run(seeds)
        if not batch:
            raise ValueError(
                f"mapping search: every seed mapping of {wf.name!r} is "
                f"infeasible for horizon T={ev.T} (deadline below ASAP "
                f"makespan) — raise the deadline")
        elite = sorted(batch, key=lambda c: (c.score, c.seq))[:options.elite]
        trace.append(elite[0].score)
        rng = np.random.default_rng(options.seed + 1)
        priority = rank_priority(wf, platform)
        stall = rounds_run = 0
        for r in range(1, options.rounds + 1):
            if stall >= options.patience:
                break
            checkpoint(cancel)
            fresh = []
            for kind, vec in neighborhood(wf, platform,
                                          [c.mapping.proc for c in elite],
                                          rng, options.neighbors):
                key = (vec.tobytes(),)   # canonical completion: proc is key
                if key in seen:
                    continue
                seen.add(key)
                fresh.append((f"r{r}:{kind}",
                              mapping_from_assignment(wf, platform, vec,
                                                      priority)))
            with obs.span("mapping_round", round=r, candidates=len(fresh)):
                batch = ev.run(fresh)
            rounds_run += 1
            _ROUNDS.inc(workflow=wf.name)
            best_before = elite[0].score
            elite = sorted(elite + batch,
                           key=lambda c: (c.score, c.seq))[:options.elite]
            trace.append(elite[0].score)
            if elite[0].score < best_before:
                _IMPROVEMENTS.inc(workflow=wf.name)
                stall = 0
            else:
                stall += 1
    winner = elite[0]
    info = MappingSearchInfo(
        mode="search", objective=objective, label=winner.label,
        rounds=rounds_run, candidates=len(ev.evaluated),
        infeasible=ev.infeasible, trace=tuple(trace),
        cache_misses=tuple(ev.cache_misses),
        candidate_labels=tuple(c.label for c in ev.evaluated),
        candidate_costs=tuple(c.score for c in ev.evaluated),
        seconds=time.perf_counter() - t0)
    return MappingOutcome(mapping=winner.mapping, instance=winner.instance,
                          graph=winner.graph, cost=winner.score, info=info)


def resolve_mappings(planner, workflows, grid, names, solver, *,
                     mode: str, options=None, robust: bool = False,
                     solver_options: dict | None = None,
                     cancel=None, deadline_scale: float | None = None,
                     devices: int | None = None
                     ) -> tuple[list[MappingOutcome], list]:
    """Resolve one mapping per workflow for the mapping-mode plan path.

    ``mode="heft"`` maps each workflow with exact HEFT (no evaluation);
    ``mode="search"`` runs :func:`search_mapping`.  The returned
    instances feed the planner's normal fixed-mapping path; winner
    graphs are pre-built so the planner's cache sees them for free.

    Returns ``(outcomes, grid)``: the resolved mappings plus the profile
    grid the schedule solve must run on.  With ``deadline_scale`` set,
    each workflow's deadline is ``scale x ASAP-makespan`` of a reference
    exact-HEFT mapping — the mapping being decided cannot define its own
    horizon, so the reference anchors it the way the pre-built Instance
    does in fixed mode — and the workflow's profile row is cropped to
    that horizon BEFORE candidates are evaluated, so search candidates
    compete under the same deadline the winner is scheduled with
    (candidates whose own ASAP overruns it are rejected as infeasible,
    like any too-tight mapping).  ``devices`` splits the candidate
    batches' grid runs (see ``Planner.devices``).
    """
    from repro_torch.api.request import crop_profile  # lazy: api imports us

    opts = MappingOptions.from_dict(options)
    outcomes: list[MappingOutcome] = []
    out_grid: list = []
    for wf, row in zip(workflows, grid):
        m_ref = inst_ref = None
        if mode == "heft" or deadline_scale is not None:
            m_ref = heft_mapping(wf, planner.platform)
            inst_ref = build_instance(wf, m_ref, planner.platform,
                                      name=f"{wf.name}|heft")
        if deadline_scale is not None:
            T = deadline_from_asap(inst_ref, deadline_scale)
            row = [crop_profile(p, T) for p in row]
        out_grid.append(list(row))
        if mode == "heft":
            outcomes.append(MappingOutcome(
                mapping=m_ref, instance=inst_ref, graph=None, cost=-1,
                info=MappingSearchInfo(mode="heft", label="heft")))
        elif mode == "search":
            outcomes.append(search_mapping(
                wf, planner.platform, row, planner=planner, solver=solver,
                names=names, options=opts, robust=robust,
                solver_options=solver_options, cancel=cancel,
                devices=devices))
        else:
            raise ValueError(f"unknown mapping mode {mode!r}")
    return outcomes, out_grid
