"""Seed mapping population: HEFT plus carbon-aware HEFT variants.

`heft_generic` is a parametrized twin of `core/heft.py` (which stays
byte-stable as the paper's reference): the rank cost can be weighted by
green-window availability and the EFT selection can be restricted to a
processor subset or penalized per processor.  `seed_mappings` combines
the exact HEFT mapping, a green-availability-weighted variant,
speed-tiered affinity variants, round-robin, and RNG perturbations of
HEFT into a diverse population for the search to start from.
"""
from __future__ import annotations

import numpy as np

from repro_torch.cluster import Platform
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import FixedMapping, trivial_mapping
from repro_torch.core.heft import heft_mapping
from repro_torch.mapping.moves import (mapping_from_assignment,
                                       rank_priority, upward_ranks)
from repro_torch.mapping.options import MappingOptions
from repro_torch.workflows.generators import Workflow


def green_availability(platform: Platform,
                       profiles: "list[PowerProfile]") -> np.ndarray:
    """Per compute processor: fraction of the horizon whose effective
    green budget covers that processor's work draw, averaged over the
    profile ensemble.  High availability = the processor can usually run
    for free."""
    P = platform.num_compute
    avail = np.zeros(P, dtype=np.float64)
    for prof in profiles:
        g = prof.unit_budget(platform.idle_total)          # [T] effective
        avail += (g[None, :] >= platform.p_work[:P, None]).mean(axis=1)
    return avail / max(len(profiles), 1)


def heft_generic(wf: Workflow, platform: Platform, *,
                 allowed: np.ndarray | None = None,
                 rank_weight: np.ndarray | None = None,
                 select_penalty: np.ndarray | None = None) -> FixedMapping:
    """HEFT with a parametrized rank cost and processor selection.

    allowed        -- bool [P]: processors admitted to EFT selection
    rank_weight    -- float [P]: multiplies exec time in the rank mean
    select_penalty -- float [P]: EFT score becomes eft + w_vp * penalty[p]
                      (carbon bias: penalize processors that rarely fit
                      the green windows)

    With all three at their defaults this reproduces `heft_mapping`.
    """
    n, P = wf.n, platform.num_compute
    mask = np.ones(P, dtype=bool) if allowed is None \
        else np.asarray(allowed, dtype=bool)
    assert mask.any(), "heft_generic: empty allowed processor set"
    procs = np.flatnonzero(mask)
    exec_t = np.maximum(
        np.ceil(wf.node_w[:, None] / platform.speed[None, :]), 1
    ).astype(np.int64)
    weight = np.ones(P) if rank_weight is None \
        else np.asarray(rank_weight, dtype=np.float64)
    penalty = np.zeros(P) if select_penalty is None \
        else np.asarray(select_penalty, dtype=np.float64)

    rank = upward_ranks(wf, (exec_t[:, procs] * weight[procs]).mean(axis=1))
    order_tasks = sorted(range(n), key=lambda v: (-rank[v], v))

    preds: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for (u, v), cw in zip(wf.edges, wf.edge_w):
        preds[int(v)].append((int(u), int(cw)))

    proc = np.full(n, -1, dtype=np.int64)
    aft = np.zeros(n, dtype=np.int64)
    ast = np.zeros(n, dtype=np.int64)
    slots: list[list[tuple[int, int]]] = [[] for _ in range(P)]
    for v in order_tasks:
        best = None
        for p in procs:
            ready = 0
            for (u, cw) in preds[v]:
                arr = aft[u] + (cw if proc[u] != p else 0)
                ready = max(ready, int(arr))
            w = int(exec_t[v, p])
            t = ready
            for (s0, e0) in slots[p]:
                if t + w <= s0:
                    break
                t = max(t, e0)
            score = t + w + w * penalty[p]
            if best is None or (score, int(p)) < (best[0], best[1]):
                best = (score, int(p), t, t + w)
        _, p, t, eft = best
        proc[v] = p
        ast[v] = t
        aft[v] = eft
        slots[p].append((t, eft))
        slots[p].sort()

    order: list[list[int]] = [[] for _ in range(P)]
    for p in range(P):
        tasks_p = [v for v in range(n) if proc[v] == p]
        tasks_p.sort(key=lambda v: (ast[v], v))
        order[p] = tasks_p
    comm_order: dict[int, list[tuple[int, int]]] = {}
    cross = [(int(u), int(v)) for (u, v) in wf.edges if proc[u] != proc[v]]
    cross.sort(key=lambda e: (aft[e[0]], ast[e[1]], e))
    for (u, v) in cross:
        link = platform.link_id(int(proc[u]), int(proc[v]))
        comm_order.setdefault(link, []).append((u, v))
    return FixedMapping(
        proc=proc,
        order=tuple(tuple(o) for o in order),
        comm_order={k: tuple(vs) for k, vs in comm_order.items()},
    )


def seed_mappings(wf: Workflow, platform: Platform,
                  profiles: "list[PowerProfile]",
                  options: MappingOptions) -> list[tuple[str, FixedMapping]]:
    """A diverse, deterministic seed population of size >= options.seeds.

    Always starts with exact HEFT (so the search's round-0 elite is never
    worse than `mapping="heft"`); fills up with carbon-aware variants and
    rank-priority perturbations of the HEFT assignment.
    """
    P = platform.num_compute
    seeds: list[tuple[str, FixedMapping]] = [
        ("seed:heft", heft_mapping(wf, platform))]

    avail = green_availability(platform, profiles)
    pen = 1.0 / np.maximum(avail, 0.05) - 1.0      # 0 when always green
    seeds.append(("seed:green", heft_generic(
        wf, platform, rank_weight=1.0 + pen, select_penalty=pen)))

    med = float(np.median(platform.speed))
    slow = platform.speed <= med
    fast = platform.speed >= med
    if slow.any() and not slow.all():
        seeds.append(("seed:tier_slow", heft_generic(wf, platform, allowed=slow)))
    if fast.any() and not fast.all():
        seeds.append(("seed:tier_fast", heft_generic(wf, platform, allowed=fast)))
    seeds.append(("seed:round_robin", trivial_mapping(wf, platform)))

    priority = rank_priority(wf, platform)
    base = seeds[0][1].proc
    rng = np.random.default_rng(options.seed)
    j = 0
    while len(seeds) < options.seeds:
        cand = base.copy()
        flips = rng.integers(wf.n, size=max(1, wf.n // 8))
        cand[flips] = rng.integers(P, size=len(flips))
        seeds.append((f"seed:perturb{j}",
                      mapping_from_assignment(wf, platform, cand, priority)))
        j += 1
    return seeds[:max(options.seeds, 2)]
