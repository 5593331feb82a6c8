"""Neighborhood moves over a mapping, as processor-assignment vectors.

A candidate mapping is just a ``proc`` vector ``[n]`` plus one shared,
topologically consistent task priority: the HEFT upward rank (mean exec
cost), which strictly decreases along every workflow edge, so ordering
each processor's tasks — and each link's communications — by priority can
never create a cycle in ``G_c``.  `mapping_from_assignment` is the
canonical (deterministic) completion of an assignment into a full
`FixedMapping`; the three move kinds (single-task reassign, pairwise
swap, critical-path-segment migration) perturb only the vector.
"""
from __future__ import annotations

import numpy as np

from repro_torch.cluster import Platform
from repro_torch.core.dag import FixedMapping
from repro_torch.workflows.generators import Workflow, topological_order


def upward_ranks(wf: Workflow, rank_exec: np.ndarray) -> np.ndarray:
    """HEFT upward ranks from per-task rank costs (``rank_exec`` [n]).

    ``rank[v] = rank_exec[v] + max over edges (v, s) of (c_vs + rank[s])``.
    """
    n = wf.n
    succs: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for (u, v), cw in zip(wf.edges, wf.edge_w):
        succs[int(u)].append((int(v), int(cw)))
    rank = np.zeros(n, dtype=np.float64)
    for v in reversed(topological_order(n, wf.edges)):
        best = 0.0
        for (s, cw) in succs[v]:
            best = max(best, cw + rank[s])
        rank[v] = float(rank_exec[v]) + best
    return rank


def rank_priority(wf: Workflow, platform: Platform) -> np.ndarray:
    """Dense priority positions [n] by descending mean-exec upward rank.

    Since every task's rank cost is >= 1, ``rank[u] > rank[v]`` for every
    edge ``(u, v)`` — the priority is a topological order of the workflow,
    independent of any candidate assignment.
    """
    exec_t = np.maximum(
        np.ceil(wf.node_w[:, None] / platform.speed[None, :]), 1)
    rank = upward_ranks(wf, exec_t.mean(axis=1))
    order = sorted(range(wf.n), key=lambda v: (-rank[v], v))
    pos = np.empty(wf.n, dtype=np.int64)
    pos[order] = np.arange(wf.n)
    return pos


def mapping_from_assignment(wf: Workflow, platform: Platform,
                            proc: np.ndarray,
                            priority: np.ndarray) -> FixedMapping:
    """Deterministic `FixedMapping` from an assignment vector.

    Per-processor orders sort by ``priority``; per-link communication
    orders sort by ``(priority[u], priority[v])``.  Acyclicity of the
    resulting ``G_c``: map compute task v to key ``(priority[v], -1)``
    and communication task (u, v) to ``(priority[u], priority[v])`` —
    every edge of ``G_c`` (workflow, comm in/out, compute chain, link
    chain) strictly increases the key, so no cycle exists.
    """
    proc = np.asarray(proc, dtype=np.int64)
    P = platform.num_compute
    order: list[list[int]] = [[] for _ in range(P)]
    for v in sorted(range(wf.n), key=lambda v: int(priority[v])):
        order[proc[v]].append(v)
    comm_order: dict[int, list[tuple[int, int]]] = {}
    cross = [(int(u), int(v)) for (u, v) in wf.edges if proc[u] != proc[v]]
    cross.sort(key=lambda e: (int(priority[e[0]]), int(priority[e[1]])))
    for (u, v) in cross:
        link = platform.link_id(int(proc[u]), int(proc[v]))
        comm_order.setdefault(link, []).append((u, v))
    return FixedMapping(
        proc=proc,
        order=tuple(tuple(o) for o in order),
        comm_order={k: tuple(v) for k, v in comm_order.items()},
    )


def critical_path(wf: Workflow, platform: Platform,
                  proc: np.ndarray) -> list[int]:
    """Longest path (exec + cross-proc comm) under an assignment, as a
    task-id list from a source to the latest-finishing sink."""
    proc = np.asarray(proc, dtype=np.int64)
    exec_t = platform.exec_time(wf.node_w, proc)
    n = wf.n
    preds: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for (u, v), cw in zip(wf.edges, wf.edge_w):
        u, v = int(u), int(v)
        comm = int(cw) if proc[u] != proc[v] else 0
        preds[v].append((u, comm))
    est = np.zeros(n, dtype=np.int64)
    topo = topological_order(n, wf.edges)
    for v in topo:
        for (u, comm) in preds[v]:
            est[v] = max(est[v], est[u] + exec_t[u] + comm)
    finish = est + exec_t
    v = int(finish.argmax())
    path = [v]
    while preds[path[-1]]:
        v = path[-1]
        u_best = max(preds[v],
                     key=lambda uc: (int(est[uc[0]] + exec_t[uc[0]] + uc[1]),
                                     -uc[0]))
        if est[u_best[0]] + exec_t[u_best[0]] + u_best[1] != est[v]:
            break                     # v starts at 0 / not pred-bound
        path.append(u_best[0])
    path.reverse()
    return path


_MOVE_KINDS = ("reassign", "swap", "migrate")


def neighborhood(wf: Workflow, platform: Platform,
                 elites: list[np.ndarray], rng: np.random.Generator,
                 count: int) -> list[tuple[str, np.ndarray]]:
    """``count`` labeled candidate assignments perturbing the elite set.

    Cycles through the three move kinds; every move starts from a
    round-robin elite so the neighborhood covers the whole front.
    """
    n, P = wf.n, platform.num_compute
    out: list[tuple[str, np.ndarray]] = []
    for j in range(count):
        base = elites[j % len(elites)].copy()
        kind = _MOVE_KINDS[j % len(_MOVE_KINDS)]
        if kind == "swap" and (P < 2 or n < 2):
            kind = "reassign"
        if kind == "reassign":
            v = int(rng.integers(n))
            p = int(rng.integers(P))
            if P > 1:
                while p == base[v]:
                    p = int(rng.integers(P))
            base[v] = p
        elif kind == "swap":
            a = int(rng.integers(n))
            b = int(rng.integers(n))
            tries = 0
            while base[a] == base[b] and tries < 8:
                b = int(rng.integers(n))
                tries += 1
            if base[a] == base[b]:     # all picks co-located: reassign a
                p = int(rng.integers(P))
                while P > 1 and p == base[a]:
                    p = int(rng.integers(P))
                base[a] = p
            else:
                base[a], base[b] = base[b], base[a]
        else:                          # migrate a critical-path segment
            path = critical_path(wf, platform, base)
            L = int(rng.integers(2, 6)) if len(path) > 1 else 1
            L = min(L, len(path))
            i0 = int(rng.integers(len(path) - L + 1))
            target = int(rng.integers(P))
            while P > 1 and target == base[path[i0]]:
                target = int(rng.integers(P))
            for v in path[i0:i0 + L]:
                base[v] = target
        out.append((kind, base))
    return out
