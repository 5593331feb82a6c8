"""HEFT (Topcuoglu et al. [35]) — produces the fixed mapping + ordering.

Basic implementation "without special techniques for tie-breaking" (paper
§6.1): upward ranks with mean execution/communication costs, then earliest-
finish-time processor selection with insertion. Communication order on each
link follows the communications' ready times (source finish times).
"""
from __future__ import annotations

import numpy as np

from repro_torch.cluster import Platform
from repro_torch.core.dag import FixedMapping
from repro_torch.workflows.generators import Workflow, topological_order


def heft_mapping(wf: Workflow, platform: Platform) -> FixedMapping:
    n = wf.n
    P = platform.num_compute
    exec_t = np.ceil(wf.node_w[:, None] / platform.speed[None, :]).astype(np.int64)
    exec_t = np.maximum(exec_t, 1)
    mean_exec = exec_t.mean(axis=1)

    succs: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    preds: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for (u, v), cw in zip(wf.edges, wf.edge_w):
        succs[int(u)].append((int(v), int(cw)))
        preds[int(v)].append((int(u), int(cw)))

    topo = topological_order(n, wf.edges)
    rank = np.zeros(n, dtype=np.float64)
    # mean comm cost: bandwidth 1, zero if same processor; expected over
    # uniformly random placement -> (P-1)/P * c. The basic variant just uses c.
    for v in reversed(topo):
        best = 0.0
        for (s, cw) in succs[v]:
            best = max(best, cw + rank[s])
        rank[v] = mean_exec[v] + best

    order_tasks = sorted(range(n), key=lambda v: (-rank[v], v))

    proc = np.full(n, -1, dtype=np.int64)
    aft = np.zeros(n, dtype=np.int64)          # actual finish time
    ast = np.zeros(n, dtype=np.int64)          # actual start time
    # busy slots per processor: sorted list of (start, end)
    slots: list[list[tuple[int, int]]] = [[] for _ in range(P)]

    for v in order_tasks:
        best = None
        for p in range(P):
            ready = 0
            for (u, cw) in preds[v]:
                arr = aft[u] + (cw if proc[u] != p else 0)
                ready = max(ready, int(arr))
            w = int(exec_t[v, p])
            # insertion policy: earliest hole >= ready of length w
            t = ready
            for (s0, e0) in slots[p]:
                if t + w <= s0:
                    break
                t = max(t, e0)
            eft = t + w
            if best is None or eft < best[0]:
                best = (eft, p, t)
        eft, p, t = best
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
