"""Communication-enhanced DAG ``G_c`` and the scheduling Instance (paper §3).

Given a workflow, a fixed mapping (task -> processor) and a fixed per-
processor order, every cross-processor edge ``(u, v)`` becomes a fictional
communication task on the link processor of ``(proc(u), proc(v))``; chain
edges encode the fixed order on every (compute or link) processor.

The resulting ``Instance`` is the single input format of every algorithm in
this package: dense numpy arrays + CSR adjacency, integer time units.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cluster import Platform
from repro_torch.workflows.generators import Workflow, topological_order


@dataclasses.dataclass(frozen=True)
class FixedMapping:
    """Fixed mapping + ordering, e.g. produced by HEFT (core/heft.py)."""

    proc: np.ndarray                 # [n] compute processor per task
    order: tuple[tuple[int, ...], ...]   # per compute proc: ordered task ids
    # per link id: ordered (u, v) workflow edges communicated on that link
    comm_order: dict[int, tuple[tuple[int, int], ...]]


@dataclasses.dataclass(frozen=True)
class Instance:
    """Scheduling instance on the communication-enhanced DAG G_c."""

    name: str
    num_tasks: int                   # N = n + |E'|
    num_workflow_tasks: int          # n (tasks 0..n-1 are original)
    dur: np.ndarray                  # [N] integer durations  (>= 1)
    proc: np.ndarray                 # [N] processor id (compute or link)
    task_work: np.ndarray            # [N] P_work of the task's processor
    # CSR adjacency of G_c
    pred_ptr: np.ndarray
    pred_idx: np.ndarray
    succ_ptr: np.ndarray
    succ_idx: np.ndarray
    proc_chains: tuple[tuple[int, ...], ...]  # per used proc: ordered tasks
    chain_proc_ids: np.ndarray       # processor id per chain
    idle_total: int                  # sum of P_idle over all P^2 processors
    topo: np.ndarray                 # [N] a topological order of G_c
    level: np.ndarray                # [N] topological depth

    def preds(self, v: int) -> np.ndarray:
        return self.pred_idx[self.pred_ptr[v]:self.pred_ptr[v + 1]]

    def succs(self, v: int) -> np.ndarray:
        return self.succ_idx[self.succ_ptr[v]:self.succ_ptr[v + 1]]

    @property
    def total_work_power(self) -> int:
        return int(self.task_work.sum() * 0 + self.task_work.max(initial=0))

    def validate(self) -> None:
        assert (self.dur >= 1).all()
        assert len(self.topo) == self.num_tasks


def _csr(n: int, pairs: np.ndarray, by_col: bool) -> tuple[np.ndarray, np.ndarray]:
    """CSR of (u, v) pairs: by_col=True -> predecessors of v, else succs of u."""
    if len(pairs) == 0:
        return np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int64)
    key = pairs[:, 1] if by_col else pairs[:, 0]
    val = pairs[:, 0] if by_col else pairs[:, 1]
    order = np.argsort(key, kind="stable")
    key, val = key[order], val[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, key + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, val


def build_instance(wf: Workflow, mapping: FixedMapping,
                   platform: Platform, dur: np.ndarray | None = None,
                   name: str | None = None) -> Instance:
    """Build the communication-enhanced instance from workflow + mapping.

    ``dur`` optionally overrides computed running times (w / speed).
    """
    n = wf.n
    proc_n = np.asarray(mapping.proc, dtype=np.int64)
    if dur is None:
        dur_n = platform.exec_time(wf.node_w, proc_n)
    else:
        dur_n = np.asarray(dur, dtype=np.int64)

    # communication tasks for cross-processor edges, in comm_order
    comm_id: dict[tuple[int, int], int] = {}
    comm_dur: list[int] = []
    comm_proc: list[int] = []
    next_id = n
    chain_edges: list[tuple[int, int]] = []
    for link, pairs in sorted(mapping.comm_order.items()):
        prev = None
        for (u, v) in pairs:
            cid = next_id
            next_id += 1
            comm_id[(u, v)] = cid
            eidx = _edge_index(wf, u, v)
            comm_dur.append(max(int(wf.edge_w[eidx]), 1))
            comm_proc.append(link)
            if prev is not None:          # E'': fixed order on the link
                chain_edges.append((prev, cid))
            prev = cid

    N = next_id
    dur_all = np.concatenate([dur_n, np.asarray(comm_dur, dtype=np.int64)])
    proc_all = np.concatenate([proc_n, np.asarray(comm_proc, dtype=np.int64)])

    # edges of G_c
    edges: list[tuple[int, int]] = list(chain_edges)
    for (u, v), w in zip(wf.edges, wf.edge_w):
        u, v = int(u), int(v)
        if proc_n[u] == proc_n[v]:
            edges.append((u, v))
        else:
            cid = comm_id[(u, v)]
            edges.append((u, cid))
            edges.append((cid, v))
    # fixed order on compute processors
    for p, tasks in enumerate(mapping.order):
        for a, b in zip(tasks[:-1], tasks[1:]):
            edges.append((int(a), int(b)))

    e = np.unique(np.asarray(edges, dtype=np.int64).reshape(-1, 2), axis=0)
    pred_ptr, pred_idx = _csr(N, e, by_col=True)
    succ_ptr, succ_idx = _csr(N, e, by_col=False)

    # per-processor chains (compute procs from mapping.order, links from comm)
    chains: list[tuple[int, ...]] = []
    chain_pids: list[int] = []
    for p, tasks in enumerate(mapping.order):
        if tasks:
            chains.append(tuple(int(t) for t in tasks))
            chain_pids.append(p)
    for link, pairs in sorted(mapping.comm_order.items()):
        if pairs:
            chains.append(tuple(comm_id[(u, v)] for (u, v) in pairs))
            chain_pids.append(link)

    topo = np.asarray(topological_order(N, e), dtype=np.int64)
    assert len(topo) == N, "G_c has a cycle: mapping order conflicts with DAG"
    level = np.zeros(N, dtype=np.int64)
    for v in topo:
        ps = pred_idx[pred_ptr[v]:pred_ptr[v + 1]]
        if len(ps):
            level[v] = level[ps].max() + 1

    inst = Instance(
        name=name or wf.name,
        num_tasks=N,
        num_workflow_tasks=n,
        dur=dur_all,
        proc=proc_all,
        task_work=platform.p_work[proc_all],
        pred_ptr=pred_ptr, pred_idx=pred_idx,
        succ_ptr=succ_ptr, succ_idx=succ_idx,
        proc_chains=tuple(chains),
        chain_proc_ids=np.asarray(chain_pids, dtype=np.int64),
        idle_total=platform.idle_total,
        topo=topo,
        level=level,
    )
    inst.validate()
    return inst


def _edge_index(wf: Workflow, u: int, v: int) -> int:
    hits = np.flatnonzero((wf.edges[:, 0] == u) & (wf.edges[:, 1] == v))
    assert len(hits) >= 1
    return int(hits[0])


def trivial_mapping(wf: Workflow, platform: Platform,
                    by: str = "round_robin") -> FixedMapping:
    """Cheap mappings for tests: round-robin or all-on-one processor."""
    n = wf.n
    P = platform.num_compute
    topo = topological_order(n, wf.edges)
    if by == "single":
        proc = np.zeros(n, dtype=np.int64)
    else:
        proc = np.zeros(n, dtype=np.int64)
        for i, v in enumerate(topo):
            proc[v] = i % P
    order: list[list[int]] = [[] for _ in range(P)]
    for v in topo:
        order[proc[v]].append(int(v))
    comm_order: dict[int, list[tuple[int, int]]] = {}
    pos = {int(v): i for i, v in enumerate(topo)}
    for (u, v) in sorted(map(tuple, wf.edges), key=lambda p: (pos[p[0]], pos[p[1]])):
        if proc[u] != proc[v]:
            link = platform.link_id(int(proc[u]), int(proc[v]))
            comm_order.setdefault(link, []).append((int(u), int(v)))
    return FixedMapping(
        proc=proc,
        order=tuple(tuple(o) for o in order),
        comm_order={k: tuple(v) for k, v in comm_order.items()},
    )
