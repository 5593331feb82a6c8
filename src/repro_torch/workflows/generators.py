"""Workflow (DAG) generators emulating the paper's benchmark set (§6.1).

The paper uses four nf-core pipelines (atacseq, bacass, eager, methylseq)
plus WFGen-style scale-ups of those up to 30k tasks. The real .dot exports
are not redistributable here, so each generator reproduces the published
*structure* of its pipeline: per-sample linear tool chains with stage-level
fan-out/fan-in, cross-sample merge barriers and a final QC/aggregation
chain. ``wfgen_scale`` scales any of them to a target task count the way
WFGen scales a model graph (replicating samples, preserving motif shape).

Vertex/edge weights follow the paper: normal distributions with vertex
weights generally larger than edge weights, truncated to positive ints.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workflow:
    """An immutable task DAG with computation and communication weights."""

    name: str
    node_w: np.ndarray          # [n] computation weight (normalized)
    edges: np.ndarray           # [m, 2] (u, v) precedence pairs, u -> v
    edge_w: np.ndarray          # [m] communication weight (bandwidth = 1)

    @property
    def n(self) -> int:
        return len(self.node_w)

    @property
    def m(self) -> int:
        return len(self.edges)

    def validate(self) -> None:
        n = self.n
        assert self.edges.ndim == 2 and self.edges.shape[1] == 2
        assert (self.edges >= 0).all() and (self.edges < n).all()
        assert (self.node_w >= 1).all() and (self.edge_w >= 0).all()
        # acyclicity via Kahn
        indeg = np.zeros(n, dtype=np.int64)
        np.add.at(indeg, self.edges[:, 1], 1)
        order = topological_order(n, self.edges)
        assert len(order) == n, "workflow graph has a cycle"


def topological_order(n: int, edges: np.ndarray) -> list[int]:
    """Kahn's algorithm [22]; returns a topological order (len < n => cycle)."""
    indeg = np.zeros(n, dtype=np.int64)
    succs: list[list[int]] = [[] for _ in range(n)]
    for u, v in edges:
        succs[int(u)].append(int(v))
        indeg[int(v)] += 1
    queue = [int(i) for i in np.flatnonzero(indeg == 0)]
    order: list[int] = []
    head = 0
    while head < len(queue):
        u = queue[head]
        head += 1
        order.append(u)
        for v in succs[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                queue.append(v)
    return order


def _weights(rng: np.random.Generator, n: int, m: int,
             node_mu: float = 120.0, node_sigma: float = 35.0,
             edge_mu: float = 14.0, edge_sigma: float = 5.0):
    node_w = np.maximum(rng.normal(node_mu, node_sigma, size=n), 1.0)
    edge_w = np.maximum(rng.normal(edge_mu, edge_sigma, size=m), 1.0)
    return node_w.astype(np.int64), edge_w.astype(np.int64)


# ---------------------------------------------------------------------------
# Pipeline-motif generator.
#
# A motif is a list of stages; each stage is either
#   ("chain", k)   -- per-sample linear chain of k tools
#   ("fan", w, k)  -- per-sample fan-out to w parallel chains of k tools,
#                     then fan-in
#   ("merge", g)   -- cross-sample barrier merging groups of g samples
#   ("final", k)   -- single aggregation chain of k tools over everything
# ---------------------------------------------------------------------------

_MOTIFS = {
    # nf-core/atacseq: trim/align per sample, bigwig+peak branches, merged
    # library analysis, consensus peaks + QC.
    "atacseq": [("chain", 3), ("fan", 3, 2), ("chain", 2), ("merge", 4),
                ("final", 4)],
    # nf-core/bacass: small assembly pipeline, little branching.
    "bacass": [("chain", 4), ("fan", 2, 2), ("chain", 2), ("final", 3)],
    # nf-core/eager: ancient-DNA; long per-sample chains, two analysis
    # branches, genotyping merge.
    "eager": [("chain", 5), ("fan", 2, 3), ("chain", 3), ("merge", 3),
              ("final", 5)],
    # nf-core/methylseq: align, dedup, methylation extraction branches, MQC.
    "methylseq": [("chain", 4), ("fan", 3, 1), ("chain", 2), ("final", 3)],
}

WORKFLOW_KINDS = tuple(_MOTIFS)


def _motif_tasks_per_sample(motif) -> int:
    per = 0
    for stage in motif:
        if stage[0] == "chain":
            per += stage[1]
        elif stage[0] == "fan":
            per += stage[1] * stage[2] + 1  # + fan-in node
        elif stage[0] == "merge":
            per += 0  # merge nodes are per-group, counted separately
    return per


def make_workflow(kind: str, n_samples: int, seed: int = 0,
                  name: str | None = None) -> Workflow:
    """Instantiate a pipeline motif for ``n_samples`` input samples."""
    motif = _MOTIFS[kind]
    rng = np.random.default_rng(seed)
    edges: list[tuple[int, int]] = []
    next_id = 0

    def new_node() -> int:
        nonlocal next_id
        next_id += 1
        return next_id - 1

    # frontier[i] = last task of sample-group i
    frontier = [None] * n_samples
    group_of = list(range(n_samples))  # sample -> current group id
    heads: dict[int, int | None] = {g: None for g in range(n_samples)}

    def extend(g: int, node: int) -> None:
        if heads[g] is not None:
            edges.append((heads[g], node))
        heads[g] = node

    for stage in motif:
        if stage[0] == "chain":
            for g in list(heads):
                for _ in range(stage[1]):
                    extend(g, new_node())
        elif stage[0] == "fan":
            _, width, k = stage
            for g in list(heads):
                root = heads[g]
                tails = []
                for _ in range(width):
                    prev = root
                    for _ in range(k):
                        nd = new_node()
                        if prev is not None:
                            edges.append((prev, nd))
                        prev = nd
                    tails.append(prev)
                join = new_node()
                for t in tails:
                    edges.append((t, join))
                heads[g] = join
        elif stage[0] == "merge":
            _, gsize = stage
            groups = list(heads)
            new_heads: dict[int, int | None] = {}
            for i in range(0, len(groups), gsize):
                block = groups[i:i + gsize]
                nd = new_node()
                for g in block:
                    if heads[g] is not None:
                        edges.append((heads[g], nd))
                new_heads[len(new_heads)] = nd
            heads = new_heads
        elif stage[0] == "final":
            nd = new_node()
            for g in list(heads):
                if heads[g] is not None:
                    edges.append((heads[g], nd))
            heads = {0: nd}
            for _ in range(stage[1] - 1):
                nxt = new_node()
                edges.append((heads[0], nxt))
                heads[0] = nxt

    n = next_id
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    node_w, edge_w = _weights(rng, n, len(e))
    wf = Workflow(name=name or f"{kind}-s{n_samples}", node_w=node_w,
                  edges=e, edge_w=edge_w)
    wf.validate()
    return wf


def wfgen_scale(kind: str, n_target: int, seed: int = 0) -> Workflow:
    """WFGen-style scale-up: pick n_samples so the instance has ~n_target tasks."""
    per = max(_motif_tasks_per_sample(_MOTIFS[kind]), 1)
    n_samples = max(1, round(n_target / per))
    wf = make_workflow(kind, n_samples, seed=seed,
                       name=f"{kind}-n{n_target}")
    return wf


def layered_random(n: int, n_layers: int, p_edge: float = 0.25,
                   seed: int = 0, name: str | None = None) -> Workflow:
    """Layered random DAG (used for property tests and NP-hardness probes)."""
    rng = np.random.default_rng(seed)
    layer = rng.integers(0, n_layers, size=n)
    layer.sort()
    edges = []
    for v in range(n):
        lv = layer[v]
        if lv == 0:
            continue
        prev = np.flatnonzero(layer == lv - 1)
        if len(prev) == 0:
            continue
        mask = rng.random(len(prev)) < p_edge
        chosen = prev[mask]
        if len(chosen) == 0:
            chosen = prev[rng.integers(0, len(prev), size=1)]
        for u in chosen:
            edges.append((int(u), v))
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    node_w, edge_w = _weights(rng, n, len(e))
    wf = Workflow(name=name or f"rand-n{n}", node_w=node_w, edges=e,
                  edge_w=edge_w)
    wf.validate()
    return wf


def independent_tasks(durs, name: str = "independent") -> Workflow:
    """Edge-free workflow (UCAS instances of Theorem 4.3)."""
    durs = np.asarray(durs, dtype=np.int64)
    return Workflow(name=name, node_w=durs,
                    edges=np.zeros((0, 2), dtype=np.int64),
                    edge_w=np.zeros(0, dtype=np.int64))
