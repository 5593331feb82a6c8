"""Graphviz .dot import/export for workflows.

The paper converts Nextflow pipeline definitions to .dot and strips the
Nextflow-internal pseudo-tasks; `load_dot` performs the same cleanup
(drop nodes matching ``pseudo_patterns``, reconnect their in/out edges).
Weights come from node/edge ``weight`` attributes when present, else the
usual normal distributions.
"""
from __future__ import annotations

import re

import numpy as np

from repro_torch.workflows.generators import Workflow, _weights


def save_dot(wf: Workflow, path: str) -> None:
    with open(path, "w") as f:
        f.write(f'digraph "{wf.name}" {{\n')
        for i, w in enumerate(wf.node_w):
            f.write(f'  n{i} [weight={int(w)}];\n')
        for (u, v), w in zip(wf.edges, wf.edge_w):
            f.write(f'  n{u} -> n{v} [weight={int(w)}];\n')
        f.write("}\n")


_NODE_RE = re.compile(r'^\s*"?([\w.\-]+)"?\s*(\[(.*)\])?\s*;?\s*$')
_EDGE_RE = re.compile(
    r'^\s*"?([\w.\-]+)"?\s*->\s*"?([\w.\-]+)"?\s*(\[(.*)\])?\s*;?\s*$')
_W_RE = re.compile(r'weight\s*=\s*"?(\d+)')


def load_dot(path: str, name: str | None = None,
             pseudo_patterns: tuple[str, ...] = (),
             seed: int = 0) -> Workflow:
    names: dict[str, int] = {}
    node_w: list[int] = []
    edges: list[tuple[int, int]] = []
    edge_w: list[int] = []

    def nid(s: str) -> int:
        if s not in names:
            names[s] = len(names)
            node_w.append(0)
        return names[s]

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("digraph", "}", "//", "#")):
                continue
            m = _EDGE_RE.match(line)
            if m:
                u, v = nid(m.group(1)), nid(m.group(2))
                w = _W_RE.search(m.group(3) or "")
                edges.append((u, v))
                edge_w.append(int(w.group(1)) if w else 0)
                continue
            m = _NODE_RE.match(line)
            if m and "->" not in line:
                i = nid(m.group(1))
                w = _W_RE.search(m.group(3) or "")
                if w:
                    node_w[i] = int(w.group(1))

    # drop pseudo-tasks (Nextflow internals), reconnecting through them
    pseudo = {i for s, i in names.items()
              if any(re.search(p, s) for p in pseudo_patterns)}
    if pseudo:
        preds: dict[int, list[int]] = {}
        succs: dict[int, list[int]] = {}
        for (u, v) in edges:
            succs.setdefault(u, []).append(v)
            preds.setdefault(v, []).append(u)
        new_edges = [(u, v) for (u, v) in edges
                     if u not in pseudo and v not in pseudo]
        for p in pseudo:
            for u in preds.get(p, []):
                for v in succs.get(p, []):
                    if u not in pseudo and v not in pseudo:
                        new_edges.append((u, v))
        keep = [i for i in range(len(node_w)) if i not in pseudo]
        remap = {old: new for new, old in enumerate(keep)}
        node_w = [node_w[i] for i in keep]
        edges_rw = sorted({(remap[u], remap[v]) for (u, v) in new_edges})
        edges = edges_rw
        edge_w = [0] * len(edges)

    n, m = len(node_w), len(edges)
    rnd_nw, rnd_ew = _weights(np.random.default_rng(seed), n, max(m, 1))
    nw = np.asarray([w if w > 0 else int(r)
                     for w, r in zip(node_w, rnd_nw)], dtype=np.int64)
    ew = np.asarray([w if w > 0 else int(r)
                     for w, r in zip(edge_w, rnd_ew[:m])], dtype=np.int64) \
        if m else np.zeros(0, dtype=np.int64)
    wf = Workflow(name=name or path, node_w=nw,
                  edges=np.asarray(edges, dtype=np.int64).reshape(-1, 2),
                  edge_w=ew)
    wf.validate()
    return wf
