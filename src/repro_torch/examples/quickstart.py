"""Quickstart: schedule a scientific workflow carbon-aware in ~20 lines.

One ``Planner.plan`` call evaluates the ASAP baseline plus all 16
CaWoSched variants (paper §5) in a single amortized pass and returns the
dense cost grid; a second call on the ``solver="exact"`` axis audits the
heuristics against a provable optimum (``PlanResult.gap``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of the reference's ``examples/quickstart.py``: the same calls and
lines. Both planners run on ``--device`` (None = the card); the exact
solvers run on the host whatever the device.
"""
from __future__ import annotations

import argparse

from repro_torch.api import Planner, PlanRequest
from repro_torch.cluster import make_cluster
from repro_torch.core import (
    build_instance,
    deadline_from_asap,
    generate_profile,
    heft_mapping,
)
from repro_torch.core.dag import trivial_mapping
from repro_torch.kernels.backend import resolve_device
from repro_torch.workflows import layered_random, make_workflow


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of both planners (default: the card)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Plan the atacseq workflow's 17 variants and audit a 6-task chain
    against the exact solver; prints the reference's lines and returns
    the costs they show."""
    dev = resolve_device(args.device)
    platform = make_cluster(nodes_per_type=2, seed=0)      # 12 machines
    workflow = make_workflow("atacseq", n_samples=8, seed=1)
    print(f"workflow: {workflow.name}  tasks={workflow.n} edges={workflow.m}")

    mapping = heft_mapping(workflow, platform)             # fixed mapping
    inst = build_instance(workflow, mapping, platform)     # + comm tasks
    print(f"enhanced DAG: {inst.num_tasks} tasks "
          f"({inst.num_tasks - workflow.n} communications)")

    deadline = deadline_from_asap(inst, factor=2.0)
    profile = generate_profile("S1", deadline, platform, J=24, seed=2)

    planner = Planner(platform, device=dev)                # engine="auto"
    res = planner.plan(PlanRequest(instances=inst, profiles=profile))

    asap = res.result(variant="asap")
    print(f"\nASAP baseline: carbon cost = {asap.cost}")
    print(f"{'variant':<12} {'cost':>10} {'vs ASAP':>8} {'ms':>7}")
    costs = {}
    for name in res.variants:
        if name == "asap":
            continue
        r = res.result(variant=name)
        costs[name] = int(r.cost)
        ratio = r.cost / asap.cost if asap.cost else 1.0
        print(f"{name:<12} {r.cost:>10} {ratio:>8.3f} {r.seconds*1e3:>7.1f}")
    best = res.best()
    print(f"\nbest variant: {best.variant} "
          f"({best.cost / max(asap.cost, 1):.3f}x ASAP)")

    # To optimize the mapping jointly with the schedule, pass the raw
    # workflow and mapping="search"; fleet_scheduler shows a measured
    # joint-vs-fixed run.

    # --- optimality audit on a small instance (the solver axis) ----------
    tiny_wf = layered_random(6, 3, seed=7)
    tiny_plat = make_cluster(nodes_per_type=1, seed=0)
    tiny = build_instance(
        tiny_wf, trivial_mapping(tiny_wf, tiny_plat, by="single"),
        tiny_plat)
    tiny_prof = generate_profile(
        "S1", deadline_from_asap(tiny, factor=1.5), tiny_plat, J=6,
        seed=3, work_capacity=int(tiny.task_work.max()) // 2)
    tiny_planner = Planner(tiny_plat, engine="numpy", device=dev)
    req = dict(instances=tiny, profiles=tiny_prof)
    heur = tiny_planner.plan(PlanRequest(**req))
    exact = tiny_planner.plan(PlanRequest(**req, solver="exact"))
    optimum = int(exact.costs[0, 0, 0])
    gap = float(heur.gap(exact)[0, 0])
    print(f"\nexact audit ({tiny.num_tasks}-task chain): "
          f"optimum={optimum} best heuristic gap={gap:.3f}")
    print(heur.compare(exact))
    return {"device": str(dev), "asap": int(asap.cost), "costs": costs,
            "best": best.variant, "optimum": optimum, "gap": gap,
            "audit": {v: int(c) for v, c in zip(heur.variants,
                                               heur.costs[0, 0])}}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
