"""Fleet-level carbon-aware scheduling driven by the dry-run roofline model.

The port's dry-run records (``experiments/dryrun_torch/*.json``, written by
``python -m repro_torch.launch.dryrun --mesh none``) provide per-(arch x
shape) step-time bounds; each fleet of training/serving jobs across 2
pods becomes a fixed-mapping workflow whose task durations come from
those bounds, and CaWoSched shifts the jobs into green windows.

Carbon forecasts are uncertain, so BOTH fleets x their 8-member perturbed
forecast ensembles x all 17 variants are planned as ONE ``Planner.plan``
call — the combined (instances x profiles x variants) grid; under the
torch engine every shape bucket of the grid is one batched device pass.
Per fleet the ROBUST variant is executed: the one whose worst cost across
the ensemble is smallest (min-max).

Fleet 0 is then re-planned with ``mapping="search"`` — the chunk->pod
placement becomes a decision variable optimized jointly with the
schedule — and a :class:`~repro_torch.api.PlanningSession` replans it
over a rolling 3-window horizon: window k+1's plan is computed on a
background worker while window k "executes".

    PYTHONPATH=src python -m repro_torch.examples.fleet_scheduler \
        [--device cpu]

The port of the reference's ``examples/fleet_scheduler.py``: the same
calls and lines, on ``--device`` (None = the card).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.api import Planner, PlanRequest, window_profile
from repro_torch.core import generate_profile
from repro_torch.core.dag import build_instance
from repro_torch.kernels.backend import resolve_device
from repro_torch.runtime.carbon_gate import chunk_workflow, fleet_platform

# the port's own dry-run records (launch/dryrun.py's default --out, from
# the repository's root), never the reference's experiments/dryrun
DRYRUN = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                      "experiments", "dryrun_torch")
FALLBACK = "fallback"

N_ENSEMBLE = 8
N_WINDOWS = 3


def step_seconds(arch: str, shape: str) -> tuple[float, str]:
    """A step's roofline bound and where it came from: the port's dry-run
    record ``{arch}_{shape}_none.json`` when its roofline was taken on an
    H100 spec (the path), else 1 s (:data:`FALLBACK`). A ``none`` record
    bounds one card's step, not a pod's; the reference reads its
    ``single`` records, which are rated on a TPU."""
    path = os.path.join(DRYRUN, f"{arch}_{shape}_none.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        if d.get("roofline", {}).get("hw", "").startswith("h100"):
            return max(d["roofline"]["bound_s"], 0.05), path
    return 1.0, FALLBACK


# per fleet: (pod0 job mix, pod1 job mix); (arch, shape, chunks, steps)
FLEETS = {
    "train-heavy": (
        [("qwen2.5-3b", "train_4k", 10, 50),
         ("smollm-360m", "train_4k", 6, 100)],
        [("granite-34b", "train_4k", 8, 25),
         ("whisper-large-v3", "train_4k", 5, 40)],
    ),
    "mixed-serve": (
        [("qwen2.5-3b", "train_4k", 6, 30),
         ("whisper-large-v3", "train_4k", 8, 60)],
        [("smollm-360m", "train_4k", 12, 80)],
    ),
}


def chunks(jobs, sources: dict | None = None):
    """Each job's chunk durations (seconds); ``sources`` collects where
    each (arch, shape)'s step seconds came from."""
    out = []
    for arch, shape, n_chunks, steps in jobs:
        sec, src = step_seconds(arch, shape)
        if sources is not None:
            sources[f"{arch}/{shape}"] = src
        out += [max(int(sec * steps), 1)] * n_chunks
    return out


def build_fleet(plat, jobs0, jobs1, sources: dict | None = None):
    c0, c1 = chunks(jobs0, sources), chunks(jobs1, sources)
    wf, mapping = chunk_workflow([len(c0), len(c1)], [c0, c1])
    inst = build_instance(wf, mapping, plat, dur=wf.node_w)
    horizon = int(2.5 * max(sum(c0), sum(c1)))
    return inst, horizon, wf


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the planner (default: the card)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Plan both fleets robustly, search fleet 0's mapping and replan it
    over a rolling horizon; prints the reference's lines and returns the
    variants, costs and starts they show."""
    dev = resolve_device(args.device)
    plat = fleet_platform(pods=2, chip_watts_idle=100, chip_watts_work=250,
                          chips_per_pod=256)
    names, instances, ensembles, fleet_wfs = [], [], [], []
    sources: dict = {}
    for name, (jobs0, jobs1) in FLEETS.items():
        inst, horizon, wf = build_fleet(plat, jobs0, jobs1, sources)
        fleet_wfs.append(wf)
        # ensemble: one nominal forecast + perturbed members (same interval
        # grid, resampled budget noise — forecast uncertainty)
        profs = [generate_profile("S3", horizon, plat, J=48, seed=3 + s,
                                  work_capacity=int(plat.p_work[:2].sum()))
                 for s in range(N_ENSEMBLE)]
        names.append(name)
        instances.append(inst)
        ensembles.append(profs)

    # ONE plan call: both fleets x 8 members x 17 variants (the combined
    # grid; per-fleet cells are bit-identical to planning each alone)
    planner = Planner(plat, engine="auto", device=dev)
    res = planner.plan(PlanRequest(instances=instances, profiles=ensembles,
                                   robust=True))

    fleets = {}
    for i, name in enumerate(names):
        inst, profs = instances[i], ensembles[i]
        costs, vnames = res.cost_matrix(i)
        robust, worst_cost = res.robust(i)
        asap_worst = costs[:, vnames.index("asap")].max()
        nominal_best = res.best(i, 0).variant

        print(f"\n[{name}] horizon {profs[0].T}s, {inst.num_tasks} chunk "
              f"tasks, {N_ENSEMBLE} forecast members "
              f"(engine={res.engine})")
        print(f"  robust (min-max) variant: {robust} "
              f"(worst-member carbon {worst_cost}; ASAP worst {asap_worst},"
              f" {worst_cost / max(asap_worst, 1):.2f}x)")
        if nominal_best != robust:
            print(f"  nominal-only pick would be {nominal_best} "
                  f"(worst-member carbon "
                  f"{costs[:, vnames.index(nominal_best)].max()})")
        best = res.pick(i)
        starts = []
        for pod, chain in enumerate(inst.proc_chains[:2]):
            starts.append([int(best.start[t]) for t in chain])
            print(f"  pod{pod} chunk starts: {starts[-1][:10]}"
                  f"{'...' if len(starts[-1]) > 10 else ''}")
        fleets[name] = {"robust": robust, "worst": int(worst_cost),
                        "asap_worst": int(asap_worst),
                        "nominal_best": nominal_best, "starts": starts}

    # --- joint mapping x scheduling of fleet 0 ----------------------------
    # `mapping="search"` makes the chunk->pod placement a decision
    # variable: candidate placements fan out through the same batched
    # grid, and the cheapest (mapping, schedule) pair wins
    wf0, nominal = fleet_wfs[0], ensembles[0][0]
    res_fixed = planner.plan(PlanRequest(instances=instances[0],
                                         profiles=nominal))
    res_joint = planner.plan(PlanRequest(
        instances=wf0, profiles=nominal, mapping="search",
        mapping_options={"seeds": 4, "rounds": 2, "neighbors": 6}))
    cost_fixed = res_fixed.best().cost
    cost_joint = res_joint.best().cost
    info = res_joint.mapping_info[0]
    print(f"\n[joint mapping x scheduling] fleet {names[0]}, nominal "
          f"forecast")
    print(f"  fixed chunk->pod mapping: carbon {cost_fixed}")
    print(f"  searched mapping ({info.candidates} candidates, "
          f"{info.rounds} rounds, winner {info.label!r}): "
          f"carbon {cost_joint} "
          f"({(cost_fixed - cost_joint) / max(cost_fixed, 1) * 100:.1f}% "
          f"saved)")

    # --- async rolling-horizon replanning of fleet 0 ----------------------
    inst, W = instances[0], ensembles[0][0].T
    long = generate_profile("S3", N_WINDOWS * W, plat, J=96, seed=42,
                            work_capacity=int(plat.p_work[:2].sum()))

    def wprofs(k):      # window slice + perturbed members, same horizon W
        return [window_profile(long, k * W, W)] + [
            generate_profile("S3", W, plat, J=48, seed=60 + 8 * k + j,
                             work_capacity=int(plat.p_work[:2].sum()))
            for j in range(3)]

    print(f"\n[rolling horizon] fleet {names[0]}, {N_WINDOWS} windows of "
          f"{W}s (window k+1 planned while k executes)")
    windows = []
    with planner.session(inst, wprofs, n_windows=N_WINDOWS) as sess:
        for k, plan in sess.windows():
            robust, worst = plan.robust(0)
            windows.append((robust, int(worst)))
            print(f"  window {k}: robust={robust} worst-member={worst} "
                  f"(planned in {plan.seconds * 1e3:.0f} ms)")
    return {"device": str(dev), "engine": res.engine, "fleets": fleets,
            "step_sources": sources,
            "joint": {"fixed": int(cost_fixed), "searched": int(cost_joint),
                      "candidates": info.candidates, "rounds": info.rounds,
                      "winner": info.label},
            "windows": windows}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
