#!/usr/bin/env python3
"""Time the scheduler kernels, or the train step, of two checkouts on one
NVIDIA GPU, in turns.

    python3 chip_ab.py [--train | --plan] [--rounds N] PARENT_ROOT

The change is the checkout this script lies in. For each run, a process
of its own imports that checkout's ``chip_smoke.py`` and builds its
kernels. By default it then runs its kernel phases: the gain sweep
against its plain version at the climb's shape (R=32, Np=4352, Tp=1024;
mu = 10 and 42) and the deficit timeline at the plan's shape (N=4304,
T=776) and the large one (N=30000, T=4096), each with the profiler's
device time, a CUDA-graph replay, eager CUDA events and the plain
version's time, and its ``phase_scan_kernels``: the greedy scan (R=32,
Np=4352, Tp=1024) and the first climb round's commit scan (K=32, dense
adjacency) at atacseq's bucket, each with the profiler's device time and
eager CUDA events. It then times the cost oracle's call,
``ops.carbon_cost`` on numpy arrays at the plan's shape, on the host
clock, each call ending in the copy of its cost to the host. With
``--train`` it runs instead the train entry point as ``chip_smoke.py``'s
``[train]`` (a) calls it (its arch, steps, batch and sequence, the
CarbonGate, checkpoints), with no mesh, and reads its step seconds: the
cold first step and the median, least and most of the warm ones. With
``--plan`` it runs instead ``chip_smoke.py``'s ``[plan]`` (the 4 x 4 x 17
matrix planned cold on the card, with its checks) and reads the cold
plan's seconds and its phase split (``PlanResult.phase_seconds``). The
runs go parent, change, change, parent, ``N`` times over (default 1), so
both are measured in one call on one card. Prints one ``AB {...}`` JSON
line per run, then the card's name and power limit and one JSON summary
line: each metric's readings per side, in run order, and their median.
"""
from __future__ import annotations

import json
import operator
import os
import subprocess
import sys

CHILD = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as cs
sys.path.insert(0, cs.SRC)
import numpy as np
import torch
from repro_torch.kernels import ops

dev = torch.device("cuda")
cs.build_kernels()
gain = cs.phase_kernels(dev)
deficit = cs.phase_deficit(dev)
# the two loop kernels at atacseq's bucket (R=32, Np=4352, Tp=1024, K=32),
# from the checkout's own [kernels] phase, which times them alike in both
plat, insts, grid = cs.build_matrix(("atacseq",))
scan = cs.phase_scan_kernels(dev, plat, insts, grid)
rng = np.random.default_rng(1)
N, T = cs.DEFICIT_PLAN
start = rng.integers(0, T - 20, N)
dur = rng.integers(1, 20, N)
work = rng.integers(0, 120, N)
g = rng.integers(0, 2500, T)
for _ in range(10):
    float(ops.carbon_cost(start, dur, work, g))
reps = 500
t0 = time.perf_counter()
for _ in range(reps):
    float(ops.carbon_cost(start, dur, work, g))
oracle_ms = 1e3 * (time.perf_counter() - t0) / reps
print("AB " + json.dumps({"gain": gain, "deficit": deficit, "scan": scan,
                          "oracle_ms": oracle_ms}), flush=True)
"""

TRAIN_CHILD = r"""
import json, os, sys, tempfile
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as cs
sys.path.insert(0, cs.SRC)
import numpy as np
import torch
from repro_torch import obs
from repro_torch.configs import ARCHS
from repro_torch.launch.train import train

obs.configure(tracing=False, torch_hooks_on=True)      # as chip_smoke's main
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.build_kernels()
with tempfile.TemporaryDirectory(prefix="chip_ab_train_") as tmp:
    out = train(ARCHS[cs.TRAIN_ARCH], steps=cs.TRAIN_STEPS, batch=cs.TRAIN_B,
                seq=cs.TRAIN_S, carbon_gate=True,
                ckpt_dir=os.path.join(tmp, "cli"),
                device=torch.device("cuda"), log=lambda m: None)
secs = out["step_seconds"]
print("AB " + json.dumps({"cold_s": secs[0],
                          "warm_s": float(np.median(secs[1:])),
                          "warm_min_s": min(secs[1:]),
                          "warm_max_s": max(secs[1:])}), flush=True)
"""

PLAN_CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as cs
sys.path.insert(0, cs.SRC)
import torch
from repro_torch import obs

obs.configure(tracing=False, torch_hooks_on=True)      # as chip_smoke's main
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.build_kernels()
plat, insts, grid = cs.build_matrix()
cold, _, cold_s = cs.phase_plan(plat, insts, grid)
print("AB " + json.dumps({"cold_s": cold_s, **cold.phase_seconds}),
      flush=True)
"""

PLAN_METRICS = {f"plan_{k}": operator.itemgetter(k) for k in
                ("cold_s", "rows", "greedy", "climb", "polish")}

TRAIN_METRICS = {f"train_{k}": operator.itemgetter(k) for k in
                 ("cold_s", "warm_s", "warm_min_s", "warm_max_s")}

METRICS = {                     # summary name -> how to read it from a run
    "gain_scan_mu10_ms": lambda r: r["gain"][0]["ms"],
    "gain_scan_mu42_ms": lambda r: r["gain"][1]["ms"],
    "carbon_cost_plan_ms": lambda r: r["deficit"][0]["ms"],
    "carbon_cost_large_ms": lambda r: r["deficit"][1]["ms"],
    "oracle_ms_per_call": lambda r: r["oracle_ms"],
    **{f"{name}_{key}": (lambda r, name=name, key=key:
                         r["scan"][name][key])
       for name in ("greedy_scan", "commit_scan")
       for key in ("profiler_ms", "event_ms")},
}


def run(root: str, child: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", child, root],
                          capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"chip_ab: the run of {root} failed "
                         f"(exit {proc.returncode})")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    return json.loads(line[-1][3:])


def main() -> int:
    import argparse
    import statistics

    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("parent")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--plan", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    child, metrics = ((TRAIN_CHILD, TRAIN_METRICS) if args.train
                      else (PLAN_CHILD, PLAN_METRICS) if args.plan
                      else (CHILD, METRICS))
    parent = os.path.abspath(args.parent)
    change = os.path.dirname(os.path.abspath(__file__))
    order = (("parent", parent), ("change", change), ("change", change),
             ("parent", parent)) * args.rounds
    runs = {"parent": [], "change": []}
    for label, root in order:
        print(f"[ab] {label}: {root}", flush=True)
        runs[label].append(run(root, child))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    summary = {}
    for name, read in metrics.items():
        readings = {label: [read(r) for r in rs]
                    for label, rs in runs.items()}
        summary[name] = {**readings, "median": {
            label: statistics.median(xs) for label, xs in readings.items()}}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
