#!/usr/bin/env python3
"""Time the scheduler kernels of two checkouts on one NVIDIA GPU, in turns.

    python3 chip_ab.py PARENT_ROOT

The change is the checkout this script lies in. For each run, a process
of its own imports that checkout's ``chip_smoke.py``, builds its
kernels and runs its kernel phases: the gain sweep against its plain
version at the climb's shape (R=32, Np=4352, Tp=1024; mu = 10 and 42) and
the deficit timeline at the plan's shape (N=4304, T=776) and the large one
(N=30000, T=4096), each with the profiler's device time, a CUDA-graph
replay, eager CUDA events and the plain version's time. It then times the
cost oracle's call, ``ops.carbon_cost`` on numpy arrays at the plan's
shape, on the host clock, each call ending in the copy of its cost to the
host. The runs go parent, change, change, parent, so both are measured in
one call on one card. Prints one ``AB {...}`` JSON line per run, then the
card's name and power limit and one JSON summary line.
"""
from __future__ import annotations

import json
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
print("AB " + json.dumps({"gain": gain, "deficit": deficit,
                          "oracle_ms": oracle_ms}), flush=True)
"""

METRICS = {                     # summary name -> how to read it from a run
    "gain_scan_mu10_ms": lambda r: r["gain"][0]["ms"],
    "gain_scan_mu42_ms": lambda r: r["gain"][1]["ms"],
    "carbon_cost_plan_ms": lambda r: r["deficit"][0]["ms"],
    "carbon_cost_large_ms": lambda r: r["deficit"][1]["ms"],
    "oracle_ms_per_call": lambda r: r["oracle_ms"],
}


def run(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, root],
                          capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"chip_ab: the run of {root} failed "
                         f"(exit {proc.returncode})")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    return json.loads(line[-1][3:])


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = os.path.abspath(sys.argv[1])
    change = os.path.dirname(os.path.abspath(__file__))
    order = (("parent", parent), ("change", change), ("change", change),
             ("parent", parent))
    runs = {"parent": [], "change": []}
    for label, root in order:
        print(f"[ab] {label}: {root}", flush=True)
        runs[label].append(run(root))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    summary = {name: {label: [read(r) for r in rs]
                      for label, rs in runs.items()}
               for name, read in METRICS.items()}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
