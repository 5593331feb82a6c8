#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Needs one CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA; imports nothing of JAX or of the
reference package ``repro``. Phases, each fatal on failure:

1. device check (name and power limit);
2. build of the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. every kernel against its plain PyTorch version on the card, bitwise,
   at the shapes the main path gives it, with the kernel's device time
   (``torch.profiler``, else a CUDA-graph replay), the eager CUDA-event
   time and the plain version's time; the profiler's tables are written
   to ``chiprun_out/chip_smoke_profile.txt``;
4. the main path: ``Planner(platform, engine="torch").plan(...)`` on the
   paper's section 6.1 matrix (72-processor small cluster, the four nf-core
   families at 2000 workflow tasks, HEFT-mapped, deadline 2x ASAP, the
   S1-S4 ensemble, all 17 variants), cold and warm; every schedule is
   validated, every -LS cost is <= its greedy cost, and the non-LS columns
   equal the port's numpy engine bitwise;
5. one instance re-planned on the CPU: starts and costs equal the card's;
6. that instance re-planned through the blocked longest-path form: starts
   equal the dense form's.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before either is printed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
KINDS = ("atacseq", "bacass", "eager", "methylseq")
WF_TASKS = 2000          # workflow tasks per instance (wfgen_scale target)
NODES_PER_TYPE = 12      # the paper's small cluster: 72 compute processors
FACTOR = 2.0             # deadline = 2 x ASAP makespan
SCENARIOS = ("S1", "S2", "S3", "S4")
J = 48                   # profile intervals
PROFILE_SEED = 17
PROFILE_OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.txt")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM published memory rate
F32_OPS_PER_S = 67e12        # H100 SXM published f32 rate (no tensor cores)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 5) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` warm launches (CUDA
    events around the whole run, then one synchronize)."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` replayed from one CUDA graph
    that holds ``reps`` calls: the device's time without the host's cost
    of enqueueing each launch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_ms(fn, reps: int, kernel: str, out_path: str):
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, from ``torch.profiler`` over ``reps`` warm calls of ``fn``;
    None when the profiler records no device time for it. The profiler's
    table goes to ``out_path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "a") as f:
        f.write(avgs.table(row_limit=20) + "\n")
    total_us, count = 0.0, 0
    for ev in avgs:
        if kernel in ev.key:
            total_us += float(getattr(ev, "device_time_total", 0.0)
                              or getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    if count == 0 or total_us <= 0.0:
        return None
    check(count == reps, f"profiler saw {count} launches of {kernel}, "
          f"expected {reps}")
    return total_us / count / 1e3


def gain_inputs(R, N, T, mu, seed, dev):
    """Random gain-sweep inputs at the climb's shapes and dtypes."""
    import torch

    g = torch.Generator().manual_seed(seed)
    rem = torch.randint(-40, 40, (R, T), generator=g).float()
    dur = torch.randint(1, 12, (N,), generator=g).int()
    work = torch.randint(0, 30, (N,), generator=g).float()
    start = torch.randint(0, T - 12, (R, N), generator=g).int()
    lo = (-torch.randint(0, 2 * mu + 5, (R, N), generator=g)).float()
    hi = torch.randint(0, 2 * mu + 5, (R, N), generator=g).float()
    return [x.to(dev).contiguous() for x in (rem, start, dur, work, lo, hi)]


def edge_inputs(R, N, T, mu, dev):
    """Tasks at t=0 and at the horizon (windows clipped on both sides),
    rows with no legal move, zero-work tasks, and an all-equal timeline so
    that many shifts tie."""
    import torch

    args = gain_inputs(R, N, T, mu, seed=7, dev="cpu")
    rem, start, dur, work, lo, hi = args
    start[:, 0::4] = 0                           # at t = 0
    start[:, 1::4] = T - dur[1::4]               # ending at the horizon
    start[:, 2::4] = T - 1                       # overrunning the horizon
    work[5::16] = 0.0                            # zero work: never legal
    rem[R // 2:] = 3.0                           # ties everywhere
    lo[R // 2:], hi[R // 2:] = -float(mu), float(mu)
    lo[:, 3::8] = 5.0                            # lo > hi: no legal move
    hi[:, 3::8] = -5.0
    return [x.to(dev).contiguous() for x in (rem, start, dur, work, lo, hi)]


def gain_bound_ms(R, N, T, mu) -> tuple[float, str]:
    """Least time for one gain sweep: bytes moved (each input read once,
    the output written once) over the memory rate, against the f32
    operations (17 per candidate and shift) over the f32 rate."""
    D = 2 * mu + 1
    nbytes = 4 * (R * T + 3 * R * N + 2 * N + R * N * D)
    ops = 17 * R * N * 2 * mu
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(dev):
    """Kernel vs its plain version on the card, bitwise; times."""
    import torch

    from repro_torch.kernels import gain_scan

    rows = []
    R, Np, Tp = 32, 4352, 1024          # the slice's climb shapes
    for mu in (10, 42):
        args = gain_inputs(R, Np, Tp, mu, seed=mu, dev=dev)
        got = gain_scan.gain_sweep(*args, mu=mu)
        want = gain_scan.gain_sweep(*args, mu=mu, mode="plain")
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"gain_scan kernel != plain at mu={mu}")
        err = float((got - want).abs().max())

        def kernel():
            gain_scan.gain_sweep(*args, mu=mu)

        event_ms = cuda_ms(kernel, reps=200)
        replay_ms = graph_ms(kernel, reps=200)
        device_ms = profiled_ms(kernel, 200, "gain_scan_kernel",
                                PROFILE_OUT)
        plain_ms = cuda_ms(
            lambda: gain_scan.gain_sweep(*args, mu=mu, mode="plain"),
            reps=20)
        bound, by = gain_bound_ms(R, Np, Tp, mu)
        # the kernel's own time: the profiler's device time where it has
        # one, else the graph replay (which still holds the launch gaps)
        ms, ms_from = ((device_ms, "profiler") if device_ms is not None
                       else (replay_ms, "graph"))
        rows.append({"mu": mu, "max_abs_err": err, "ms": ms,
                     "ms_from": ms_from, "profiler_ms": device_ms,
                     "graph_ms": replay_ms, "event_ms": event_ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by})
        log(f"[kernels] gain_scan R={R} Np={Np} Tp={Tp} mu={mu}: bitwise "
            f"equal; kernel {ms:.4f} ms ({ms_from}; profiler "
            f"{device_ms}, graph replay {replay_ms:.4f}, eager events "
            f"{event_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound:.4f} "
            f"ms ({by}), {100 * bound / ms:.1f}% of bound")
    for mu in (10, 42):
        args = edge_inputs(R, 256, 128, mu, dev)
        got = gain_scan.gain_sweep(*args, mu=mu)
        want = gain_scan.gain_sweep(*args, mu=mu, mode="plain")
        check(torch.equal(got, want),
              f"gain_scan kernel != plain on the edge/tie case, mu={mu}")
        check(bool((got[:, 3::8] == gain_scan.NEG).all()),
              "rows with lo > hi must be all-illegal")
        check(bool((got[:, :, mu] == gain_scan.NEG).all()),
              "delta = 0 must be illegal")
    log("[kernels] gain_scan edge and tie cases: bitwise equal")
    return rows


def build_matrix():
    """The paper's section 6.1 matrix at 2000 workflow tasks."""
    from repro_torch.cluster import make_cluster
    from repro_torch.core import (build_instance, deadline_from_asap,
                                  generate_profile, heft_mapping)
    from repro_torch.core.carbon import work_timeline
    from repro_torch.core.estlst import asap_schedule
    from repro_torch.workflows import wfgen_scale

    plat = make_cluster(NODES_PER_TYPE, seed=SEED)
    insts, grid = [], []
    for kind in KINDS:
        wf = wfgen_scale(kind, WF_TASKS, seed=SEED)
        inst = build_instance(wf, heft_mapping(wf, plat), plat)
        # green capacity calibrated to the workload's mean ASAP draw, as
        # the reference benchmark matrix does
        asap = asap_schedule(inst)
        peak = int(work_timeline(inst, deadline_from_asap(inst, 1.0),
                                 asap).mean())
        T = deadline_from_asap(inst, FACTOR)
        grid.append([generate_profile(s, T, plat, J=J, seed=PROFILE_SEED,
                                      work_capacity=peak)
                     for s in SCENARIOS])
        insts.append(inst)
        log(f"[matrix] {kind}: N_c={inst.num_tasks} T={T} "
            f"work_capacity={peak}")
    return plat, insts, grid


def timed_plan(planner, request):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = planner.plan(request)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_plan(plat, insts, grid):
    import numpy as np

    from repro_torch.api import Planner, PlanRequest
    from repro_torch.core import validate_schedule
    from repro_torch.core.portfolio import PORTFOLIO_VARIANTS
    from repro_torch.kernels import gain_scan

    planner = Planner(plat, engine="torch")
    request = PlanRequest(instances=insts, profiles=grid)
    gain_scan.LAUNCHES = 0
    cold, cold_s = timed_plan(planner, request)
    launches = gain_scan.LAUNCHES
    check(launches > 0, "the plan did not launch the gain_scan kernel")
    warm, warm_s = timed_plan(planner, request)
    I, P, V = cold.costs.shape
    check((I, P, V) == (len(insts), len(SCENARIOS), 17),
          f"cost tensor shape {cold.costs.shape}")
    check(np.array_equal(cold.costs, warm.costs), "warm plan != cold plan")
    log(f"[plan] I x P x V = {I} x {P} x {V}, engine={cold.engine}; cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s; gain_scan launches "
        f"{launches} (cold plan)")
    for tag, res in (("cold", cold), ("warm", warm)):
        split = ", ".join(f"{k} {v:.3f}" for k, v in
                          res.phase_seconds.items())
        log(f"[plan] {tag} split (s): {split}")

    names = cold.variants
    for i, inst in enumerate(insts):
        for p, prof in enumerate(grid[i]):
            cell = cold.results[i][p]
            for n in names:
                validate_schedule(inst, prof, cell[n].start)
                if n.endswith("-LS"):
                    check(cell[n].cost <= cell[n[:-3]].cost,
                          f"{n} costs more than its greedy in cell {i},{p}")
    log(f"[plan] validated {I * P * V} schedules; every -LS cost <= its "
        f"greedy cost")

    plain_names = tuple(n for n in PORTFOLIO_VARIANTS
                        if not n.endswith("-LS"))
    t0 = time.perf_counter()
    ref = Planner(plat, engine="numpy").plan(
        PlanRequest(instances=insts, profiles=grid, variants=plain_names))
    numpy_s = time.perf_counter() - t0
    cols = [names.index(n) for n in plain_names]
    check(np.array_equal(cold.costs[:, :, cols], ref.costs),
          "non-LS costs differ from the numpy engine")
    for i in range(I):
        for p in range(P):
            for n in plain_names:
                check(np.array_equal(cold.results[i][p][n].start,
                                     ref.results[i][p][n].start),
                      f"{n} starts differ from the numpy engine ({i},{p})")
    log(f"[plan] non-LS columns equal the numpy engine bitwise (numpy "
        f"engine {numpy_s:.3f} s)")
    asap = names.index("asap")
    for i, kind in enumerate(KINDS):
        best = cold.best_costs()[i]
        rv, rworst = cold.robust(i)
        nominal = cold.best(i, 0).variant
        saving = 1.0 - best / np.maximum(cold.costs[i, :, asap], 1)
        log(f"[plan] {kind}: best per profile {best.tolist()} (asap "
            f"{cold.costs[i, :, asap].tolist()}, saving "
            f"{np.round(saving, 4).tolist()}); nominal best {nominal}; "
            f"robust {rv} (worst {rworst})")
    return cold, launches, cold_s, warm_s


def phase_cpu(plat, insts, grid, card, i):
    import numpy as np

    from repro_torch.api import Planner, PlanRequest

    t0 = time.perf_counter()
    res = Planner(plat, engine="torch", device="cpu").plan(
        PlanRequest(instances=insts[i], profiles=grid[i]))
    secs = time.perf_counter() - t0
    check(np.array_equal(res.costs[0], card.costs[i]),
          "CPU costs differ from the card's")
    for p in range(len(grid[i])):
        for n in res.variants:
            check(np.array_equal(res.results[0][p][n].start,
                                 card.results[i][p][n].start),
                  f"CPU starts differ from the card's: {n}, profile {p}")
    log(f"[cpu] {KINDS[i]} re-planned on the CPU in {secs:.3f} s: starts "
        f"and costs equal the card's bitwise")


def phase_blocked(plat, insts, grid, card, i):
    import numpy as np

    from repro_torch.api import Planner, PlanRequest
    from repro_torch.core import lp_matrix_bytes

    budget = lp_matrix_bytes(insts[i].num_tasks) // 2
    planner = Planner(plat, engine="torch", lp_budget_bytes=budget)
    res, secs = timed_plan(planner, PlanRequest(instances=insts[i],
                                                profiles=grid[i]))
    g = planner.prepared(insts[i], grid[i][0].T)
    check(g.lp_is_blocked, "the blocked budget did not select BlockedLP")
    check(np.array_equal(res.costs[0], card.costs[i]),
          "blocked costs differ from the dense form's")
    for p in range(len(grid[i])):
        for n in res.variants:
            check(np.array_equal(res.results[0][p][n].start,
                                 card.results[i][p][n].start),
                  f"blocked starts differ from the dense form's: {n}, {p}")
    log(f"[blocked] {KINDS[i]} re-planned with lp_budget_bytes={budget} "
        f"(BlockedLP + padded adjacency) in {secs:.3f} s: starts equal "
        f"the dense form's bitwise")


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure(
            f"{SRC}/repro_torch not found: run chip_smoke.py from the root "
            f"of a checkout of the repository")
    sys.path.insert(0, SRC)
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    dev = torch.device("cuda")
    if os.path.exists(PROFILE_OUT):
        os.remove(PROFILE_OUT)

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("gain_scan")
    log(f"[build] gain_scan.cu built and loaded in "
        f"{time.perf_counter() - t0:.3f} s")

    gain_rows = phase_kernels(dev)

    t0 = time.perf_counter()
    plat, insts, grid = build_matrix()
    log(f"[matrix] built in {time.perf_counter() - t0:.3f} s")
    card, launches, _, _ = phase_plan(plat, insts, grid)
    eager = KINDS.index("eager")           # the smallest instance
    phase_cpu(plat, insts, grid, card, eager)
    phase_blocked(plat, insts, grid, card, eager)

    main_mu = gain_rows[0]
    kernels = {"kernels": [{
        "name": "gain_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gain_scan.cu",
        "replaces": "src/repro/kernels/gain_scan.py:60",
        "launches": launches,
        "max_abs_err": main_mu["max_abs_err"],
        "ms": main_mu["ms"],
        "ms_from": main_mu["ms_from"],
        "event_ms": main_mu["event_ms"],
        "graph_ms": main_mu["graph_ms"],
        "plain_ms": main_mu["plain_ms"],
        "bound_ms": main_mu["bound_ms"],
        "bound_by": main_mu["bound_by"],
        "library_ms": None,
        "bitwise_vs_plain": True,
        "shape": "R=32 Np=4352 Tp=1024 mu=10",
        "mu42": gain_rows[1],
    }]}
    log(f"[done] {time.perf_counter() - t_start:.3f} s in all")
    print(f"{smi}", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
