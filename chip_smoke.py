#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Needs one CUDA card, the CUDA toolkit
(``nvcc``) and PyTorch built for CUDA; imports nothing of JAX or of the
reference package ``repro``. Phases, each fatal on failure:

1. device check (name and power limit);
2. build of the hand-written kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together;
3. every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: the gain sweep bitwise; the deficit
   timeline bitwise on integer inputs (the reference's sweep shapes, the
   plan's shape, a 30,000-task shape, edge cases) and within a stated
   reorder bound on fractional works; each with the kernel's device time
   (``torch.profiler``, else a CUDA-graph replay), the eager CUDA-event time
   and the plain version's time; the profiler's tables are written to the
   file ``PROFILE_OUT`` names;
4. the heuristic plan: ``Planner(platform, engine="torch").plan(...)`` on
   the paper's section 6.1 matrix (72-processor small cluster, the four
   nf-core families at 2000 workflow tasks, HEFT-mapped, deadline 2x ASAP,
   the S1-S4 ensemble, all 17 variants), cold and warm; every schedule is
   validated, every -LS cost is <= its greedy cost, and the non-LS columns
   equal the port's numpy engine bitwise;
5. the cost oracle: every schedule of that plan costed through
   ``ops.carbon_cost`` on the card equals its int64 cost, and its deficit
   timeline equals numpy's bitwise;
6. one instance re-planned on the CPU against its four profiles: starts
   and costs equal the card's;
7. that instance re-planned through the blocked longest-path form: starts
   equal the dense form's;
8. the exact solver axis on small instances (``solver="exact"``, ``"ilp"``
   and ``"dp"``): the lower bounds hold against a card heuristic plan,
   ``gap() >= 1``, DP equals ILP on a processor chain, and every exact
   schedule costs the same through the kernel;
9. a three-window rolling-horizon session (``planner.session``) of the
   ``eager`` instance against ``window_profile`` slices of the S1-S4
   forecasts: every window equals an eager plan of it bitwise, the
   session's gain-kernel launches equal those eager plans', and every
   schedule costs the same through the kernel.

Each path (4, 5, 8, 9) is driven with the kernels' launch counts set to 0
just before it and read just after; a kernel the path runs that was never
launched fails the run. The line before the last is a JSON object with one
entry per kernel; the last line is ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before either is printed.
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


def profiled_ms(fn, reps: int, kernel: str, out_path: str, tries: int = 2):
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, from ``torch.profiler`` over ``reps`` warm calls of ``fn``;
    None when the profiler records no device time for it. The profiler's
    table goes to ``out_path``. A trace that holds fewer than ``reps``
    launches of the kernel (the profiler dropped events) is taken again,
    up to ``tries`` traces in all; the time comes only from a complete
    one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
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
        if count == reps:
            return total_us / count / 1e3
        log(f"[kernels] profiler trace {attempt} of {tries} saw {count} of "
            f"{reps} launches of {kernel}")
    raise SmokeFailure(f"profiler saw {count} launches of {kernel}, "
                       f"expected {reps}, in each of {tries} traces")


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


def build_kernels():
    """Build every kernel source at once: one nvcc per source, started
    together, then load each library."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = ("gain_scan", "carbon_cost")

    def build(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(build, names)))
    for name in names:
        _build.load(name)
    log(f"[build] " + ", ".join(f"{n}.cu {secs[n]:.3f} s" for n in names)
        + f" (in parallel; {time.perf_counter() - t0:.3f} s in all)")


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


DEFICIT_SWEEP = [(n, t) for n in (1, 7, 63, 300, 1000)
                 for t in (16, 700, 2048)]   # tests/test_kernels.py's sweep
DEFICIT_PLAN = (4304, 776)       # the plan's largest instance and horizon
DEFICIT_LARGE = (30000, 4096)    # the paper's largest workflows


def deficit_inputs(n, t, seed):
    """Integer task windows, works and budgets (tests/test_kernels.py's
    generator), as numpy f32: starts, ends, works, g."""
    import numpy as np

    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(t - 20, 1), n).astype(np.float32)
    durs = rng.integers(1, 20, n).astype(np.float32)
    works = rng.integers(0, 120, n).astype(np.float32)
    g = rng.integers(0, 2500, t).astype(np.float32)
    return starts, starts + durs, works, g


def deficit_edges(t=300, seed=11, frac_work=False):
    """Fractional and negative starts, ends past the horizon, zero-length
    tasks and a budget that goes negative."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 97
    starts = rng.integers(-40, t + 10, n).astype(np.float32)
    starts[::3] += rng.choice([0.25, 0.5, 0.75], len(starts[::3]))
    durs = rng.integers(0, 60, n).astype(np.float32)
    durs[1::5] += 0.5
    durs[2::7] = 0.0
    ends = starts + durs
    ends[4::9] = t + rng.integers(1, 50, len(ends[4::9]))
    works = rng.integers(0, 120, n).astype(np.float32)
    if frac_work:
        works = works + rng.random(n).astype(np.float32)
    g = rng.integers(-200, 1500, t).astype(np.float32)
    return starts, ends.astype(np.float32), works, g


def deficit_bound_ms(N, T) -> tuple[float, str]:
    """Least time for one deficit timeline: each input read once and the
    output written once, (3 N + 2 T) * 4 bytes over the memory rate,
    against the 2 N + 3 T f32 operations of its difference-array form (two
    scatter-adds per task; a prefix add, a subtraction and a max per unit)
    over the f32 rate."""
    t_bytes = 4 * (3 * N + 2 * T) / HBM_BYTES_PER_S
    t_ops = (2 * N + 3 * T) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_deficit(dev):
    """The deficit-timeline kernel against its plain version on the card;
    times at the plan's shape and at the large shape."""
    import numpy as np
    import torch

    from repro_torch.kernels import carbon_cost

    def on_card(args):
        return [torch.as_tensor(a, device=dev) for a in args]

    cases = [(f"sweep n={n} t={t}", deficit_inputs(n, t, n * 1000 + t))
             for n, t in DEFICIT_SWEEP]
    cases += [("plan", deficit_inputs(*DEFICIT_PLAN, seed=1)),
              ("large", deficit_inputs(*DEFICIT_LARGE, seed=2)),
              ("edges", deficit_edges())]
    worst = 0.0
    for label, args in cases:
        x = on_card(args)
        got = carbon_cost.deficit_timeline(*x)
        want = carbon_cost.deficit_timeline(*x, mode="plain")
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"carbon_cost kernel != plain ({label})")
        check(bool(torch.isfinite(got).all()), f"non-finite timeline "
              f"({label})")
        worst = max(worst, float(got.max()))
    # integer works: every partial sum below 2^24 is exact, so fractional
    # windows change which units are active, never the arithmetic; with
    # fractional works two summation orders of n terms differ by at most
    # 2 (n - 1) u sum|w| (u = 2^-24)
    args = deficit_edges(frac_work=True)
    x = on_card(args)
    n = len(args[2])
    tol = 2 * (n - 1) * 2.0 ** -24 * float(np.abs(args[2]).sum())
    frac_err = float((carbon_cost.deficit_timeline(*x) - carbon_cost
                      .deficit_timeline(*x, mode="plain")).abs().max())
    check(frac_err <= tol, f"carbon_cost kernel differs from plain by "
          f"{frac_err} > {tol} on fractional works")
    log(f"[kernels] carbon_cost: bitwise equal on {len(cases)} integer "
        f"cases (largest unit deficit {worst}); fractional works within "
        f"{frac_err:.3g} <= {tol:.3g}")

    rows = []
    for label, (N, T) in (("plan", DEFICIT_PLAN), ("large", DEFICIT_LARGE)):
        starts, ends, works, g = on_card(
            deficit_inputs(N, T, seed=1 if label == "plan" else 2))
        err = float((carbon_cost.deficit_timeline(starts, ends, works, g)
                     - carbon_cost.deficit_timeline(
                         starts, ends, works, g, mode="plain")).abs().max())

        def kernel():
            carbon_cost.deficit_timeline(starts, ends, works, g)

        event_ms = cuda_ms(kernel, reps=200)
        replay_ms = graph_ms(kernel, reps=200)
        device_ms = profiled_ms(kernel, 200, "deficit_timeline_kernel",
                                PROFILE_OUT)
        plain_ms = cuda_ms(lambda: carbon_cost.deficit_timeline(
            starts, ends, works, g, mode="plain"), reps=20)
        # yardstick, not used by the port: a difference array and a scan
        # in stock torch calls (valid here, where windows are integers)
        s_i = starts.long().clamp(0, T)
        e_i = ends.long().clamp(0, T)

        def diff_scan():
            d = torch.zeros(T + 1, dtype=torch.float32, device=dev)
            d.index_add_(0, s_i, works)
            d.index_add_(0, e_i, -works)
            return torch.clamp(torch.cumsum(d[:-1], 0) - g, min=0.0)

        check(torch.equal(diff_scan(), carbon_cost.deficit_timeline(
            starts, ends, works, g)), f"yardstick != kernel ({label})")
        diff_ms = cuda_ms(diff_scan, reps=50)
        bound, by = deficit_bound_ms(N, T)
        ms, ms_from = ((device_ms, "profiler") if device_ms is not None
                       else (replay_ms, "graph"))
        rows.append({"shape": f"N={N} T={T}", "max_abs_err": err,
                     "ms": ms, "ms_from": ms_from, "profiler_ms": device_ms,
                     "graph_ms": replay_ms, "event_ms": event_ms,
                     "plain_ms": plain_ms, "diff_scan_ms": diff_ms,
                     "bound_ms": bound, "bound_by": by})
        log(f"[kernels] carbon_cost N={N} T={T} ({label}): kernel "
            f"{ms:.4f} ms ({ms_from}; profiler {device_ms}, graph replay "
            f"{replay_ms:.4f}, eager events {event_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, difference-array yardstick {diff_ms:.4f} "
            f"ms, bound {bound:.6f} ms ({by}), {100 * bound / ms:.2f}% of "
            f"bound")
    return rows


def work_capacity(inst):
    """The workload's mean ASAP draw: the green capacity the reference
    benchmark matrix calibrates its profiles to."""
    from repro_torch.core import deadline_from_asap
    from repro_torch.core.carbon import work_timeline
    from repro_torch.core.estlst import asap_schedule

    return int(work_timeline(inst, deadline_from_asap(inst, 1.0),
                             asap_schedule(inst)).mean())


def build_matrix():
    """The paper's section 6.1 matrix at 2000 workflow tasks."""
    from repro_torch.cluster import make_cluster
    from repro_torch.core import (build_instance, deadline_from_asap,
                                  generate_profile, heft_mapping)
    from repro_torch.workflows import wfgen_scale

    plat = make_cluster(NODES_PER_TYPE, seed=SEED)
    insts, grid = [], []
    for kind in KINDS:
        wf = wfgen_scale(kind, WF_TASKS, seed=SEED)
        inst = build_instance(wf, heft_mapping(wf, plat), plat)
        peak = work_capacity(inst)
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
    """Instance ``i`` re-planned on the CPU against its four profiles: the
    cell must equal the card's plan bitwise."""
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
    log(f"[cpu] {KINDS[i]} re-planned on the CPU against "
        f"{len(grid[i])} profiles in {secs:.3f} s: starts and costs equal "
        f"the card's bitwise")


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


def cost_through_kernel(inst, prof, start) -> float:
    """The schedule's carbon cost from ``ops.carbon_cost`` on the card."""
    from repro_torch.kernels import ops

    return float(ops.carbon_cost(start, inst.dur, inst.task_work,
                                 prof.unit_budget(inst.idle_total)))


def check_costs_through_kernel(res, insts, grid, tag) -> tuple[int, int]:
    """Every schedule of ``res`` costed through the kernel must equal its
    int64 cost exactly (every cost is below 2^24). Returns (schedules,
    largest cost)."""
    count, largest = 0, 0
    for i, inst in enumerate(insts):
        for p, prof in enumerate(grid[i]):
            for v, name in enumerate(res.variants):
                want = int(res.costs[i, p, v])
                check(want < 2 ** 24, f"[{tag}] cost {want} is not exact "
                      f"in f32")
                got = cost_through_kernel(inst, prof,
                                          res.results[i][p][name].start)
                check(got == want, f"[{tag}] kernel cost {got} != int64 "
                      f"cost {want} ({i}, {p}, {name})")
                count += 1
                largest = max(largest, want)
    return count, largest


def phase_cost_oracle(insts, grid, card, dev):
    """The plan's schedules costed through the deficit kernel."""
    import numpy as np
    import torch

    from repro_torch.core.carbon import work_timeline
    from repro_torch.kernels import carbon_cost

    t0 = time.perf_counter()
    carbon_cost.LAUNCHES = 0
    count, largest = check_costs_through_kernel(card, insts, grid, "cost")
    launches = carbon_cost.LAUNCHES
    secs = time.perf_counter() - t0
    check(launches == count, f"the cost oracle launched the carbon_cost "
          f"kernel {launches} times for {count} schedules")
    # each per-unit timeline against numpy's (comparison launches, read
    # after the path's count)
    for i, inst in enumerate(insts):
        for p, prof in enumerate(grid[i]):
            g = prof.unit_budget(inst.idle_total)
            for name in card.variants:
                start = card.results[i][p][name].start
                want = np.maximum(work_timeline(inst, prof.T, start) - g, 0)
                s, d, w, gt = (torch.as_tensor(a, dtype=torch.float32,
                                               device=dev)
                               for a in (start, inst.dur, inst.task_work, g))
                got = carbon_cost.deficit_timeline(s, s + d, w, gt)
                check(np.array_equal(got.cpu().numpy(),
                                     want.astype(np.float32)),
                      f"kernel timeline != numpy's ({i}, {p}, {name})")
    log(f"[cost] {count} plan schedules costed through ops.carbon_cost on "
        f"the card in {secs:.3f} s: all equal PlanResult.costs exactly "
        f"(largest {largest}); every timeline equals numpy's "
        f"max(work_timeline - unit_budget, 0) bitwise; carbon_cost "
        f"launches {launches}")
    return launches


def exact_grid():
    """Small instances of the kind tests/test_solvers.py solves exactly:
    three layered random DAGs spread over the 6-processor cluster with 1-5
    unit durations (ILP), and the four nf-core families at one sample,
    which HEFT maps onto one processor (DP); two tight profiles each."""
    import numpy as np

    from repro_torch.cluster import make_cluster
    from repro_torch.core import (build_instance, deadline_from_asap,
                                  heft_mapping, trivial_mapping)
    from repro_torch.core.carbon import PowerProfile
    from repro_torch.workflows import layered_random, make_workflow

    plat = make_cluster(1, seed=0)

    def tight(inst, T, seed, J=4):
        rng = np.random.default_rng(seed)
        bounds = np.unique(np.round(np.linspace(0, T, J + 1))
                           .astype(np.int64))
        budget = plat.idle_total + rng.integers(
            0, max(int(inst.task_work.max()) // 2, 2), size=len(bounds) - 1)
        return PowerProfile(bounds=bounds, budget=budget)

    insts = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        wf = layered_random(6, 3, seed=seed)
        insts.append(build_instance(wf, trivial_mapping(wf, plat), plat,
                                    dur=rng.integers(1, 6, size=wf.n)))
    for kind in KINDS:
        wf = make_workflow(kind, 1, seed=1)
        insts.append(build_instance(wf, heft_mapping(wf, plat), plat))
    grid = [[tight(inst, deadline_from_asap(inst, 1.5), seed)
             for seed in (0, 1)] for inst in insts]
    wf = layered_random(5, 3, seed=20)
    chain = build_instance(wf, trivial_mapping(wf, plat, by="single"), plat)
    chain_prof = tight(chain, deadline_from_asap(chain, 1.4), 20)
    return plat, insts, grid, chain, chain_prof


def phase_exact():
    """The exact solver axis on the card machine."""
    import numpy as np

    from repro_torch.api import Planner, PlanRequest
    from repro_torch.core.dp_uniproc import is_uniprocessor
    from repro_torch.kernels import carbon_cost, gain_scan

    plat, insts, grid, chain, chain_prof = exact_grid()
    planner = Planner(plat, engine="torch")
    opts = {"time_limit": 60}
    gain_scan.LAUNCHES = carbon_cost.LAUNCHES = 0
    t0 = time.perf_counter()
    ex = planner.plan(PlanRequest(instances=insts, profiles=grid,
                                  solver="exact", solver_options=opts))
    t_exact = time.perf_counter() - t0
    heur, t_heur = timed_plan(planner, PlanRequest(instances=insts,
                                                   profiles=grid))
    dp = planner.plan(PlanRequest(instances=chain, profiles=chain_prof,
                                  solver="dp", solver_options={"check":
                                                               True}))
    ilp = planner.plan(PlanRequest(instances=chain, profiles=chain_prof,
                                   solver="ilp", solver_options=opts))
    lower = ex.lower_bound
    check(lower is not None and (lower <= ex.costs[:, :, 0]).all(),
          "exact lower bounds missing or above the exact costs")
    check((heur.costs >= lower[:, :, None]).all(),
          "a heuristic cost is below the exact lower bound")
    asap = heur.variants.index("asap")
    check((heur.costs[:, :, asap] >= ex.costs[:, :, 0]).all(),
          "asap beats the exact solver")
    gaps = heur.gap(ex)
    check(bool((gaps >= 1.0 - 1e-12).all()), f"gap() < 1: {gaps}")
    check(int(dp.costs[0, 0, 0]) == int(ilp.costs[0, 0, 0])
          == int(ilp.lower_bound[0, 0]), f"DP {dp.costs.ravel()} != ILP "
          f"{ilp.costs.ravel()} (lower {ilp.lower_bound.ravel()}) on the "
          f"chain")
    n_costed = 0
    for res, ins, g in ((ex, insts, grid), (dp, [chain], [[chain_prof]]),
                        (ilp, [chain], [[chain_prof]])):
        n_costed += check_costs_through_kernel(res, ins, g, "exact")[0]
    launches = {"gain_scan": gain_scan.LAUNCHES,
                "carbon_cost": carbon_cost.LAUNCHES}
    check(launches["gain_scan"] > 0, "the exact phase's heuristic plan did "
          "not launch the gain_scan kernel")
    check(launches["carbon_cost"] == n_costed, f"carbon_cost launches "
          f"{launches['carbon_cost']} != {n_costed} exact schedules")
    proven = int((lower == ex.costs[:, :, 0]).sum())
    n_dp = sum(is_uniprocessor(inst) for inst in insts)
    log(f"[exact] {len(insts)} instances x 2 profiles ({n_dp} on one "
        f"processor -> DP, {len(insts) - n_dp} -> ILP): exact {t_exact:.3f} "
        f"s, {proven} of {lower.size} cells proven optimal; card heuristic "
        f"plan {t_heur:.3f} s; every heuristic cost >= its lower bound, "
        f"gap() in [{gaps.min():.6f}, {gaps.max():.6f}]; chain DP == ILP "
        f"== {int(dp.costs[0, 0, 0])}; {n_costed} exact schedules cost the "
        f"same through the kernel; launches {launches}")
    return launches


def phase_session(plat, inst):
    """A three-window rolling-horizon session on the card against eager
    plans of the same windows."""
    import numpy as np

    from repro_torch.api import Planner, PlanRequest, window_profile
    from repro_torch.core import deadline_from_asap, generate_profile
    from repro_torch.kernels import carbon_cost, gain_scan

    W = deadline_from_asap(inst, FACTOR)
    cap = work_capacity(inst)
    forecasts = [generate_profile(s, 3 * W, plat, J=3 * J,
                                  seed=PROFILE_SEED, work_capacity=cap)
                 for s in SCENARIOS]
    windows = [[window_profile(f, k * W, W) for f in forecasts]
               for k in range(3)]
    for k, ws in enumerate(windows):
        for f, w in zip(forecasts, ws):
            check(np.array_equal(
                w.unit_budget(plat.idle_total),
                f.unit_budget(plat.idle_total)[k * W:(k + 1) * W]),
                f"window_profile slice {k} != the forecast's unit budget")
    planner = Planner(plat, engine="torch")
    gain_scan.LAUNCHES = carbon_cost.LAUNCHES = 0
    results, n_costed = [], 0
    t0 = time.perf_counter()
    with planner.session(inst, windows, n_windows=3) as sess:
        for k in range(3):
            fut = sess._plans.get(k)
            prefetched = fut is not None and fut.done()
            t_wait = time.perf_counter()
            res = sess.plan_for(k)
            t_wait = time.perf_counter() - t_wait
            # "execute" window k: cost its schedules through the deficit
            # kernel on this thread while the worker plans window k + 1
            n_costed += check_costs_through_kernel(
                res, [inst], [windows[k]], "session")[0]
            results.append(res)
            log(f"[session] window {k}: plan {res.seconds:.3f} s on the "
                f"worker, prefetched={prefetched}, caller waited "
                f"{t_wait:.3f} s; robust {res.robust(0)}")
    secs = time.perf_counter() - t0
    launches = {"gain_scan": gain_scan.LAUNCHES,
                "carbon_cost": carbon_cost.LAUNCHES}
    check(launches["carbon_cost"] == n_costed, f"carbon_cost launches "
          f"{launches['carbon_cost']} != {n_costed} session schedules")

    # eager plans of the same windows on this thread, after the session
    # has closed and its count has been read: their launches are counted
    # on their own, and the session's must equal them
    eager = Planner(plat, engine="torch")
    gain_scan.LAUNCHES = 0
    eager_s = []
    for k, res in enumerate(results):
        ref, t_eager = timed_plan(eager, PlanRequest(
            instances=inst, profiles=windows[k], robust=True))
        eager_s.append(t_eager)
        check(np.array_equal(res.costs, ref.costs),
              f"session window {k} costs != eager plan")
        for p in range(len(SCENARIOS)):
            for name in res.variants:
                check(np.array_equal(res.results[0][p][name].start,
                                     ref.results[0][p][name].start),
                      f"session window {k} starts != eager: {name}, {p}")
    eager_launches = gain_scan.LAUNCHES
    check(eager_launches > 0, "the eager plans did not launch the "
          "gain_scan kernel")
    check(launches["gain_scan"] == eager_launches, f"the session launched "
          f"the gain_scan kernel {launches['gain_scan']} times, eager plans "
          f"of the same windows {eager_launches} times")
    log(f"[session] eager N_c={inst.num_tasks}, 3 windows of {W} units x "
        f"{len(SCENARIOS)} forecasts: session {secs:.3f} s in all; eager "
        f"plans {', '.join(f'{t:.3f}' for t in eager_s)} s, bitwise equal; "
        f"{n_costed} schedules cost the same through the kernel; launches "
        f"{launches} (gain_scan == the eager plans')")
    return launches


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

    build_kernels()
    gain_rows = phase_kernels(dev)
    deficit_rows = phase_deficit(dev)

    t0 = time.perf_counter()
    plat, insts, grid = build_matrix()
    log(f"[matrix] built in {time.perf_counter() - t0:.3f} s")
    card, launches, _, _ = phase_plan(plat, insts, grid)
    cost_launches = phase_cost_oracle(insts, grid, card, dev)
    eager = KINDS.index("eager")           # the smallest instance
    phase_cpu(plat, insts, grid, card, eager)
    phase_blocked(plat, insts, grid, card, eager)
    exact_launches = phase_exact()
    session_launches = phase_session(plat, insts[eager])

    main_mu = gain_rows[0]
    plan_row, large_row = deficit_rows
    kernels = {"kernels": [{
        "name": "gain_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gain_scan.cu",
        "replaces": "src/repro/kernels/gain_scan.py:60",
        "launches": launches,
        "launches_by_path": {"plan": launches,
                             "exact": exact_launches["gain_scan"],
                             "session": session_launches["gain_scan"]},
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
    }, {
        "name": "carbon_cost",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/carbon_cost.cu",
        "replaces": "src/repro/kernels/carbon_cost.py:31",
        "launches": cost_launches + exact_launches["carbon_cost"]
        + session_launches["carbon_cost"],
        "launches_by_path": {"cost": cost_launches,
                             "exact": exact_launches["carbon_cost"],
                             "session": session_launches["carbon_cost"]},
        "max_abs_err": plan_row["max_abs_err"],
        "ms": plan_row["ms"],
        "ms_from": plan_row["ms_from"],
        "event_ms": plan_row["event_ms"],
        "graph_ms": plan_row["graph_ms"],
        "plain_ms": plan_row["plain_ms"],
        "bound_ms": plan_row["bound_ms"],
        "bound_by": plan_row["bound_by"],
        "library_ms": None,
        "diff_scan_ms": plan_row["diff_scan_ms"],
        "bitwise_vs_plain": True,
        "shape": plan_row["shape"],
        "large": large_row,
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
