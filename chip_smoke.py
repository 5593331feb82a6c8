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
   shapes the main paths give it: the gain sweep bitwise (the climb's
   shape, edge cases, and every mu compiled into the kernel plus one it
   takes at run time, at a ragged Np and at rows at and over its staging
   budget); the deficit timeline bitwise on integer inputs (the
   reference's sweep shapes, the plan's shape, a 30,000-task shape, a T of
   several tiles, edge and out-of-range windows), NaN where the plain
   version is NaN on non-finite works, and within a stated reorder bound
   on fractional works; each with the kernel's device time
   (``torch.profiler``, else a CUDA-graph replay), the eager CUDA-event time
   and the plain version's time; the profiler's tables are written to the
   file ``PROFILE_OUT`` names. Every profiler time comes from one trace
   taken after a warm-up step that holds every launch (:func:`warm_trace`);
4. the heuristic plan: ``Planner(platform, engine="torch").plan(...)`` on
   the paper's section 6.1 matrix (72-processor small cluster, the four
   nf-core families at 2000 workflow tasks, HEFT-mapped, deadline 2x ASAP,
   the S1-S4 ensemble, all 17 variants), cold and warm; every schedule is
   validated, every -LS cost is <= its greedy cost, and the non-LS columns
   equal the port's numpy engine bitwise; the cold plan's span split from
   the port's tracer and ``obs.torch_hooks.snapshot()``;
5. the cost oracle: every schedule of that plan costed through
   ``ops.carbon_cost`` on the card equals its int64 cost, and its deficit
   timeline equals numpy's bitwise; the oracle's wall time per schedule;
6. one instance re-planned on the CPU against its first ``CPU_PROFILES``
   profiles (each profile's rows are planned independently): starts and
   costs equal the card's;
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
   schedule costs the same through the kernel;
10. the joint mapping search (``PlanRequest(mapping="search")``,
   ``[mapping]``): (a) tests/test_mapping.py's small search on the card
   equals it on the CPU bitwise; (b) a raw ``wfgen_scale("eager",
   MAPPING_TASKS)`` workflow on the 72-processor cluster against the S1-S4
   ensemble, all 17 variants, ``deadline_scale=2``, default
   ``MappingOptions``: every schedule valid, every -LS cost <= its greedy,
   the winner re-planned with ``mapping="fixed"`` equal bitwise, a
   ``mapping="heft"`` plan's score equal to the search's HEFT seed and not
   below the winner's, every winner schedule costs the same through the
   deficit kernel; the span split, and the device's idle share over the
   profiled seed round;
11. the planning service (``PlanService``, ``[service]``): (a) the four
   matrix tickets admitted to a service with a write-ahead journal, which
   is killed before it serves them; a second service on the journal
   replays them as one coalesced batch (two workers), each ticket bitwise
   equal to the cold plan's row, none degraded, the journal empty after
   ``close()``, every delivered schedule costed through the deficit
   kernel; (b) the seconds from ``Ticket.cancel()`` until the solve pool is
   idle, for a cancel when the first device climb opens and one during the
   greedy bucket; (c) scripted fault drills at tests/test_service.py's
   sizes (a transient crash, an injected OOM's blocked-LP retry, a hang
   the watchdog trips, a zero budget on a mapping search, two coalesce
   groups on two workers), each through a service on the card and one on
   the CPU, their attempts logs and plans equal; (d) ``CarbonGate`` plans,
   nominal and with an ensemble, card == CPU bitwise;
12. the flash-attention kernels (bf16: ``wgmma`` on the tensor cores; f32:
   the CUDA cores) against their plain version on the card at the
   reference sweep's five shapes and the bf16 twins of its four f32 shapes,
   at the model's shape (B=4, S=2048, H=16, hd=64, causal) in bf16 and f32,
   and on strided views; at the model's shape, and in bf16 at hd=128 (B=4,
   S=2048, H=8), the kernel's, the plain version's and PyTorch's
   ``scaled_dot_product_attention``'s times (in the section ``[flash]``);
13. the full-width Qwen1.5-0.5B (24 layers, d_model 1024, vocab 151,936,
   bf16 activations, f32 master parameters from a seed) on the card: the
   loss of a B=4, S=2048 synthetic batch through the kernel, 24 launches
   per forward, finite and within 0.5 of ln V; the final hidden states
   against plain-attention forwards of the same parameters (f32:
   elementwise within 1e-4; bf16: within 2e-2 in relative norm, and no
   further from the f32 forward than the plain bf16 forward is); forward
   seconds cold and warm (``[model]``);
14. the serving path: ``repro_torch.launch.serve.serve`` at full width, 16
   requests on 4 slots, 32 new tokens, max_len 512, every request finished;
   then the forward's logits against step-by-step decode logits at full
   width in f32, B=2, S=8, within 2e-2 (``[serve]``).

Each path (4, 5, 8, 9, 10, 11, 13, 14) is driven with the kernels' launch
counts set to 0 just before it and read just after; a kernel the path runs
that was never launched fails the run. f32 matrix products on the card run
in full f32: TF32 is switched off for matmuls and cuDNN before any phase.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before either is printed.
"""
from __future__ import annotations

import contextlib
import functools
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
MAPPING_TASKS = 650      # workflow tasks of the [mapping] cell (depth cut)
CPU_PROFILES = 2         # profiles of the [cpu] re-plan (a cut of the four)
PROFILE_OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.txt")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM published memory rate
F32_OPS_PER_S = 67e12        # H100 SXM published f32 rate (no tensor cores)
BF16_OPS_PER_S = 989e12      # H100 SXM published dense bf16 tensor-core rate

ARCH = "qwen1.5-0.5b"        # the serve CLI's default arch, at full width
MODEL_B, MODEL_S = 4, 2048   # the forward's batch: f32 logits take 5 GB
FLASH_SWEEP = [              # tests/test_kernels.py's flash sweep
    (2, 128, 2, 64, True, "float32"),
    (1, 256, 4, 128, True, "float32"),
    (2, 200, 2, 64, False, "float32"),
    (1, 384, 1, 128, True, "bfloat16"),
    (1, 130, 3, 64, True, "float32"),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the sweep's tolerances
FLASH_BF16_TWINS = [c[:5] + ("bfloat16",) for c in FLASH_SWEEP
                    if c[5] == "float32"]
# timed shapes (B, S, H, hd, dtype): the model's in bf16 and f32, and bf16
# at hd=128
FLASH_TIMED = {"bfloat16": (MODEL_B, MODEL_S, 16, 64, "bfloat16"),
               "float32": (MODEL_B, MODEL_S, 16, 64, "float32"),
               "bfloat16_hd128": (MODEL_B, MODEL_S, 8, 128, "bfloat16")}
# kernel vs plain forward of the whole model. In f32 the two attentions
# differ only in the order of their f32 sums, which 24 layers keep near 1e-5:
# elementwise allclose at F32_MODEL_TOL. In bf16 an attention output rounds
# to another bf16 value now and then and the difference spreads through the
# bf16 residual stream like any other bf16 rounding, so elementwise bounds
# do not hold (a bf16 forward is ~2e-2 from the f32 one in relative norm
# and up to ~0.14 in one element of ~5): the kernel's bf16 forward must stay
# within the sweep's bf16 tolerance of the plain one in relative Frobenius
# norm, and be no further from the f32 forward than the plain bf16 forward
# is, within BF16_MODEL_SLACK
F32_MODEL_TOL = 1e-4
BF16_MODEL_TOL = 2e-2
BF16_MODEL_SLACK = 1.1
DECODE_TOL = 2e-2            # tests/test_model_equivalence.py's tolerance


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


def warm_trace(run):
    """``torch.profiler`` over one call of ``run()``, taken the way every
    time in this script is: one warm-up step of ``run()`` while the
    profiler starts, then the recorded step. A trace started cold loses
    launches, more the longer the process has run since its first trace
    (``chip_profiler_probe.py --drift``); one started a step earlier keeps
    them all. Returns the profiler and the host wall seconds
    of the recorded ``run()``, ending in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    return prof, wall


def profiled_ms(fn, reps: int, kernel: str, out_path: str):
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, from one :func:`warm_trace` of ``reps`` warm calls of
    ``fn``; None when the profiler records no device time for it. The time
    comes only from a trace that holds all ``reps`` launches: one that
    holds fewer fails the run. The profiler's table goes to
    ``out_path``."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof, _ = warm_trace(lambda: [fn() for _ in range(reps)])
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
    log(f"[profiler] {kernel}: the trace holds {count} of {reps} launches")
    if count == 0 or total_us <= 0.0:
        return None
    check(count == reps, f"the profiler's trace holds {count} launches of "
          f"{kernel}, expected {reps}")
    return total_us / count / 1e3


def device_breakdown(fn, reps: int, out_path: str) -> dict:
    """Where ``reps`` warm calls of ``fn`` spend the card's time, from one
    :func:`warm_trace`: host wall ms per call (ending in a synchronize),
    device busy ms per call (the sum of the kernels' device times; one
    stream, so they do not overlap), the idle share, and the kernels'
    device ms per call grouped as flash, matrix products and the rest.
    Busy is None when the profiler records no device time. The profiler's
    table goes to ``out_path``."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof, wall = warm_trace(lambda: [fn() for _ in range(reps)])
    avgs = prof.key_averages()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "a") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=25)
                + "\n")
    groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for ev in avgs:
        # the schedule's step range shows up on the device too, as a GPU
        # user annotation spanning the step: a range, not a kernel
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or ev.key.startswith("ProfilerStep"):
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0)
                   or getattr(ev, "self_cuda_time_total", 0.0))
        name = ev.key.lower()
        if "flash_fwd_kernel" in name:
            groups["flash"] += us
        elif any(k in name for k in ("gemm", "xmma", "cutlass", "gemv",
                                     "nvjet")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    busy_us = sum(groups.values())
    wall_ms = 1e3 * wall / reps
    if busy_us <= 0.0:
        return {"wall_ms": wall_ms, "busy_ms": None, "idle_share": None}
    busy_ms = busy_us / 1e3 / reps
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            **{f"{k}_ms": v / 1e3 / reps for k, v in groups.items()}}


def breakdown_text(b: dict) -> str:
    if b["busy_ms"] is None:
        return (f"{b['wall_ms']:.3f} ms wall; device time not measured (the "
                f"profiler recorded none)")
    return (f"{b['wall_ms']:.3f} ms wall, device busy {b['busy_ms']:.3f} ms "
            f"(flash {b['flash_ms']:.3f}, matmul {b['matmul_ms']:.3f}, other "
            f"{b['other_ms']:.3f}), idle share {b['idle_share']:.3f}")


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

    names = ("gain_scan", "carbon_cost", "flash_attention")

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
    # every mu compiled into the kernel and one it takes at run time, at an
    # Np that is no multiple of the CTA's chunk and at rows at and over the
    # staging budget
    shapes = ((8, Np + 37, Tp - 1), (4, 1000, gain_scan.KERNEL_STAGE_MAX),
              (4, 1000, gain_scan.KERNEL_STAGE_MAX + 809))
    mus = (*gain_scan.KERNEL_MUS, 17)
    for R2, N2, T2 in shapes:
        for mu in mus:
            args = gain_inputs(R2, N2, T2, mu, seed=N2 + T2 + mu, dev=dev)
            check(torch.equal(gain_scan.gain_sweep(*args, mu=mu),
                              gain_scan.gain_sweep(*args, mu=mu,
                                                   mode="plain")),
                  f"gain_scan kernel != plain at R={R2} Np={N2} Tp={T2} "
                  f"mu={mu}")
    log(f"[kernels] gain_scan at (R, Np, Tp) in {shapes} x mu in {mus}: "
        f"bitwise equal")
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


def deficit_bounds(t=300, seed=12):
    """Windows the kernel's index rule must clamp or drop: starts at -inf
    and exactly at T, ends at +inf, at 1e30 and before their starts, NaN
    starts and ends (tests/test_torch_cost.py's _bounds_edges)."""
    import numpy as np

    starts, ends, works, g = deficit_inputs(40, t, seed)
    starts[0], starts[1], starts[2] = -np.inf, float(t), np.nan
    ends[3], ends[4], ends[5] = np.inf, 1e30, np.nan
    starts[6], ends[6] = 50.0, 20.0
    starts[7], ends[7] = -np.inf, np.inf
    starts[8], ends[8] = -1e30, 3.5
    return starts, ends, works, g


def deficit_nonfinite(kind, t=300, seed=13):
    """One infinite or NaN work among finite ones (tests/test_torch_cost.py's
    _nonfinite_works): the dense form is NaN where an infinite work is
    inactive (inf * 0) and +-inf where it is active."""
    import numpy as np

    starts, ends, works, g = deficit_inputs(30, t, seed)
    starts[0], ends[0], works[0] = 40.0, 90.0, np.inf
    if kind == "inf_both_signs":
        starts[1], ends[1], works[1] = 70.0, 120.0, -np.inf
    elif kind == "inf_inactive":
        starts[0] = np.nan
    elif kind == "nan_work":
        works[0] = np.nan
    return starts, ends, works, g


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
              ("multi-tile", deficit_inputs(
                  700, 2 * carbon_cost.KERNEL_TILE + 300, seed=4)),
              ("edges", deficit_edges()), ("bounds", deficit_bounds())]
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
    kinds = ("inf_partial", "inf_both_signs", "inf_inactive", "nan_work")
    for kind in kinds:
        x = on_card(deficit_nonfinite(kind))
        got = carbon_cost.deficit_timeline(*x)
        want = carbon_cost.deficit_timeline(*x, mode="plain")
        check(torch.equal(got.isnan(), want.isnan())
              and torch.equal(got.nan_to_num(), want.nan_to_num()),
              f"carbon_cost kernel != plain ({kind})")
    log(f"[kernels] carbon_cost: equal to plain on non-finite works "
        f"({', '.join(kinds)}; NaN where plain is NaN)")
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


def timed(fn):
    """``fn()`` and its host wall seconds, between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_plan(planner, request):
    return timed(lambda: planner.plan(request))


def phase_plan(plat, insts, grid):
    import numpy as np

    from repro_torch import obs
    from repro_torch.api import Planner, PlanRequest
    from repro_torch.core import validate_schedule
    from repro_torch.core.portfolio import PORTFOLIO_VARIANTS
    from repro_torch.kernels import gain_scan
    from repro_torch.obs import torch_hooks

    planner = Planner(plat, engine="torch")
    request = PlanRequest(instances=insts, profiles=grid)
    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    gain_scan.LAUNCHES = 0
    try:
        cold, cold_s = timed_plan(planner, request)
    finally:
        obs.set_tracer(prev)
    launches = gain_scan.LAUNCHES
    check(launches > 0, "the plan did not launch the gain_scan kernel")
    split = span_split(tracer.finished(), (
        "plan", "prepare_graph", "bucket_launch", "ls_climb",
        "ls_device_climb", "ls_polish"))
    warm, warm_s = timed_plan(planner, request)
    I, P, V = cold.costs.shape
    check((I, P, V) == (len(insts), len(SCENARIOS), 17),
          f"cost tensor shape {cold.costs.shape}")
    check(np.array_equal(cold.costs, warm.costs), "warm plan != cold plan")
    log(f"[plan] I x P x V = {I} x {P} x {V}, engine={cold.engine}; cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s; gain_scan launches "
        f"{launches} (cold plan)")
    for tag, res in (("cold", cold), ("warm", warm)):
        phases = ", ".join(f"{k} {v:.3f}" for k, v in
                           res.phase_seconds.items())
        log(f"[plan] {tag} split (s): {phases}")
    log(f"[plan] cold span split: {split_text(split)}")
    log(f"[plan] torch_hooks.snapshot(): "
        f"{json.dumps(torch_hooks.snapshot(obs.registry()))}")

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
    """Instance ``i`` re-planned on the CPU against its first
    ``CPU_PROFILES`` profiles: each must equal the card's plan bitwise."""
    import numpy as np

    from repro_torch.api import Planner, PlanRequest

    profiles = grid[i][:CPU_PROFILES]
    t0 = time.perf_counter()
    res = Planner(plat, engine="torch", device="cpu").plan(
        PlanRequest(instances=insts[i], profiles=profiles))
    secs = time.perf_counter() - t0
    check(np.array_equal(res.costs[0], card.costs[i][:len(profiles)]),
          "CPU costs differ from the card's")
    for p in range(len(profiles)):
        for n in res.variants:
            check(np.array_equal(res.results[0][p][n].start,
                                 card.results[i][p][n].start),
                  f"CPU starts differ from the card's: {n}, profile {p}")
    log(f"[cpu] {KINDS[i]} re-planned on the CPU against "
        f"{len(profiles)} of its {len(grid[i])} profiles in {secs:.3f} s: "
        f"starts and costs equal the card's bitwise")


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


def check_costs_through_kernel(res, insts, grid,
                               tag) -> tuple[int, int, float]:
    """Every schedule of ``res`` costed through the kernel must equal its
    int64 cost exactly (every cost is below 2^24). Returns (schedules,
    largest cost, host seconds inside ``ops.carbon_cost`` calls, each
    ending in the copy of its cost to the host)."""
    from repro_torch.kernels import ops

    count, largest, oracle_s = 0, 0, 0.0
    for i, inst in enumerate(insts):
        for p, prof in enumerate(grid[i]):
            g = prof.unit_budget(inst.idle_total)
            for v, name in enumerate(res.variants):
                want = int(res.costs[i, p, v])
                check(want < 2 ** 24, f"[{tag}] cost {want} is not exact "
                      f"in f32")
                start = res.results[i][p][name].start
                t0 = time.perf_counter()
                got = float(ops.carbon_cost(start, inst.dur, inst.task_work,
                                            g))
                oracle_s += time.perf_counter() - t0
                check(got == want, f"[{tag}] kernel cost {got} != int64 "
                      f"cost {want} ({i}, {p}, {name})")
                count += 1
                largest = max(largest, want)
    return count, largest, oracle_s


def phase_cost_oracle(insts, grid, card, dev):
    """The plan's schedules costed through the deficit kernel."""
    import numpy as np
    import torch

    from repro_torch.core.carbon import work_timeline
    from repro_torch.kernels import carbon_cost

    t0 = time.perf_counter()
    carbon_cost.LAUNCHES = 0
    count, largest, oracle_s = check_costs_through_kernel(card, insts, grid,
                                                          "cost")
    launches = carbon_cost.LAUNCHES
    secs = time.perf_counter() - t0
    oracle_ms = 1e3 * oracle_s / count
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
        f"the card in {secs:.3f} s with their checks ({oracle_ms:.4f} ms "
        f"per schedule in ops.carbon_cost alone, from host arrays to the "
        f"cost on the host): all equal PlanResult.costs exactly "
        f"(largest {largest}); every timeline equals numpy's "
        f"max(work_timeline - unit_budget, 0) bitwise; carbon_cost "
        f"launches {launches}")
    return launches, oracle_ms


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


def span_split(spans, names) -> dict:
    """``{name: (count, seconds)}`` of the finished ``spans`` called
    ``names`` (seconds summed over the spans, nested ones counted inside
    their parents)."""
    out = {n: [0, 0.0] for n in names}
    for s in spans:
        if s.name in out:
            out[s.name][0] += 1
            out[s.name][1] += s.duration
    return {n: tuple(v) for n, v in out.items()}


def split_text(split: dict) -> str:
    return ", ".join(f"{n} {c} x {s:.3f} s" for n, (c, s) in split.items())


def round_profiler(round_no=0):
    """A tracer (``obs.Tracer`` subclass) that also profiles the card over
    one mapping round, as :func:`warm_trace` does: the profiler warms up
    from the search's start and records from the round's span start to its
    end (each edge after a synchronize). ``busy()`` then gives the
    kernels' device time and their launches by name, ``round_span`` the
    round's span and ``launches`` the gain-kernel launches inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import obs
    from repro_torch.kernels import gain_scan

    class RoundProfiler(obs.Tracer):
        prof = round_span = None
        launches = 0

        def start(self, name, parent=None, **attrs):
            if name == "mapping_search" and self.prof is None:
                self.prof = profile(activities=[ProfilerActivity.CUDA],
                                    schedule=schedule(wait=0, warmup=1,
                                                      active=1, repeat=1))
                self.prof.start()
            ours = name == "mapping_round" and attrs.get("round") == round_no
            if ours:
                torch.cuda.synchronize()
                self.prof.step()                  # warm-up -> recording
            sp = super().start(name, parent=parent, **attrs)
            if ours:
                self.round_span, self.launches = sp, gain_scan.LAUNCHES
            return sp

        def _finish(self, span):
            super()._finish(span)
            if span is self.round_span:
                torch.cuda.synchronize()
                self.launches = gain_scan.LAUNCHES - self.launches
                self.prof.step()                  # recording -> done
            elif span.name == "mapping_search" and self.prof is not None:
                self.prof.stop()

        def busy(self):
            """(device ms of every kernel, {kernel name: launches})."""
            us, counts = 0.0, {}
            for ev in self.prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us += float(getattr(ev, "self_device_time_total", 0.0)
                            or getattr(ev, "self_cuda_time_total", 0.0))
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
            return us / 1e3, counts

    return RoundProfiler()


def scarce_profile(plat, T):
    """tests/test_mapping.py's scarce forecast."""
    from repro_torch.core import generate_profile

    return generate_profile("S3", T, plat, J=12, seed=2, work_capacity=40)


def mapping_cell(plat, n):
    """The full-width mapping cell: a raw ``wfgen_scale("eager", n)``
    workflow against the S1-S4 ensemble (J=48, seed=17). The forecasts
    run to 2.5x the reference HEFT mapping's ASAP makespan, so the
    request's ``deadline_scale=FACTOR`` crops them; returns (workflow,
    forecasts, the cropped forecasts, the cropped horizon)."""
    from repro_torch.api import crop_profile
    from repro_torch.core import (build_instance, deadline_from_asap,
                                  generate_profile, heft_mapping)
    from repro_torch.workflows import wfgen_scale

    wf = wfgen_scale("eager", n, seed=SEED)
    ref = build_instance(wf, heft_mapping(wf, plat), plat)
    cap = work_capacity(ref)
    long_T = deadline_from_asap(ref, 2.5)
    forecasts = [generate_profile(s, long_T, plat, J=J, seed=PROFILE_SEED,
                                  work_capacity=cap) for s in SCENARIOS]
    T = deadline_from_asap(ref, FACTOR)
    return wf, forecasts, [crop_profile(f, T) for f in forecasts], T


def phase_mapping(plat, n=MAPPING_TASKS):
    """The joint mapping search on the card: (a) card == CPU bitwise on
    tests/test_mapping.py's sizes; (b) at full cluster width against the
    S1-S4 ensemble with the default MappingOptions."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.api import Planner, PlanRequest
    from repro_torch.cluster import make_cluster
    from repro_torch.core import build_instance, validate_schedule
    from repro_torch.core.portfolio import heuristic_indices
    from repro_torch.kernels import carbon_cost, gain_scan
    from repro_torch.mapping import MappingOptions
    from repro_torch.workflows import make_workflow

    t_phase = time.perf_counter()
    # (a) card == CPU, bitwise
    small = make_cluster(1, seed=0)
    req = PlanRequest(instances=make_workflow("eager", 2, seed=0),
                      profiles=[scarce_profile(small, 300)] * 2,
                      mapping="search",
                      mapping_options={"seeds": 4, "rounds": 2,
                                       "neighbors": 6})
    card = Planner(small, engine="torch").plan(req)
    cpu = Planner(small, engine="torch", device="cpu").plan(req)
    ci, pi = card.mapping_info[0], cpu.mapping_info[0]
    cd, pd = ci.to_dict(), pi.to_dict()
    for key in cd.keys() - {"seconds", "cache_misses"}:
        check(cd[key] == pd[key], f"[mapping] card {key} {cd[key]} != CPU "
              f"{pd[key]}")
    check(np.array_equal(card.mappings[0].proc, cpu.mappings[0].proc),
          "[mapping] the card's winner proc != the CPU's")
    check(np.array_equal(card.costs, cpu.costs),
          "[mapping] the card's cost tensor != the CPU's")
    log(f"[mapping] (a) eager x 2 samples on 6 processors, seeds 4, rounds "
        f"2, neighbors 6: card == CPU bitwise (winner {ci.label}, "
        f"{ci.candidates} candidates, {ci.infeasible} infeasible, trace "
        f"{list(ci.trace)}); card {card.seconds:.3f} s, CPU "
        f"{cpu.seconds:.3f} s")

    # (b) full cluster width, default options
    wf, forecasts, cropped, T = mapping_cell(plat, n)
    opts = MappingOptions()
    planner = Planner(plat, engine="torch")
    request = PlanRequest(instances=wf, profiles=forecasts, mapping="search",
                          deadline_scale=FACTOR,
                          mapping_options=opts.to_dict())
    # the seed round is profiled on the card (its idle share) while the
    # tracer times every span of the search
    tracer = round_profiler(0)
    prev = obs.set_tracer(tracer)
    gain_scan.LAUNCHES = carbon_cost.LAUNCHES = 0
    try:
        res, secs = timed_plan(planner, request)
    finally:
        obs.set_tracer(prev)
    gain_launches = gain_scan.LAUNCHES
    check(gain_launches > 0, "the mapping search did not launch the "
          "gain_scan kernel")
    info = res.mapping_info[0]
    spans = tracer.finished()
    split = span_split(spans, ("mapping_search", "mapping_round",
                                "bucket_launch", "ls_device_climb",
                                "ls_polish"))
    buckets = sorted({s.attrs["bucket"] for s in spans
                      if s.name == "bucket_launch"})
    rnd = tracer.round_span
    busy_ms, kernels = tracer.busy()
    seen = sum(c for k, c in kernels.items() if "gain_scan_kernel" in k)
    check(seen == tracer.launches, f"[mapping] the seed round's trace holds "
          f"{seen} of its {tracer.launches} gain_scan launches")
    round_ms = 1e3 * rnd.duration
    idle = max(0.0, 1.0 - busy_ms / round_ms)
    in_round = span_split([s for s in spans if rnd.t0 <= s.t0 <= rnd.t1],
                          ("bucket_launch", "ls_device_climb", "ls_polish"))
    inst_w = build_instance(wf, res.mappings[0], plat)
    n_costed = check_costs_through_kernel(res, [inst_w], [cropped],
                                          "mapping")[0]
    cost_launches = carbon_cost.LAUNCHES
    check(cost_launches == n_costed, f"carbon_cost launches {cost_launches}"
          f" != {n_costed} winner schedules")

    names = res.variants
    for p, prof in enumerate(cropped):
        check(prof.T == T, f"[mapping] profile {p} not cropped to {T}")
        cell = res.results[0][p]
        for name in names:
            validate_schedule(inst_w, prof, cell[name].start)
            if name.endswith("-LS"):
                check(cell[name].cost <= cell[name[:-3]].cost,
                      f"[mapping] {name} costs more than its greedy ({p})")
    fixed = planner.plan(PlanRequest(instances=inst_w, profiles=cropped))
    check(np.array_equal(fixed.costs, res.costs), "[mapping] the winner "
          "re-planned with mapping='fixed' gives other costs")
    for p in range(len(cropped)):
        for name in names:
            check(np.array_equal(fixed.results[0][p][name].start,
                                 res.results[0][p][name].start),
                  f"[mapping] fixed re-plan starts differ: {name}, {p}")
    heft = planner.plan(PlanRequest(instances=wf, profiles=forecasts,
                                    mapping="heft", deadline_scale=FACTOR))
    cols = heuristic_indices(names)
    heft_score = int(heft.costs[0][:, cols].min())
    seed_score = info.candidate_costs[info.candidate_labels.index(
        "seed:heft")]
    check(heft_score == seed_score, f"[mapping] heft plan score "
          f"{heft_score} != the search's heft seed {seed_score}")
    check(info.trace[-1] <= heft_score, f"[mapping] the winner's score "
          f"{info.trace[-1]} > heft's {heft_score}")
    check(int(res.costs[0][:, cols].min()) == info.trace[-1],
          "[mapping] the winner's plan does not cost its score")
    log(f"[mapping] (b) eager n={n} (N={wf.n} workflow tasks, winner N_c="
        f"{inst_w.num_tasks}) on {plat.num_compute} processors x "
        f"{len(SCENARIOS)} profiles x {len(names)} variants, T={T}, default "
        f"MappingOptions {opts.to_dict()}: {secs:.3f} s; rounds "
        f"{info.rounds}, candidates {info.candidates}, infeasible "
        f"{info.infeasible}, buckets {len(buckets)} {buckets}, bucket "
        f"misses per batch {list(info.cache_misses)}; trace "
        f"{list(info.trace)}, winner {info.label} ({info.trace[-1]}) vs "
        f"heft {heft_score}")
    log(f"[mapping] span split: {split_text(split)}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    log(f"[mapping] seed round ({rnd.attrs['candidates']} candidates, "
        f"profiled): {round_ms:.3f} ms wall, device busy {busy_ms:.3f} ms, "
        f"idle share {idle:.4f}; {sum(kernels.values())} kernels, the most "
        f"launched {top}; gain_scan launches {tracer.launches}, all in the "
        f"trace; span split {split_text(in_round)}")
    log(f"[mapping] every schedule valid, every -LS cost <= its greedy, the "
        f"fixed re-plan of the winner equal bitwise, heft's score == the "
        f"heft seed's; {n_costed} winner schedules cost the same through "
        f"the kernel; launches gain_scan {gain_launches}, carbon_cost "
        f"{cost_launches}; the phase {time.perf_counter() - t_phase:.3f} s "
        f"in all")
    return {"gain_scan": gain_launches, "carbon_cost": cost_launches,
            "seconds": secs, "rounds": info.rounds,
            "candidates": info.candidates, "buckets": len(buckets),
            "seed_round_ms": round_ms, "seed_round_busy_ms": busy_ms,
            "seed_round_idle_share": idle}


# --- [service] --------------------------------------------------------------

SERVICE_SPANS = ("rung:heuristic", "solve", "plan", "prepare_graph",
                 "bucket_launch", "ls_climb", "ls_device_climb", "ls_polish")


def service_replay(plat, insts, grid, cold, cold_s):
    """[service] (a): four matrix tickets admitted to a journaled service
    that is killed before it serves them; a second service on the same
    journal replays them as one coalesced batch, bitwise equal to the cold
    plan's rows, with nothing degraded."""
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.api import Planner, PlanRequest
    from repro_torch.serve import PlanService, TicketJournal

    with tempfile.TemporaryDirectory() as jdir:
        a = PlanService(Planner(plat, engine="torch"), journal_dir=jdir,
                        workers=2)
        try:
            a.pause()
            tickets = [a.submit(PlanRequest(instances=inst, profiles=ps))
                       for inst, ps in zip(insts, grid)]
        finally:
            a.kill()
        check(not any(t.done() for t in tickets), "[service] a killed "
              "service resolved a ticket")
        tracer = obs.Tracer()
        prev = obs.set_tracer(tracer)
        t0 = time.perf_counter()
        try:
            b = PlanService(Planner(plat, engine="torch"), journal_dir=jdir,
                            workers=2)
            try:
                check(len(b.replayed) == len(insts), f"[service] replayed "
                      f"{len(b.replayed)} of {len(insts)} tickets")
                results = [t.result(timeout=600) for t in b.replayed]
                secs = time.perf_counter() - t0
                stats = b.stats()
            finally:
                b.close()
        finally:
            obs.set_tracer(prev)
        left = len(TicketJournal(jdir))
    check(left == 0, f"[service] {left} journal entries left after close()")
    check(stats["batches"] == 1 and stats["coalesced_requests"] == 4,
          f"[service] replay ran {stats['batches']} batches of "
          f"{stats['coalesced_requests']} tickets, not one of 4")
    check(stats["failed"] == 0 and stats["degraded"] == 0,
          f"[service] failed {stats['failed']}, degraded "
          f"{stats['degraded']}")
    for i, res in enumerate(results):
        check(not res.degraded and res.fallback_stage == "heuristic"
              and res.attempts[-1] == "heuristic:ok",
              f"[service] ticket {i} degraded {res.degraded}, stage "
              f"{res.fallback_stage}, attempts {res.attempts}")
        check(res.engine == "torch", f"[service] engine {res.engine}")
        check(np.array_equal(res.costs[0], cold.costs[i]),
              f"[service] ticket {i} costs != the cold plan's row {i}")
        for p in range(len(grid[i])):
            for n in cold.variants:
                check(np.array_equal(res.results[0][p][n].start,
                                     cold.results[i][p][n].start),
                      f"[service] ticket {i} starts != the cold plan's: "
                      f"{n}, profile {p}")
    costed = 0
    for i, res in enumerate(results):
        costed += check_costs_through_kernel(res, [insts[i]], [grid[i]],
                                             "service")[0]
    lat = stats["latency"]
    log(f"[service] (a) 4 matrix tickets journaled, the service killed, "
        f"replayed by a second service (workers=2): {secs:.3f} s from its "
        f"start to the last delivery ([plan] cold {cold_s:.3f} s); batches "
        f"{stats['batches']}, coalesced requests "
        f"{stats['coalesced_requests']}, coalesce ratio "
        f"{stats['coalesce_ratio']}, replayed {stats['replayed']}, latency "
        f"p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms; every "
        f"ticket bitwise equal to the cold plan's row, none degraded, the "
        f"journal empty after close(); {costed} schedules cost the same "
        f"through the deficit kernel")
    log(f"[service] (a) span split under rung:heuristic: "
        f"{split_text(span_split(tracer.finished(), SERVICE_SPANS))}")
    return {"seconds": secs, "coalesce_ratio": stats["coalesce_ratio"],
            "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"]}


def service_cancel(plat, inst, profiles):
    """[service] (b): the seconds from ``Ticket.cancel()`` until the
    service's solve pool is idle, for a cancel issued when the first
    device climb opens and one issued during the greedy bucket."""
    import threading

    from repro_torch import obs
    from repro_torch.api import Planner, PlanRequest
    from repro_torch.core import cancel as cancel_mod
    from repro_torch.serve import PlanService, TicketCancelled

    class Trigger(obs.Tracer):
        """Sets ``fired`` when the first span named ``target`` opens."""

        target = None

        def __init__(self):
            super().__init__()
            self.fired = threading.Event()

        def start(self, name, parent=None, **attrs):
            sp = super().start(name, parent=parent, **attrs)
            if name == self.target:
                self.fired.set()
            return sp

    out = {}
    with PlanService(Planner(plat, engine="torch")) as svc:
        for target in ("ls_device_climb", "bucket_launch"):
            tracer = Trigger()
            tracer.target = target
            prev = obs.set_tracer(tracer)
            try:
                t = svc.submit(PlanRequest(instances=inst,
                                           profiles=profiles))
                check(tracer.fired.wait(timeout=300),
                      f"[service] no {target} span opened")
                t0 = time.perf_counter()
                check(t.cancel("chip_smoke"), f"[service] the cancel at "
                      f"{target} lost: the ticket had resolved")
                while svc.stats()["inflight_solves"] > 0 and \
                        time.perf_counter() - t0 < 300:
                    time.sleep(0.001)
                freed = time.perf_counter() - t0
            finally:
                obs.set_tracer(prev)
            check(svc.stats()["inflight_solves"] == 0,
                  f"[service] the solve cancelled at {target} still runs")
            try:
                t.result(timeout=10)
                check(False, "[service] a cancelled ticket delivered")
            except TicketCancelled:
                pass
            observed = cancel_mod._CANCEL_LATENCY.samples()
            out[target] = (freed, observed[-1] if observed else None)
            log(f"[service] (b) cancel at the first {target} span: "
                f"{freed:.4f} s until inflight_solves == 0; "
                f"cancel_observe_latency_seconds {out[target][1]}")
        stats = svc.stats()
    check(stats["cancelled"] == 2 and stats["cancelled_solves"] == 2,
          f"[service] cancelled {stats['cancelled']}, cancelled solves "
          f"{stats['cancelled_solves']}")
    return out


def drill_setup(samples=3, seed=3):
    """tests/test_service.py's ``_setup``."""
    from repro_torch.cluster import make_cluster
    from repro_torch.core import (build_instance, deadline_from_asap,
                                  generate_profile, heft_mapping)
    from repro_torch.workflows import make_workflow

    plat = make_cluster(1, seed=seed)
    wf = make_workflow("eager", samples, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    prof = generate_profile("S3", deadline_from_asap(inst, 1.5), plat,
                            J=16, seed=seed)
    return plat, inst, prof


def run_drill(name, device):
    """One scripted fault drill through a service whose planner runs on
    ``device`` (None = the card); returns the delivered results."""
    import numpy as np

    from repro_torch.api import Planner, PlanRequest
    from repro_torch.cluster import make_cluster
    from repro_torch.core import (build_instance, generate_profile,
                                  lp_matrix_bytes, validate_schedule)
    from repro_torch.runtime.fault import FaultSpec, ServiceFaultInjector
    from repro_torch.serve import PlanService
    from repro_torch.workflows import make_workflow

    plat, inst, prof = drill_setup()
    planner = Planner(plat, engine="torch", device=device)
    req = PlanRequest(instances=inst, profiles=prof)

    def same(a, b, what):
        check(a.variants == b.variants and np.array_equal(a.costs, b.costs),
              f"[service] {name}: {what} costs differ")
        for p in range(a.costs.shape[1]):
            for n in a.variants:
                check(np.array_equal(a.results[0][p][n].start,
                                     b.results[0][p][n].start),
                      f"[service] {name}: {what} starts differ ({n})")

    def valid(res, inst_, prof_):
        for n in res.variants:
            validate_schedule(inst_, prof_, res.result(variant=n).start)

    if name == "two-groups":
        pinned = PlanRequest(instances=inst, profiles=prof,
                             variants=("asap", "pressWR-LS"))
        reqs = [req, pinned, req, pinned]
        direct = [planner.plan(r) for r in reqs]
        with PlanService(planner.clone(), workers=2) as svc:
            svc.pause()
            tickets = [svc.submit(r) for r in reqs]
            svc.resume()
            served = [t.result(timeout=120) for t in tickets]
            stats = svc.stats()
        check(stats["batches"] == 2, f"[service] {name}: "
              f"{stats['batches']} batches, not 2 groups")
        for s, d in zip(served, direct):
            check(not s.degraded and s.attempts == ("heuristic:ok",),
                  f"[service] {name}: degraded, attempts {s.attempts}")
            same(s, d, "served vs direct")
            valid(s, inst, prof)
        return served
    if name == "mapping-budget-zero":
        wf = make_workflow("eager", 2, seed=0)
        mplat = make_cluster(1, seed=0)
        scarce = generate_profile("S3", 400, mplat, J=12, seed=2,
                                  work_capacity=40)
        with PlanService(Planner(mplat, engine="torch",
                                 device=device)) as svc:
            res = svc.plan(PlanRequest(
                instances=wf, profiles=scarce, mapping="search",
                mapping_options={"seeds": 8, "rounds": 6,
                                 "neighbors": 16}), budget=0.0)
        check(res.degraded and res.fallback_stage == "asap"
              and res.mapping_mode == "heft"
              and "mapping:heft" in res.attempts,
              f"[service] {name}: stage {res.fallback_stage}, mapping "
              f"{res.mapping_mode}, attempts {res.attempts}")
        valid(res, build_instance(wf, res.mappings[0], mplat), scarce)
        return [res]
    faults, kw, budget = {
        "transient-crash": ([FaultSpec(kind="crash", stage="heuristic",
                                       times=1)],
                            dict(retries=2, backoff=0.01), None),
        "oom-blocked-retry": ([FaultSpec(kind="oom", stage="heuristic",
                                         times=1)],
                              dict(lp_retry_budget_bytes=lp_matrix_bytes(
                                  inst.num_tasks) - 1), None),
        "hang-watchdog": ([FaultSpec(kind="hang", stage="heuristic",
                                     times=5, seconds=2.0)], {}, 0.3),
    }[name]
    direct = planner.plan(req)
    inj = ServiceFaultInjector(faults=faults)
    with PlanService(planner.clone(), injector=inj, **kw) as svc:
        t0 = time.perf_counter()
        res = svc.plan(req, budget=budget)
        elapsed = time.perf_counter() - t0
        stats = svc.stats()
        blocked = [p for (_, b), p in svc._planners.items() if b]
    valid(res, inst, prof)
    if name == "hang-watchdog":
        check(res.attempts == ("heuristic:timeout", "asap:ok")
              and elapsed < 1.5, f"[service] {name}: attempts "
              f"{res.attempts} in {elapsed:.3f} s")
        return [res]
    want = {"transient-crash": ("heuristic:crash", "heuristic:ok"),
            "oom-blocked-retry": ("heuristic:oom",
                                  "heuristic:oom-retry-blocked-lp",
                                  "heuristic:ok")}[name]
    check(res.attempts == want and not res.degraded,
          f"[service] {name}: attempts {res.attempts}, degraded "
          f"{res.degraded}")
    same(res, direct, "served vs direct")
    if name == "oom-blocked-retry":
        check(stats["oom_retries"] == 1 and
              blocked[0].prepared(inst, prof.T).lp_is_blocked,
              f"[service] {name}: the retry did not stream BlockedLP")
    return [res]


DRILLS = ("transient-crash", "oom-blocked-retry", "hang-watchdog",
          "mapping-budget-zero", "two-groups")


def service_drills():
    """[service] (c): each scripted fault through a service on the card and
    through one on the CPU: the attempts logs and the delivered plans
    equal."""
    import numpy as np

    for name in DRILLS:
        t0 = time.perf_counter()
        card = run_drill(name, None)
        card_s = time.perf_counter() - t0
        cpu = run_drill(name, "cpu")
        for a, b in zip(card, cpu):
            check(a.attempts == b.attempts, f"[service] {name}: card "
                  f"attempts {a.attempts} != CPU {b.attempts}")
            check(np.array_equal(a.costs, b.costs), f"[service] {name}: "
                  f"card costs != CPU costs")
            for p in range(a.costs.shape[1]):
                for n in a.variants:
                    check(np.array_equal(a.results[0][p][n].start,
                                         b.results[0][p][n].start),
                          f"[service] {name}: card starts != CPU ({n})")
        log(f"[service] (c) {name}: attempts {list(card[0].attempts)} "
            f"(card == CPU), {len(card)} plan(s) equal bitwise and valid; "
            f"card {card_s:.3f} s")


def service_gate():
    """[service] (d): CarbonGate.make_plan on the card and on the CPU, with
    tests/test_substrates.py's fleet, chunks and barriers, nominal and with
    an S1-S3 ensemble at the same horizon (``variant="auto"``)."""
    import numpy as np

    from repro_torch.core import generate_profile
    from repro_torch.runtime import CarbonGate
    from repro_torch.runtime.carbon_gate import fleet_platform

    plat = fleet_platform(pods=2, chip_watts_idle=100, chip_watts_work=250,
                          chips_per_pod=4)
    chunks = [[30] * 12, [30] * 12]
    horizon = 3 * 12 * 30
    prof = generate_profile("S1", horizon, plat, J=24, seed=0)
    members = [generate_profile(s, horizon, plat, J=24, seed=seed)
               for s, seed in (("S2", 1), ("S3", 2))]
    for label, variant, ensemble in (("nominal", "pressWR-LS", None),
                                     ("ensemble", "auto", members)):
        plans = []
        for device in (None, "cpu"):
            t0 = time.perf_counter()
            gate = CarbonGate(prof, plat, variant=variant,
                              profiles=ensemble, device=device)
            plans.append((gate.engine, gate.make_plan(chunks, barriers=[5]),
                          time.perf_counter() - t0))
        (engine, card, card_s), (_, cpu, _) = plans
        check(np.array_equal(card.start, cpu.start)
              and np.array_equal(card.cost_matrix, cpu.cost_matrix)
              and card.variant == cpu.variant,
              f"[service] gate {label}: card != CPU")
        check(card.cost <= card.asap_cost, f"[service] gate {label}: cost "
              f"{card.cost} > asap {card.asap_cost}")
        log(f"[service] (d) CarbonGate {label} (engine {engine}): variant "
            f"{card.variant}, cost {card.cost} <= asap {card.asap_cost}, "
            f"cost matrix {card.cost_matrix.tolist()}; card == CPU bitwise; "
            f"card {card_s:.3f} s")


def phase_service(plat, insts, grid, cold, cold_s):
    """The planning service on the card: (a) crash and replay at the matrix
    size, (b) how fast a cancellation frees the card, (c) fault drills card
    vs CPU, (d) the CarbonGate card vs CPU."""
    from repro_torch.kernels import carbon_cost, gain_scan

    t_phase = time.perf_counter()
    gain_scan.LAUNCHES = carbon_cost.LAUNCHES = 0
    replay = service_replay(plat, insts, grid, cold, cold_s)
    eager = KINDS.index("eager")
    cancels = service_cancel(plat, insts[eager], grid[eager])
    service_drills()
    service_gate()
    launches = {"gain_scan": gain_scan.LAUNCHES,
                "carbon_cost": carbon_cost.LAUNCHES}
    check(launches["gain_scan"] > 0, "[service] the service did not launch "
          "the gain_scan kernel")
    check(launches["carbon_cost"] > 0, "[service] the deficit kernel did "
          "not cost the service's schedules")
    secs = time.perf_counter() - t_phase
    log(f"[service] launches gain_scan {launches['gain_scan']}, carbon_cost "
        f"{launches['carbon_cost']}; the phase {secs:.3f} s in all")
    return {**launches, "seconds": secs, "replay": replay,
            "cancel": cancels}


def flash_bound_ms(B, S, H, hd, causal, dtype) -> tuple[float, str]:
    """Least time for one attention pass: q, k, v read once and the output
    written once, against the flops of QK^T and PV over the keys each query
    sees (the lower triangle when causal), at the card's peak for the input
    type (bf16: the tensor cores; f32: the CUDA cores, since TF32 is not
    f32)."""
    esize = 2 if dtype == "bfloat16" else 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    t_bytes = 4 * B * S * H * hd * esize / HBM_BYTES_PER_S
    t_ops = flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_inputs(B, S, H, hd, dtype, seed, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, S, H, hd), generator=g, device=dev)
            .to(getattr(torch, dtype)) for _ in range(3)]


def close_err(got, want, tol) -> float:
    """Largest |got - want| - tol |want| (allclose with rtol = atol = tol
    holds when it is <= tol)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - tol * w.abs()).max())


def phase_flash(dev):
    """The flash-attention kernels against their plain version on the card;
    times at the shapes of ``FLASH_TIMED``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    cases = [(f"sweep {c}", c) for c in FLASH_SWEEP]
    cases += [(f"bf16 twin {c[:5]}", c) for c in FLASH_BF16_TWINS]
    errs = {}
    for label, (B, S, H, hd, causal, dt) in cases:
        q, k, v = flash_inputs(B, S, H, hd, dt, seed=B * S + H, dev=dev)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention(q, k, v, causal=causal, mode="plain")
        torch.cuda.synchronize()
        check(got.dtype == q.dtype and got.shape == q.shape,
              f"flash kernel output {got.dtype} {tuple(got.shape)} ({label})")
        check(bool(torch.isfinite(got).all()), f"non-finite flash output "
              f"({label})")
        err = close_err(got, want, FLASH_TOL[dt])
        check(err <= FLASH_TOL[dt], f"flash kernel != plain ({label}): "
              f"|got - want| - tol |want| reaches {err} > {FLASH_TOL[dt]}")
        errs[label] = float((got.float() - want.float()).abs().max())
    # strided views: q, k, v as slices of one [B, S, 3, H, hd] projection
    # (rows 3 H hd apart) and a non-causal pass over them
    for dt in ("bfloat16", "float32"):
        B, S, H, hd = 2, 300, 4, 128
        g = torch.Generator(device=dev).manual_seed(SEED)
        qkv = torch.randn((B, S, 3, H, hd), generator=g, device=dev)
        q, k, v = qkv.to(getattr(torch, dt)).unbind(2)
        check(not q.is_contiguous() and fa._rows_aligned(q),
              "the strided case must reach the kernel without a copy")
        for causal in (True, False):
            got = fa.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      mode="plain")
            err = close_err(got, want, FLASH_TOL[dt])
            check(err <= FLASH_TOL[dt], f"flash kernel != plain on strided "
                  f"{dt} views (causal={causal}): {err}")
    log("[flash] kernel == plain within tolerance (f32 2e-5, bf16 2e-2) on "
        "the five sweep shapes, their bf16 twins and strided views; max "
        "|kernel - plain|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))

    rows = {}
    for key, (B, S, H, hd, dt) in FLASH_TIMED.items():
        q, k, v = flash_inputs(B, S, H, hd, dt, seed=B * S + H, dev=dev)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention(q, k, v, causal=True, mode="plain")
        err = close_err(got, want, FLASH_TOL[dt])
        check(bool(torch.isfinite(got).all()) and err <= FLASH_TOL[dt],
              f"flash kernel != plain ({key}): {err} > {FLASH_TOL[dt]}")
        max_err = float((got.float() - want.float()).abs().max())

        def kernel():
            fa.flash_attention(q, k, v, causal=True)

        reps = 50
        event_ms = cuda_ms(kernel, reps=reps)
        replay_ms = graph_ms(kernel, reps=reps)
        device_ms = profiled_ms(kernel, reps, "flash_fwd_kernel", PROFILE_OUT)
        plain_ms = cuda_ms(lambda: fa.flash_attention(
            q, k, v, causal=True, mode="plain"), reps=5, warm=2)
        # yardstick, not used by the port: PyTorch's fused attention on the
        # [B, H, S, hd] layout it takes
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)

        sdpa_diff = float((sdpa().transpose(1, 2).float()
                           - fa.flash_attention(q, k, v).float()).abs().max())
        sdpa_ms = cuda_ms(sdpa, reps=reps)
        bound, by = flash_bound_ms(B, S, H, hd, True, dt)
        ms, ms_from = ((device_ms, "profiler") if device_ms is not None
                       else (replay_ms, "graph"))
        rows[key] = {"shape": f"B={B} S={S} H={H} hd={hd} causal {dt}",
                     "max_abs_err": max_err, "ms": ms,
                     "ms_from": ms_from, "profiler_ms": device_ms,
                     "graph_ms": replay_ms, "event_ms": event_ms,
                     "plain_ms": plain_ms, "library_ms": sdpa_ms,
                     "bound_ms": bound, "bound_by": by}
        log(f"[flash] B={B} S={S} H={H} hd={hd} causal {dt}: kernel "
            f"{ms:.4f} ms ({ms_from}; profiler {device_ms}, graph replay "
            f"{replay_ms:.4f}, eager events {event_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention {sdpa_ms:.4f} "
            f"ms (max |sdpa - kernel| {sdpa_diff:.3g}), bound {bound:.4f} ms "
            f"({by}), {100 * bound / ms:.2f}% of bound, {ms / sdpa_ms:.2f}x "
            f"the PyTorch call")
    return rows


@contextlib.contextmanager
def plain_attention():
    """Route the model forward's attention through the plain version (the
    comparison forward)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    layers.flash_attention = functools.partial(fa.flash_attention,
                                               mode="plain")
    try:
        yield
    finally:
        layers.flash_attention = fa.flash_attention


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| (Frobenius, in f32)."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def phase_model(dev, cfg=None, B=MODEL_B, S=MODEL_S):
    """The full-width model's forward on the card through the kernel: the
    bf16 loss, and the final hidden states in bf16 and f32 against
    plain-attention forwards of the same parameters."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, param_count

    cfg = cfg or ARCHS[ARCH]
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    batch = SyntheticTokens(cfg, ShapeConfig("serve_prefill", "prefill", S,
                                             B), seed=SEED).batch(0)
    L = cfg.num_layers

    def through_kernel(fn, what):
        before = fa.LAUNCHES
        out, secs = timed(fn)
        check(fa.LAUNCHES - before == L, f"{what} launched the flash kernel "
              f"{fa.LAUNCHES - before} times, not {L}")
        return out, secs

    def plain(fn, what):
        before = fa.LAUNCHES
        with plain_attention():
            out, secs = timed(fn)
        check(fa.LAUNCHES == before, f"{what} launched the flash kernel")
        return out, secs

    fa.LAUNCHES = 0
    loss_cold, cold_s = through_kernel(lambda: float(model.loss(batch)),
                                       "the cold loss")
    loss_warm, warm_s = through_kernel(lambda: float(model.loss(batch)),
                                       "the warm loss")
    ln_v = math.log(cfg.vocab)
    for tag, val in (("cold", loss_cold), ("warm", loss_warm)):
        check(math.isfinite(val) and abs(val - ln_v) < 0.5,
              f"{tag} loss {val} is not finite or not within 0.5 of ln V = "
              f"{ln_v:.4f}")
    h16, apply_s = through_kernel(lambda: model.apply(batch),
                                  "the bf16 forward")
    check(h16.shape == (B, S, cfg.d_model) and h16.dtype == torch.bfloat16
          and bool(torch.isfinite(h16).all()),
          f"hidden states {h16.dtype} {tuple(h16.shape)} not finite bf16")
    h16p, plain_s = plain(lambda: model.apply(batch), "the plain forward")
    # where a warm loss forward and a serving decode step (4 slots, a
    # 512-position cache) spend the card's time
    fwd = device_breakdown(lambda: model.loss(batch), 2, PROFILE_OUT)
    cache = model.init_cache(4, 512)
    tokens = torch.as_tensor(batch["tokens"][0, :4], device=dev)
    for _ in range(16):
        model.decode_step(cache, tokens)
    step = device_breakdown(lambda: model.decode_step(cache, tokens), 16,
                            PROFILE_OUT)
    log(f"[model] warm loss forward: {breakdown_text(fwd)}")
    log(f"[model] decode step (B=4, cache 512): {breakdown_text(step)}")
    del model, cache
    model = build_model(dataclasses.replace(cfg, dtype="float32"),
                        device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    h32, apply32_s = through_kernel(lambda: model.apply(batch),
                                    "the f32 forward")
    h32p, _ = plain(lambda: model.apply(batch), "the plain f32 forward")
    launches = fa.LAUNCHES
    del model

    err32 = close_err(h32, h32p, F32_MODEL_TOL)
    check(err32 <= F32_MODEL_TOL, f"f32 kernel forward != plain forward: "
          f"|h - h_plain| - tol |h_plain| reaches {err32} > {F32_MODEL_TOL}")
    rel16 = rel_err(h16, h16p)
    check(rel16 <= BF16_MODEL_TOL, f"bf16 kernel forward != plain forward: "
          f"relative error {rel16} > {BF16_MODEL_TOL}")
    to_f32, plain_to_f32 = rel_err(h16, h32p), rel_err(h16p, h32p)
    check(to_f32 <= BF16_MODEL_SLACK * plain_to_f32, f"the bf16 kernel "
          f"forward is {to_f32} from the f32 forward, the plain bf16 "
          f"forward {plain_to_f32}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    max32 = float((h32 - h32p).abs().max())
    max16 = float((h16.float() - h16p.float()).abs().max())
    log(f"[model] {cfg.name}: {n_params / 1e6:.3f}M params (f32 master, "
        f"{cfg.dtype} activations), init {init_s:.3f} s; loss on B={B} "
        f"S={S}: cold {cold_s:.3f} s, warm {warm_s:.3f} s, loss "
        f"{loss_cold:.6f} / {loss_warm:.6f} (ln V = {ln_v:.6f}); forward to "
        f"hidden states {apply_s:.3f} s through the kernel, {plain_s:.3f} s "
        f"plain (f32: {apply32_s:.3f} s); kernel vs plain: f32 max "
        f"{max32:.4g} (allclose {F32_MODEL_TOL}), bf16 relative "
        f"{rel16:.4g} (<= {BF16_MODEL_TOL}; max {max16:.4g} on |h| up to "
        f"{float(h32p.abs().max()):.4g}), bf16 to f32 {to_f32:.4g} "
        f"(plain bf16 {plain_to_f32:.4g}); flash launches {launches} ({L} "
        f"per forward); peak memory {peak_gb:.2f} GiB")
    torch.cuda.empty_cache()
    return {"launches": launches, "loss": loss_warm, "cold_s": cold_s,
            "warm_s": warm_s, "apply_s": apply_s, "plain_s": plain_s,
            "f32_max_abs_diff": max32, "bf16_rel_err": rel16,
            "forward": fwd, "decode_step": step}


def phase_serve(dev, cfg=None, requests=16, slots=4, max_new=32,
                max_len=512):
    """The serve entry point at full width, then forward == decode in f32."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    cfg = cfg or ARCHS[ARCH]
    fa.LAUNCHES = 0
    out = serve(cfg, requests, slots, max_new, max_len, device=dev)
    serve_launches = fa.LAUNCHES
    reqs = out["requests"]
    check(len(reqs) == requests and all(r.done and r.out for r in reqs),
          f"{sum(r.done for r in reqs)} of {requests} requests finished")
    check(out["steps"] < max_len, f"{out['steps']} decode steps overran the "
          f"cache of {max_len}")
    n_tokens = sum(len(r.out) for r in reqs)
    log(f"[serve] {cfg.name} ({out['params'] / 1e6:.3f}M params, "
        f"{cfg.dtype}): {requests} requests on {slots} slots, max_new "
        f"{max_new}, max_len {max_len}: all finished in {out['steps']} "
        f"decode steps, {out['seconds']:.3f} s "
        f"({out['tokens'] / out['seconds']:.1f} slot tokens/s, {n_tokens} "
        f"request tokens, "
        f"{1e3 * out['seconds'] / out['steps']:.3f} ms per step); flash "
        f"launches {serve_launches} (decode attention is plain torch)")

    # forward == step-by-step decode (tests/test_model_equivalence.py) at
    # full width in f32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    B, S = 2, 8
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    fa.LAUNCHES = 0
    full = L.unembed(model.apply(batch), model.embed)          # [B,S,V]
    eq_launches = fa.LAUNCHES
    check(eq_launches == cfg.num_layers, f"the f32 forward launched the "
          f"flash kernel {eq_launches} times")
    cache = model.init_cache(B, S + 2)
    dec = []
    for t in range(S):
        logits, cache = model.decode_step(cache, batch["tokens"][:, t])
        dec.append(logits)
    dec = torch.stack(dec, dim=1)
    err = close_err(dec, full, DECODE_TOL)
    diff = float((dec - full).abs().max())
    check(err <= DECODE_TOL, f"decode logits != forward logits: {err}")
    log(f"[serve] forward == decode at full width in f32 (B={B}, S={S}): "
        f"max |decode - forward| {diff:.4g} (tolerance {DECODE_TOL}); flash "
        f"launches {eq_launches}")
    del model, cache
    torch.cuda.empty_cache()
    return {"steps": out["steps"], "seconds": out["seconds"],
            "launches": serve_launches, "eq_launches": eq_launches,
            "decode_diff": diff}


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure(
            f"{SRC}/repro_torch not found: run chip_smoke.py from the root "
            f"of a checkout of the repository")
    sys.path.insert(0, SRC)
    import torch

    from repro_torch import obs

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    dev = torch.device("cuda")
    obs.configure(tracing=False, torch_hooks_on=True)   # nvcc builds
    # f32 matrix products in full f32, so the plain versions are true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if os.path.exists(PROFILE_OUT):
        os.remove(PROFILE_OUT)

    build_kernels()
    gain_rows = phase_kernels(dev)
    deficit_rows = phase_deficit(dev)

    t0 = time.perf_counter()
    plat, insts, grid = build_matrix()
    log(f"[matrix] built in {time.perf_counter() - t0:.3f} s")
    card, launches, cold_s, _ = phase_plan(plat, insts, grid)
    cost_launches, oracle_ms = phase_cost_oracle(insts, grid, card, dev)
    eager = KINDS.index("eager")           # the smallest instance
    phase_cpu(plat, insts, grid, card, eager)
    phase_blocked(plat, insts, grid, card, eager)
    exact_launches = phase_exact()
    session_launches = phase_session(plat, insts[eager])
    mapping_run = phase_mapping(plat)
    service_run = phase_service(plat, insts, grid, card, cold_s)
    flash_rows = phase_flash(dev)
    model_run = phase_model(dev)
    serve_run = phase_serve(dev)

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
                             "session": session_launches["gain_scan"],
                             "mapping": mapping_run["gain_scan"],
                             "service": service_run["gain_scan"]},
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
        + session_launches["carbon_cost"] + mapping_run["carbon_cost"]
        + service_run["carbon_cost"],
        "launches_by_path": {"cost": cost_launches,
                             "exact": exact_launches["carbon_cost"],
                             "session": session_launches["carbon_cost"],
                             "mapping": mapping_run["carbon_cost"],
                             "service": service_run["carbon_cost"]},
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
        "oracle_ms_per_schedule": oracle_ms,
        "bitwise_vs_plain": True,
        "shape": plan_row["shape"],
        "large": large_row,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": model_run["launches"] + serve_run["launches"]
        + serve_run["eq_launches"],
        "launches_by_path": {"model": model_run["launches"],
                             "serve": serve_run["launches"],
                             "forward_vs_decode": serve_run["eq_launches"]},
        **{k: flash_rows["bfloat16"][k] for k in (
            "max_abs_err", "ms", "ms_from", "event_ms", "graph_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "float32": flash_rows["float32"],
        "bfloat16_hd128": flash_rows["bfloat16_hd128"],
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
