#!/usr/bin/env python3
"""Count how many kernel launches one ``torch.profiler`` trace keeps.

    python3 chip_profiler_probe.py [--after-scheduler | --drift]

Run from the root of a checkout on a CUDA host (the port's kernels are
built with ``nvcc`` first). For the flash-attention kernel (50 launches of
0.1 ms at B=4, S=2048, H=16, hd=64, bf16) and the gain-sweep kernel (200
launches of 0.007 ms at R=32, Np=4352, Tp=1024, mu=10) it takes, in one
process and in this order, three traces of each of four forms:

* ``bare``: ``with profile(...)`` around the launches and a synchronize;
* ``padded``: the same, with a synchronize and 20 ms of host sleep inside
  the trace before the first launch and after the last synchronize;
* ``warmup``: ``schedule(wait=0, warmup=1, active=1)``: one step of the
  same launches while the profiler warms up, then the recorded step;
* ``warmup_padded``: the schedule and the padding together;

then the same four forms again, each trace preceded, as in
``chip_smoke.py``, by a CUDA-event timing of ``reps`` launches and a
CUDA-graph capture and replay of them (``after_graph``); and prints, for
each trace, how many launches of the kernel its ``key_averages()`` holds.
With ``--after-scheduler`` the traces come after ``chip_smoke.py``'s
heuristic plan and session phases have run in the same process, as its
``[flash]`` traces do. With ``--drift`` the probe instead takes one bare
trace of the gain kernel first, then, at ``DRIFT_DELAYS`` seconds after
it, one trace of the flash kernel in each of the four forms: whether the
loss grows with the time since the process's first trace, and which form
keeps every launch. The last line is a JSON object with the counts.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PAD_S = 0.02
DRIFT_DELAYS = (0, 60, 120, 240, 360)
FORMS = ("bare", "padded", "warmup", "warmup_padded")


def count(prof, kernel) -> int:
    return sum(ev.count for ev in prof.key_averages() if kernel in ev.key)


def trace(fn, reps, kernel, form) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    padded = form.endswith("padded")

    def run():
        if padded:
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if padded:
            time.sleep(PAD_S)

    if form.startswith("warmup"):
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                run()
                prof.step()
    else:
        with profile(activities=acts) as prof:
            run()
    return count(prof, kernel)


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gain_scan

    if not torch.cuda.is_available():
        print("chip_profiler_probe: needs a CUDA device", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {chip_smoke.nvidia_smi_line()}",
          flush=True)
    chip_smoke.build_kernels()
    dev = torch.device("cuda")
    if "--after-scheduler" in sys.argv[1:]:
        t0 = time.perf_counter()
        plat, insts, grid = chip_smoke.build_matrix()
        chip_smoke.phase_plan(plat, insts, grid)
        chip_smoke.phase_session(plat, insts[chip_smoke.KINDS.index("eager")])
        print(f"scheduler phases ran in {time.perf_counter() - t0:.3f} s",
              flush=True)
    q, k, v = chip_smoke.flash_inputs(4, 2048, 16, 64, "bfloat16", seed=1,
                                      dev=dev)
    args = chip_smoke.gain_inputs(32, 4352, 1024, 10, seed=10, dev=dev)
    cases = {
        "flash_fwd_kernel": (lambda: fa.flash_attention(q, k, v,
                                                        causal=True), 50),
        "gain_scan_kernel": (lambda: gain_scan.gain_sweep(*args, mu=10),
                             200),
    }
    out = {}
    if "--drift" in sys.argv[1:]:
        gfn, greps = cases["gain_scan_kernel"]
        ffn, freps = cases["flash_fwd_kernel"]
        gfn()
        ffn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["first_gain_trace"] = trace(gfn, greps, "gain_scan_kernel",
                                        "bare")
        for delay in DRIFT_DELAYS:
            time.sleep(max(0.0, t0 + delay - time.perf_counter()))
            counts = {form: trace(ffn, freps, "flash_fwd_kernel", form)
                      for form in FORMS}
            out[f"flash_fwd_kernel.after_{delay}s"] = counts
            print(f"flash_fwd_kernel x {freps}, {delay} s after the first "
                  f"trace: {counts}", flush=True)
        print(json.dumps(out), flush=True)
        return 0
    for kernel, (fn, reps) in cases.items():
        fn()
        torch.cuda.synchronize()
        for prelude in (False, True):
            for form in FORMS:
                counts = []
                for _ in range(3):
                    if prelude:
                        chip_smoke.cuda_ms(fn, reps=reps)
                        chip_smoke.graph_ms(fn, reps=reps)
                    counts.append(trace(fn, reps, kernel, form))
                key = f"{kernel}.{'after_graph.' if prelude else ''}{form}"
                out[key] = counts
                print(f"{key} x {reps}: {counts}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
