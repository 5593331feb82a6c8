"""Serve a small model with continuously batched requests.

Before serving, the decode workload is planned carbon-aware through the
Planner API: the request backlog becomes a chain of decode chunks (a
fixed-mapping workflow), and one ``Planner.plan`` call places them inside
the site's green windows (simulated — the demo prints the admission plan
and then serves immediately).

The admission planning runs with tracing enabled: the coalesced burst
plus one forced degradation (a zero-budget request that walks the
fallback ladder down to ``asap``) produce a span trace that is dumped as
Chrome trace_event JSONL — load it line by line, or wrap in ``[...]``
for ``chrome://tracing`` / Perfetto.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --requests 12 --slots 4 [--device cpu]

The port of the reference's ``examples/serve_batched.py``: the same calls
and lines, on ``--device`` (None = the card). The process's tracer is put
back as it was found after the admission plan.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api import Planner, PlanRequest
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import generate_profile
from repro_torch.core.dag import build_instance
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.serve import synchronize
from repro_torch.models import build_model, param_count
from repro_torch.runtime.carbon_gate import chunk_workflow, fleet_platform
from repro_torch.serve import ContinuousBatcher, PlanService, Request


def carbon_admission_plan(n_requests: int, slots: int, est_chunk_s: int = 5,
                          trace_out: str = "serve_trace.jsonl",
                          device=None) -> dict:
    """Green-window admission plan of the decode backlog (one chain of
    per-batch decode chunks on a 1-pod serving platform), traced: a
    coalesced 3-caller burst plus one zero-budget request forced down
    the fallback ladder, dumped to ``trace_out`` as JSONL. Returns what
    it printed: chunks, costs, starts, the service's coalescing, the
    degradation and the span count."""
    plat = fleet_platform(pods=1, chip_watts_idle=40, chip_watts_work=120,
                          chips_per_pod=8)
    n_chunks = max(-(-n_requests // slots), 1)
    chunk = [[est_chunk_s] * n_chunks]
    wf, mapping = chunk_workflow([n_chunks], chunk)
    inst = build_instance(wf, mapping, plat, dur=wf.node_w)
    horizon = 3 * n_chunks * est_chunk_s
    profile = generate_profile("S1", horizon, plat, J=12, seed=4,
                               work_capacity=int(plat.p_work[0]))
    prev = obs.tracer()
    tracer, _ = obs.configure(tracing=True)
    try:
        # plan through the resilient serving tier: a blown budget degrades
        # to a feasible asap plan instead of failing admission
        with PlanService(Planner(plat, device=device),
                         default_budget=10.0) as svc:
            req = PlanRequest(instances=inst, profiles=profile,
                              variants=("asap", "pressWR-LS"))
            svc.pause()                    # let the burst pile up: coalesce
            burst = [svc.submit(req) for _ in range(3)]
            svc.resume()
            res = [t.result(timeout=120) for t in burst][0]
            # forced degradation: no budget left => skip straight to asap
            degraded = svc.plan(req, budget=0.0)
            stats = svc.stats()
        n_events = tracer.dump_jsonl(trace_out)
    finally:
        obs.set_tracer(prev)
    plan = res.result(variant="pressWR-LS" if "pressWR-LS" in res.variants
                      else res.variants[-1])
    asap = res.result(variant="asap")
    state = (f"degraded to {res.fallback_stage}" if res.degraded
             else "full fidelity")
    starts = [int(s) for s in plan.start]
    print(f"carbon admission plan: {n_chunks} decode chunks, carbon "
          f"{plan.cost} vs ASAP {asap.cost} "
          f"({plan.cost / max(asap.cost, 1):.2f}x, {state}); chunk starts "
          f"{starts[:8]}"
          f"{'...' if len(plan.start) > 8 else ''} (simulated)")
    rungs = [s for s in tracer.finished() if s.name.startswith("rung:")]
    walk = ", ".join(f"{s.name.split(':', 1)[1]}:"
                     f"{s.attrs.get('outcome')} {s.duration * 1e3:.1f}ms"
                     for s in sorted(rungs, key=lambda s: s.t0))
    print(f"  coalesced {stats['coalesced_requests']} requests into "
          f"{stats['batches']} launches; forced degradation served by "
          f"{degraded.fallback_stage} ({', '.join(degraded.attempts)})")
    print(f"  trace: {n_events} spans -> {trace_out} (rungs: {walk})")
    return {"chunks": n_chunks, "cost": int(plan.cost),
            "asap_cost": int(asap.cost), "degraded": bool(res.degraded),
            "starts": starts, "coalesced": stats["coalesced_requests"],
            "batches": stats["batches"],
            "fallback_stage": degraded.fallback_stage,
            "attempts": list(degraded.attempts), "spans": n_events,
            "trace_out": trace_out}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--trace-out", default="serve_trace.jsonl",
                    help="where the admission-planning span trace lands "
                         "(Chrome trace_event JSONL)")
    ap.add_argument("--device", default=None,
                    help="torch device of the planner and the model "
                         "(default: the card)")
    return ap.parse_args(argv)


def run(args, model=None) -> dict:
    """The admission plan, then the reduced f32 model of ``--arch``
    serving the requests. ``model``: the decoder to serve (on
    ``--device``, parameters set); None = built here with parameters from
    seed 0. Prints the reference's lines; returns the plan's and the
    serving's values."""
    dev = resolve_device(args.device)
    admission = carbon_admission_plan(args.requests, args.slots,
                                      trace_out=args.trace_out, device=dev)

    cfg = dataclasses.replace(reduced(ARCHS[args.arch]), dtype="float32")
    if model is None:
        model = build_model(cfg, tp=16, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))
    print(f"serving {cfg.name}: {param_count(model)/1e6:.2f}M params, "
          f"{args.slots} decode slots")

    batcher = ContinuousBatcher(model, batch_size=args.slots, max_len=256,
                                eos=0)
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, rng.integers(2, 6)).tolist()
        reqs.append(Request(rid=rid, prompt=prompt, max_tokens=args.max_new))
        batcher.submit(reqs[-1])

    synchronize(dev)
    t0 = time.time()
    steps = 0
    while batcher.queue or any(r is not None and not r.done
                               for r in batcher.slots):
        batcher.step()
        steps += 1
        if steps > 10_000:
            break
    synchronize(dev)
    dt = time.time() - t0
    done = [r for r in batcher.slots if r is not None and r.done]
    print(f"{steps} decode steps in {dt:.1f}s "
          f"({steps * args.slots / dt:.1f} tok/s aggregate)")
    for r in done[:4]:
        print(f"  req {r.rid}: {len(r.out)} tokens -> {r.out[:10]}...")
    return {"device": str(dev), "admission": admission,
            "params": param_count(model), "steps": steps, "seconds": dt,
            "requests": reqs}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
