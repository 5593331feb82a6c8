"""End-to-end driver: train a language model with carbon-aware step gating.

The training run is divided into step chunks; CaWoSched (the paper's
scheduler) assigns each chunk a start time inside the site's green-energy
windows, and the loop gates on that plan (simulated clock: 1 step = 1 s).
Checkpoints + deterministic data make the run restartable at any point.

    PYTHONPATH=src python -m repro_torch.examples.train_carbon_aware \
        --steps 120 --chunk 10 [--model-size 100m] [--inject-failure] \
        [--device cpu]

The port of the reference's ``examples/train_carbon_aware.py``: the same
calls and lines, on ``--device`` (None = the card). ``--model-size 10m``
(the default) is a ~7M-parameter SmolLM-family config; ``100m`` is the
example's real config (12 layers, d_model 768, 12 heads of 64 over 4
kv heads, vocab 49,152, f32), whose attention runs through the f32 flash
kernels on the card. The default ``--ckpt-dir`` is the port's own
directory under the temporary directory: the run resumes from the newest
checkpoint it finds there, so a directory of an earlier run finishes at
once.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.core import generate_profile
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build_model, param_count
from repro_torch.runtime import FailureInjector, run_with_restarts
from repro_torch.runtime.carbon_gate import CarbonGate, fleet_platform
from repro_torch.train.step import init_state, make_train_step


def model_config(size: str):
    base = ARCHS["smollm-360m"]
    if size == "100m":
        return dataclasses.replace(
            base, name="smollm-100m", num_layers=12, d_model=768,
            num_heads=12, kv_heads=4, d_ff=2048, head_dim=64,
            vocab=49152, dtype="float32")
    r = reduced(base)
    return dataclasses.replace(r, d_model=256, num_layers=6, d_ff=1024,
                               vocab=8192, dtype="float32")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-size", default="10m", choices=["10m", "100m"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--variant", default="pressWR-LS")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the gate's planner "
                         "(default: the card)")
    return ap.parse_args(argv)


def run(args, init=None) -> dict:
    """Plan the chunks, then train under the gate with restarts.
    ``init(model)``: the initial training state of ``model`` (run when no
    checkpoint is found); None = ``init_state`` from seed 0. Prints the
    reference's lines; returns the plan's costs, the gate's waits, each
    logged step's loss and lr, the steps, restarts and simulated clock."""
    dev = resolve_device(args.device)
    cfg = model_config(args.model_size)
    model = build_model(cfg, tp=16, device=dev)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    data = SyntheticTokens(cfg, shape, seed=0)
    step_fn = make_train_step(model, microbatches=1, warmup=20)

    # --- carbon plan: chunks of `chunk` steps, ~1 s per step (simulated)
    n_chunks = -(-args.steps // args.chunk)
    plat = fleet_platform(pods=1, chip_watts_idle=60, chip_watts_work=200,
                          chips_per_pod=8)
    horizon = 3 * args.steps
    profile = generate_profile("S1", horizon, plat, J=24, seed=7,
                               work_capacity=plat.p_work[0])
    gate = CarbonGate(profile, plat, variant=args.variant, device=dev)
    plan = gate.make_plan([[args.chunk] * n_chunks])
    print(f"carbon plan: cost={plan.cost} vs ASAP={plan.asap_cost} "
          f"({plan.cost / max(plan.asap_cost, 1):.2f}x)")

    mgr = CheckpointManager(args.ckpt_dir, keep=2, every=args.chunk)
    injector = (FailureInjector(0.02, seed=1)
                if args.inject_failure else None)
    clock = {"now": 0.0}
    waits, logged = [], {}

    def train(state, start, stop):
        t_wall = time.time()
        for s in range(start, stop):
            if s % args.chunk == 0:
                wait = gate.wait_time(0, s // args.chunk, clock["now"])
                if wait > 0:
                    print(f"  [gate] chunk {s // args.chunk}: waiting "
                          f"{wait:.0f}s (simulated) for green window")
                    waits.append((s // args.chunk, wait))
                    clock["now"] += wait
            if injector is not None:
                injector.maybe_fail(s)
            state, metrics = step_fn(state, data.batch(s))
            clock["now"] += 1.0
            if s % 10 == 0:
                loss, lr = float(metrics["loss"]), float(metrics["lr"])
                logged[s] = (loss, lr)
                print(f"step {s:4d} loss={loss:.4f} lr={lr:.2e} "
                      f"({time.time() - t_wall:.1f}s wall)")
            mgr.maybe_save(state, s)
        return state

    def init_fn():
        if init is not None:
            state = init(model)
        else:
            state = init_state(model,
                               torch.Generator(device=dev).manual_seed(0))
        print(f"model {cfg.name}: {param_count(state['params'])/1e6:.1f}M "
              f"params")
        return state

    state, done, restarts = run_with_restarts(
        train, mgr, init_fn, args.steps, max_restarts=20)
    print(f"\ndone: {done} steps, {restarts} restarts, "
          f"final simulated clock {clock['now']:.0f}s")
    return {"device": str(dev), "cost": int(plan.cost),
            "asap_cost": int(plan.asap_cost), "waits": waits,
            "logged": logged, "steps": done, "restarts": restarts,
            "clock": clock["now"], "params": param_count(state["params"])}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
