"""Train driver, on the card (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --batch 8 --seq 256 [--reduced] [--carbon-gate] [--mp] \
        [--ckpt-dir DIR]

The flags are the reference's. ``--mesh none``, the default, trains on
one card; ``--mesh single|multi`` start the process group (one process a
mesh position: ``RANK``, ``WORLD_SIZE`` and a ``file://`` store at
``$REPRO_MESH_STORE``; :func:`repro_torch.launch.mesh.init_process_group`),
build the reference's production mesh over it (with fewer than 256 / 512
processes that raises the mesh's ``ValueError``, as the reference does
without the chips) and train under it: the model at the mesh's TP, the
state and every batch placed by the reference's specs, the step the
sharded step (:func:`train`'s ``mesh=``). The driver wires: config ->
model -> train step -> deterministic data -> checkpoint manager ->
(optional) CarbonGate. :func:`train` takes a configuration of any family,
full width included, and draws the family's batches from
:class:`repro_torch.data.SyntheticTokens` (Qwen2-VL: embeddings and
M-RoPE positions; Whisper: frame embeddings and decoder tokens).
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
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.serve import synchronize
from repro_torch.models import build_model, param_count
from repro_torch.runtime.carbon_gate import CarbonGate, fleet_platform
from repro_torch.sharding import ctx
from repro_torch.sharding.place import place_state
from repro_torch.train.step import init_state, make_train_step, on_device


def gate_plan(steps: int, gate_chunk: int, device=None) -> CarbonGate:
    """The reference CLI's CarbonGate: one pod of a 256-chip fleet, an S1
    forecast over three times the run's steps, and the run cut into chunks
    of ``gate_chunk`` steps; the plan is made."""
    plat = fleet_platform(1, 100, 250, chips_per_pod=256)
    prof = generate_profile("S1", 3 * steps, plat, J=24, seed=7,
                            work_capacity=int(plat.p_work[0]))
    gate = CarbonGate(prof, plat, device=device)
    gate.make_plan([[gate_chunk] * -(-steps // gate_chunk)])
    return gate


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 256,
          microbatches: int = 1, mp: bool = False, carbon_gate: bool = False,
          gate_chunk: int = 20, ckpt_dir: str | None, ckpt_every: int = 50,
          log_every: int = 10, device=None, mesh=None, tp: int | None = None,
          log=print) -> dict:
    """Train a model of ``cfg`` (random parameters from seed 0) on
    synthetic tokens (seed 0) for ``steps`` steps of ``batch`` x ``seq``
    tokens, resuming from the latest checkpoint in ``ckpt_dir`` and saving
    one every ``ckpt_every`` steps (asynchronously, keeping 3);
    ``ckpt_dir`` None: no checkpoints, from the first step.

    ``device`` None = the card (raises when there is none). ``mesh`` (a
    :class:`repro_torch.sharding.ctx.Mesh` with a ``DeviceMesh``, one
    process a position, e.g. from :func:`repro_torch.launch.mesh.init_mesh`):
    the mesh is configured (and stays so), the model built at its TP, the
    state placed by the reference's specs on every rank from the same seed
    (:func:`repro_torch.sharding.place.place_state`) and each batch by
    ``batch_specs``; checkpoints hold the gathered state, written by rank
    0. ``tp``: the model's TP head plan (default the mesh's "model" size,
    16 without a mesh). Each step
    updates the state in place (``make_train_step(donate=True)``). Returns
    the step it started at, the per-step losses, gradient norms and
    seconds (host clock, each step ending in a synchronize), the parameter
    count, the tokens a step, the final state, the step function it ran
    (which updates the state it is given in place), and with
    ``carbon_gate`` the gate plan's cost and ASAP cost and the simulated
    seconds it held chunks back.
    """
    dev = resolve_device(device)
    if mesh is not None:
        ctx.configure(mesh)
    if tp is None:
        tp = 16 if mesh is None else mesh.shape["model"]
    model = build_model(cfg, tp=tp, device=dev)
    data = SyntheticTokens(cfg, ShapeConfig("cli", "train", seq, batch),
                           seed=0)
    # the loop drops each old state: the step updates it in place
    step_fn = make_train_step(model, microbatches=microbatches,
                              warmup=min(50, steps // 5 + 1), donate=True)
    mgr = None if ckpt_dir is None else CheckpointManager(
        ckpt_dir, keep=3, every=ckpt_every, async_save=True, mesh=mesh)

    state, start = (None, -1) if mgr is None else mgr.restore_latest()
    if state is None:
        state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                           mixed_precision=mp)
        if mesh is not None:
            state = place_state(state, mesh, device=dev)
        start = -1
    state = on_device(state, dev)
    n_params = param_count(state["params"])
    log(f"{cfg.name}: {n_params / 1e6:.1f}M params, resuming at step "
        f"{start + 1}")

    gate = None
    if carbon_gate:
        gate = gate_plan(steps, gate_chunk, device=dev)
        log(f"carbon plan cost {gate.plan.cost} vs ASAP "
            f"{gate.plan.asap_cost}")

    losses, gnorms, secs = [], [], []
    clock = waited = 0.0
    t0 = time.time()
    for s in range(start + 1, steps):
        if gate is not None and s % gate_chunk == 0:
            wait = gate.wait_time(0, s // gate_chunk, clock)
            clock += wait
            waited += wait
        synchronize(dev)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, data.batch(s))
        synchronize(dev)
        secs.append(time.perf_counter() - t_step)
        clock += 1.0
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
        if s % log_every == 0:
            log(f"step {s:5d} loss {losses[-1]:.4f} gnorm {gnorms[-1]:.3f} "
                f"wall {time.time() - t0:.1f}s")
        if mgr is not None and s % ckpt_every == 0:
            # the manager saves a host copy (gathered, under a mesh): the
            # next step writes into these tensors
            mgr.save(state, s)
    if mgr is not None:
        mgr.wait()
    return {"start": start + 1, "losses": losses, "gnorms": gnorms,
            "step_seconds": secs, "params": n_params,
            "tokens_per_step": batch * seq, "state": state,
            "step_fn": step_fn,
            "gate": None if gate is None else {
                "cost": gate.plan.cost, "asap_cost": gate.plan.asap_cost,
                "waited": waited}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--mp", action="store_true")
    ap.add_argument("--carbon-gate", action="store_true")
    ap.add_argument("--gate-chunk", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              microbatches=args.microbatches, mp=args.mp,
              carbon_gate=args.carbon_gate, gate_chunk=args.gate_chunk,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              log_every=args.log_every)
    if args.mesh == "none":
        train(cfg, **kw)
    else:
        # the group is a rendezvous: without a card it starts on the CPU,
        # and the mesh check comes before any training
        dev = launch_mesh.init_process_group(
            None if torch.cuda.is_available() else "cpu")
        try:
            mesh = launch_mesh.make_production_mesh(
                multi_pod=args.mesh == "multi", device=dev)
            train(cfg, mesh=mesh, device=dev if dev.type == "cuda" else None,
                  **kw)
        finally:
            ctx.reset()
            torch.distributed.destroy_process_group()
    print("done")


if __name__ == "__main__":
    main()
