"""Serving driver: continuous batching over the decode step, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --requests 16 --slots 4

The flags are the reference's (``repro.launch.serve``), quirk included:
``--reduced`` is a ``store_true`` flag that defaults to true, so the CLI
always serves the reduced configuration. :func:`serve` takes any
decoder configuration (the dense, MoE, VLM, hybrid and xLSTM families),
full width included. Whisper (``family == "audio"``) is not served: its
``init_cache`` needs the encoder's length, which the continuous batcher's
``init_cache(batch_size, max_len)`` does not give, in the reference as
here, so :func:`serve` raises for it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build_model, param_count
from repro_torch.serve import ContinuousBatcher, Request


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, requests: int, slots: int, max_new: int, max_len: int,
          device=None) -> dict:
    """Serve ``requests`` random prompts (drawn as the reference's CLI draws
    them, from ``np.random.default_rng(0)``) with ``slots`` decode slots on
    a model of ``cfg`` with random parameters from seed 0.

    ``device`` None = the card (raises when there is none). Returns the
    finished requests, the parameter count, the decode steps, the tokens
    stepped (steps x slots) and the serving wall time in seconds.
    """
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the continuous batcher serves decoder families; "
            f"the encoder-decoder's cache needs the encoder length (use "
            f"EncDecModel.prefill and decode_step)")
    dev = resolve_device(device)
    model = build_model(cfg, tp=16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    batcher = ContinuousBatcher(model, batch_size=slots, max_len=max_len,
                                eos=0)
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(requests):
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(1, cfg.vocab, rng.integers(2, 8)).tolist(),
            max_tokens=max_new))
        batcher.submit(reqs[-1])
    synchronize(dev)
    t0 = time.perf_counter()
    steps = 0
    while batcher.queue or any(r is not None and not r.done
                               for r in batcher.slots):
        batcher.step()
        steps += 1
    synchronize(dev)
    return {"requests": reqs, "params": param_count(model), "steps": steps,
            "tokens": steps * slots, "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=512)
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    out = serve(cfg, args.requests, args.slots, args.max_new, args.max_len)
    dt = out["seconds"]
    print(f"{cfg.name}: {out['params'] / 1e6:.2f}M params")
    print(f"{args.requests} requests, {out['steps']} decode steps, "
          f"{dt:.1f}s ({out['tokens'] / max(dt, 1e-9):.1f} tok/s)")


if __name__ == "__main__":
    main()
