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
   taken after a warm-up that holds every launch (:func:`warm_trace`; a
   trace that lost launches is taken again behind a longer warm-up);
4. the heuristic plan: ``Planner(platform, engine="torch").plan(...)`` on
   the paper's section 6.1 matrix (72-processor small cluster, the four
   nf-core families at 2000 workflow tasks, HEFT-mapped, deadline 2x ASAP,
   the S1-S4 ensemble, all 17 variants), cold (the warm re-plan is cut);
   every schedule is validated, every -LS cost is <= its greedy cost, and
   the non-LS columns equal the port's numpy engine bitwise; the span
   split from the port's tracer and ``obs.torch_hooks.snapshot()``;
5. the cost oracle: every schedule of that plan costed through
   ``ops.carbon_cost`` on the card equals its int64 cost, and its deficit
   timeline equals numpy's bitwise; the oracle's wall time per schedule;
6. one instance re-planned on the CPU against its first ``CPU_PROFILES``
   profiles (each profile's rows are planned independently): starts and
   costs equal the card's. The re-plan runs in a spawned child process
   (no CUDA, ``CPU_THREADS`` torch threads, the matrix built anew from its
   seeds) from the start, beside the kernels' ``nvcc`` build and the
   matrix's construction, and the script waits for it before (3): no
   timed phase runs beside it;
7. that instance re-planned through the blocked longest-path form: starts
   equal the dense form's;
8. the multi-device grid (``devices=``, ``[sharded]``): (a) the visible
   devices, ``grid_mesh()`` spanning them, ``Planner(devices=k+1)``
   raising a ``ValueError`` that names ``devices``; (b) the matrix's greedy
   rows (4 x 4 x 8 combos) padded to one common bucket, through
   ``greedy_fanout_grid_torch`` unsplit and split over ``SHARDED_SHARDS``
   row shards all placed on ``cuda:0``: bitwise equal, and equal to (4)'s
   greedy starts, with both times; (c) a ``Planner(devices=
   torch.cuda.device_count())`` plan of the first ``SHARDED_PLAN``
   instances (a cut of four) against all four profiles and 17 variants,
   costs and starts bitwise equal to (4)'s;
9. the exact solver axis on small instances (``solver="exact"``, ``"ilp"``
   and ``"dp"``): the lower bounds hold against a card heuristic plan,
   ``gap() >= 1``, DP equals ILP on a processor chain, and every exact
   schedule costs the same through the kernel;
10. a ``SESSION_WINDOWS``-window rolling-horizon session
   (``planner.session``; two, a cut of three) of the
   ``eager`` instance against ``window_profile`` slices of the S1-S4
   forecasts: every window equals an eager plan of it bitwise, the
   session's gain-kernel launches equal those eager plans', and every
   schedule costs the same through the kernel;
11. the joint mapping search (``PlanRequest(mapping="search")``,
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
12. the planning service (``PlanService``, ``[service]``): (a) the first
   ``SERVICE_TICKETS`` matrix tickets (two of the four, a depth cut)
   admitted to a service with a write-ahead journal, which
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
13. the flash-attention kernels (bf16: ``wgmma`` on the tensor cores; f32:
   ``mma.sync`` TF32 on the tensor cores, every product split into three)
   against their plain version on the card at the
   reference sweep's five shapes and the bf16 twins of its four f32 shapes,
   at the model's shape (B=4, S=2048, H=16, hd=64, causal) in bf16 and f32,
   and on strided views; at the model's shape, and in bf16 at hd=128 (B=4,
   S=2048, H=8), the kernel's, the plain version's and PyTorch's
   ``scaled_dot_product_attention``'s times (in the section ``[flash]``;
   each kernel profiled by its own name, f32 bounds at a third of the TF32
   tensor-core rate beside the CUDA cores' f32 rate);
   then the row LSE of both forward kernels and the three backward stages
   (``flash_bwd_dot``, then bf16: ``flash_bwd_dkdv_wgmma`` and
   ``flash_bwd_dq_wgmma`` on the tensor cores; f32: ``flash_bwd_dkdv_tf32``
   and ``flash_bwd_dq_tf32``, split TF32) against the plain versions at the
   same shapes and the training cell's (B=8, S=256, H=16, hd=64, bf16), on
   strided views and output gradients and through the autograd Function,
   each backward bitwise equal to a second one, with the backward's times
   beside the plain backward's and SDPA's backward, also at Whisper's
   encoder (non-causal) and decoder (causal) shapes, B=1, S=1500, H=32,
   hd=64 (``FLASH_BWD_TIMED``); the f32 forward and backward are also
   timed at hd=128, at Qwen2-VL-7B's f32 gate shape (B=1, S=2048, H=32);
14. the full-width Qwen1.5-0.5B (24 layers, d_model 1024, vocab 151,936,
   bf16 activations, f32 master parameters from a seed) on the card: the
   loss of a B=4, S=2048 synthetic batch through the kernel, 24 launches
   per forward, finite and within 0.5 of ln V; the final hidden states
   against plain-attention forwards of the same parameters (f32:
   elementwise within 1e-4; bf16: within 2e-2 in relative norm, and no
   further from the f32 forward than the plain bf16 forward is); forward
   seconds cold and warm (``[model]``). The plain attention of every
   comparison is the model's CPU path on the card,
   ``layers.attention_plain_model`` (the reference model's arithmetic:
   scores and P rounded to bf16), through :func:`plain_attention`;
15. the serving path: ``repro_torch.launch.serve.serve`` at full width, 16
   requests on 4 slots, 32 new tokens, max_len 512, every request finished;
   then the forward's logits against step-by-step decode logits at full
   width in f32, B=2, S=8, within 2e-2 (``[serve]``);
16. training (``[train]``): (a) ``repro_torch.launch.train.train`` at full
   width on SmolLM-360M with the train CLI's defaults (B=8, S=256) for
   ``TRAIN_STEPS`` steps (80, a cut of its 100) and the CarbonGate: finite losses, the first within 0.5 of ln V,
   64 forward and 32 of each backward flash launch a step, cold and warm
   step seconds, tokens/s, and one profiled warm step's device busy time
   and idle share; (b) the first step's loss and gradients through the
   kernels against the plain attention (:func:`first_step`), in an f32
   copy of the config elementwise and in bf16 against the f32 gradients;
   (c) a ``RESTART_STEPS``-step run under injected failures, restarted
   from checkpoints (at least one restore from a saved checkpoint, and
   the older checkpoints deleted down to ``RESTART_KEEP``), equal to an
   uninterrupted one (tests/test_substrates.py's tolerance); (d) ``--mp``,
   one step (a cut of three):
   bf16 live parameters, the checkpoint's bf16 leaves read back bit for
   bit;
17. the other model families at full width (``[families]``): granite-moe
   (32 experts, top 8), Qwen2-VL-7B (M-RoPE over embeddings, 28 -> 32 q
   heads over 4 kv heads of 128), Jamba (one group of 8 layers: attention,
   7 Mamba, MoE of 16 experts top 2 on odd layers; the depth cut), xLSTM-125M
   and Whisper large-v3 (32 + 32 layers), one at a time, each freed before
   the next: (a) the loss of a B=1 synthetic batch (S=2048; Whisper 1,500
   frames and tokens) through the kernel, cold and warm, its bf16 hidden
   states and loss against plain attention within 2e-2 relative, one
   launch per self-attention layer and no call of the plain attention, a
   profiled warm forward (xLSTM's at S=256, ``FAMILY_PROFILE_S``: its
   S=2048 trace costs ~30 s); (b) ``launch.serve.serve`` (the MoE at the CLI's
   traffic, the others 4 requests of 8 new tokens; Whisper: ``prefill`` of
   1,500 frames and 16 greedy decode steps); (c) forward == decode in f32
   within 2e-2 (MoE at capacity factor 8); (e) peak device memory; the
   decode step under the parallel plan (:func:`mesh_decode`): the bf16
   model's own parameters placed on a (data=1, model=1) mesh over
   one-process NCCL and ``MESH_DECODE_STEPS`` greedy steps from a filled
   cache placed by ``cache_specs`` (``MESH_DECODE_PROMPT`` decode steps of
   seed tokens at B=``MESH_DECODE_B``; Whisper: its prefill, B=1), the
   logits and every cache leaf bitwise equal to the unsharded steps after
   each step (granite-moe under each of its three dispatches), the ms a
   step of each printed; then (d) the kernel at their new shapes (non-causal S=1500, H=32, hd=64;
   causal S=1500, H=32, hd=64; causal S=2048, H=32, hd=128) against the
   plain version, with its time, bound and SDPA's time;
18. the families' training at full width (``[train-families]``):
   ``launch.train.train`` on granite-moe (B=8, S=256, 6 steps: the MoE
   backward), Whisper large-v3 (B=1, 1,500 frames and 1,500 tokens, 6
   steps: the non-causal and causal flash backward at S=1500) and
   xLSTM-125M (B=8, S=256, 3 steps: the recurrences' backward), each with
   its f32 parameters, gradients and AdamW moments on the card: finite
   losses, the first within 0.5 of ln V, exactly 2 forward flash launches
   and 1 of each backward stage per self-attention layer a step, cold and
   warm step seconds, tokens/s, a profiled warm step, peak memory; the
   first step's gradients through the kernels against the plain model
   attention by (16) (b)'s rule, an MoE's recompute routing bitwise equal
   to its forward's (:func:`first_step`). Qwen2-VL and Jamba do not fit
   one card with AdamW in f32: the CPU tests hold their training. Then (d)
   the families under the reference's parallel plan
   (:func:`phase_mesh_families`): granite-moe under each of its three MoE
   dispatches, Whisper and xLSTM at full width, Jamba and Qwen2-VL at the
   CPU tests' reduced widths (``MESH_FAMILY_REDUCED``), each in f32 through
   ``train(mesh=)`` on a (data=1, model=1) mesh over one-process NCCL and
   through ``loss_and_grads`` on the placed parameters: the loss and every
   gradient leaf's bits (:func:`bits_fingerprint`) equal to the unsharded
   f32 kernel pass of the same config, seed and batch ((c)'s; the MoE's
   routings replayed as there), its flash launches the path
   ``mesh_families``. (a) runs granite-moe and Whisper 6 steps (a cut of
   10; the warm median over 5);
19. the roofline (``[roofline]``): each of the eleven steps timed above
   (the Qwen1.5 loss forward and decode step, the SmolLM step, the five
   family forwards, the three family steps) counted by the port's dry run
   (``launch.dryrun.trace_step`` on the meta device, at the step's config,
   shape and dtype, self-attention as the flash kernels' work; nothing is
   launched, and the counting, which needs no reading, runs while (6)'s
   child process does, within ``ROOFLINE_SECONDS``): FLOPs, bytes, the
   bound on one H100 (``roofline.analysis.H100``; its dominant term) and
   its share of the warm wall time and of the profiled busy time, each at
   most ``ROOFLINE_SHARE_MAX``; the step's arguments plus temporaries
   against its measured peak memory, within 2x;
20. the port's four examples (``[examples]``, ``repro_torch.examples``),
   each through its ``main(argv)`` with no ``--device``, within
   ``EXAMPLES_SECONDS`` in all, held to the reference examples' output
   on the CPU: (a) quickstart's cost table, every -LS cost at or below its
   greedy cost, the exact audit's optimum; (b) the fleet's robust variants
   and worst-member costs, its joint mapping search and three rolling
   windows (through the gain kernel); (c) serve at its defaults: the
   admission plan, the coalescing, the degradation to asap, a JSONL trace
   of every span under ``chiprun_out/``, every request finished; (d)
   train on the example's 100M config at full width, 80 steps (a cut of
   120) with injected failures: the plan, the waits, one restart, the
   simulated clock, finite losses, the last below the first (through the
   f32 flash forward and backward);
21. training under the parallel plan (``[mesh]``): ``launch.train.train``
   with ``mesh=`` a (data=1, model=1) mesh over a one-process NCCL group
   (DTensor over a ``DeviceMesh``; the attention's flash kernels on local
   shards), SmolLM-360M at full width, B=8, S=256: an f32 copy of the
   config, ``MESH_STEPS`` steps, losses and gradient norms against the
   unsharded step of the same model within 1e-5, the first step's
   gradients within 1e-4 / 1e-5, 64 forward and 32 of each backward f32
   flash launch a step; then ``MESH_STEPS`` bf16 steps over f32 masters at
   [train]'s TP of 16, their warm step beside [train]'s (the cost of
   DTensor dispatch; no profiled step, a depth cut); then the decode
   sub-step of (17) on the bf16 SmolLM-360M at TP 16. Before them, the
   local shards of a microbatch whose rows do not split evenly over the
   batch axes: the bf16 and f32 flash forward and backward on an empty
   shard ([0, S, H, hd]: no launch, the plain version's empty outputs and
   gradients) and on a one-row shard (the kernels, against the plain
   version) at SmolLM-360M's attention shape.

Each path (4, 5, 8, 9, 10, 11, 12, 14, 15, 16, 17, 18, 20, 21) is driven
with the kernels' launch counts set to 0 just before it and read just
after; a kernel the path runs that was never launched fails the run. f32
matrix products on the card run in full f32: TF32 is switched off for
matmuls and cuDNN before any phase (the f32 flash kernels' split TF32 is their
own arithmetic and reads no such flag). The line before the last is a
JSON object with one entry per kernel, the f32 flash forward and backward
apart from the bf16 ones: the bf16 kernels' launches are their main
paths', the f32 kernels' those of the f32 checks beside them
(``[model]``'s and ``[families]``' f32 gates, ``[serve]``'s forward ==
decode check, the first steps' f32 kernel passes) and of the train
example's, ``[mesh]``'s and ``[train-families]`` (d)'s
(``mesh_families``) f32 runs, each under its own key; every kernel
an example launched has an ``examples`` count among its paths; the last
line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
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
MAPPING_TASKS = 500      # workflow tasks of the [mapping] cell (depth cut)
CPU_PROFILES = 1         # profiles of the [cpu] re-plan (a cut of the four)
# the [cpu] re-plan's torch threads in its child process: all cores but two,
# which the card's host thread keeps meanwhile
CPU_THREADS = max(1, (os.cpu_count() or 1) - 2)
SERVICE_TICKETS = 2      # matrix tickets [service] (a) replays (a cut of 4)
SESSION_WINDOWS = 2      # [session] windows (a cut of 3; rolling needs two)
SHARDED_SHARDS = 2       # [sharded] (b): row shards of the split run
SHARDED_PLAN = 2         # [sharded] (c): matrix instances planned (of 4)
PROFILE_OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.txt")
ROOFLINE_OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke_roofline.json")

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
# the forward kernel each input type launches (the name the profiler shows)
FWD_KERNEL_NAMES = {"bfloat16": "flash_fwd_kernel_wgmma",
                    "float32": "flash_fwd_kernel_tf32"}
# timed shapes (B, S, H, hd, dtype): the model's in bf16 and f32, bf16 at
# hd=128, and f32 at hd=128 at Qwen2-VL-7B's shape in [families]' f32 gate
# (the B=1, S=2048 forward, 28 heads padded to 32)
FLASH_TIMED = {"bfloat16": (MODEL_B, MODEL_S, 16, 64, "bfloat16"),
               "float32": (MODEL_B, MODEL_S, 16, 64, "float32"),
               "bfloat16_hd128": (MODEL_B, MODEL_S, 8, 128, "bfloat16"),
               "float32_hd128": (1, 2048, 32, 128, "float32")}
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
# flash backward kernels vs attention_bwd_plain on the same (o, lse): in f32
# the two differ only in the order of f32 sums (measured below 1e-6):
# elementwise allclose at BWD_F32_TOL; in bf16 the gradients round to bf16
# once, from f32 sums in another order: relative Frobenius norm within the
# sweep's bf16 tolerance. The LSE of both forward kernels against the plain
# version's torch.logsumexp of its scores, absolute (values ~ ln S + |s|)
BWD_F32_TOL = 1e-4
LSE_TOL = 1e-4
# [train]: the train CLI's defaults at full width (launch/train.py)
TRAIN_ARCH = "smollm-360m"
# 80 steps: a cut of the CLI's 100, which pays for the decode sub-steps
TRAIN_STEPS, TRAIN_B, TRAIN_S = 80, 8, 256
# the backward's timed shapes (B, S, H, hd, causal, dtype): FLASH_TIMED's
# (causal), the training cell's (16 heads of 64 after head_plan, causal,
# bf16), where the kernels run 3,200 times a [train] run, and Whisper's
# encoder (non-causal) and decoder (causal) at 1,500 positions and 20 heads
# padded to 32, where [train-families] runs them
FLASH_BWD_TIMED = {
    **{k: (B, S, H, hd, True, dt) for k, (B, S, H, hd, dt)
       in FLASH_TIMED.items()},
    "bfloat16_train": (TRAIN_B, TRAIN_S, 16, 64, True, "bfloat16"),
    "whisper_encoder": (1, 1500, 32, 64, False, "bfloat16"),
    "whisper_decoder": (1, 1500, 32, 64, True, "bfloat16"),
}
RESTART_STEPS = 8            # (c): tests/test_substrates.py's resume case
RESTART_EVERY = 2            # (c): a checkpoint every 2 steps (4 saves)
RESTART_KEEP = 2             # (c): checkpoints kept (so 2 are deleted)
RESTART_RTOL, RESTART_ATOL = 1e-5, 1e-6    # that test's tolerance
MP_STEPS = 1                 # (d): --mp, one step, its checkpoint (a cut of 3)
# [mesh]: the train step under the parallel plan (DTensor over a DeviceMesh,
# one process a mesh position) at [train]'s batch: one process, NCCL, mesh
# (data=1, model=1), full width. Four processes sharing cuda:0 over gloo
# do not run on the card's torch: DTensor's all-gather (a functional
# collective) dies with SIGSEGV there (PERF.md section 7)
MESH_STEPS = 3
# against the unsharded step of the same model: tests/test_torch_train.py's
# LOSS_RTOL (loss and gradient norm per step) and GRAD_RTOL / GRAD_ATOL (the
# first step's gradients; atol a fraction of the leaf's largest magnitude)
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_RTOL, MESH_GRAD_ATOL = 1e-4, 1e-5
# (b) first step, kernel vs plain attention, f32 copy of the config: the
# loss and the gradients differ only by the order of f32 sums in the two
# attentions, carried through 32 layers: elementwise
# |g - g_plain| <= F32_GRAD_TOL (|g_plain| + max |g_plain| of the leaf).
# In bf16 any two pipelines that round in other places differ by more than
# the sweep's 2e-2: at the first step the plain bf16 gradients are 1.5-3.7%
# from the f32 gradients (relative norm per leaf), and the kernels' and the
# plain version's 1.4-3.4% from each other (measured on one H100: the P the bf16
# forward rounds to bf16 moves every activation downstream). So, as the
# [model] check holds the bf16 forward, each leaf of the kernels' bf16
# gradient must be no further from the f32 gradient (plain attention, f32
# config, same parameters and batch) than the plain bf16 gradient is,
# within BF16_MODEL_SLACK; the loss within BF16_MODEL_TOL
F32_GRAD_TOL = 1e-4
# a key bias's gradient is zero in exact arithmetic (first_step): both paths'
# gradients there must stay below this fraction of the largest leaf's norm
# (bf16 rounding noise: ~3e-5 of it at reduced size on the CPU)
ZERO_GRAD_TOL = 1e-3
# [families]: (sequence length of the B=1 forward, serve traffic: requests,
# slots, max_new, max_len) a configuration, at full width (family_config);
# the MoE takes the serve CLI's traffic, the others a shorter mix to hold
# the time budget; Whisper is not served by the batcher (its prefill and
# WHISPER_DECODE_STEPS greedy steps instead)
FAMILY_CELLS = {
    "granite-moe-1b-a400m": (2048, (16, 4, 32, 512)),
    "qwen2-vl-7b": (2048, (4, 4, 8, 512)),
    "jamba-v0.1-52b": (2048, (4, 4, 8, 512)),
    "xlstm-125m": (2048, (4, 4, 8, 512)),
    "whisper-large-v3": (1500, None),
}
WHISPER_DECODE_STEPS = 16
# the profiled warm forward of (a) at a shorter sequence where the full one
# costs more trace than it teaches: xLSTM's S=2048 forward is ~75k launches
# (~30 s of trace); 256 positions keep every kind of launch
FAMILY_PROFILE_S = {"xlstm-125m": 256}
# [train-families]: (batch, sequence, steps) of launch.train.train at full
# width a configuration: granite-moe at the train CLI's B=8, S=256 (6 of
# its 100 steps: a cut, 10 before [train-families] (d) came), Whisper at one
# 30-s window (1,500 frames and 1,500 decoder tokens, 6 steps, 10 before),
# xLSTM at the CLI's traffic for 3 steps (its step is host-bound); each
# holds params, gradients and both AdamW moments in f32
TRAIN_FAMILY_CELLS = {
    "granite-moe-1b-a400m": (8, 256, 6),
    "whisper-large-v3": (1, 1500, 6),
    "xlstm-125m": (8, 256, 3),
}
# [train-families] (d): the families under the parallel plan, f32, on a
# (data=1, model=1) mesh over one-process NCCL: the first step through
# train(mesh=) and the placed gradients held bitwise to the unsharded f32
# kernel pass of the same config, seed and batch (c) keeps (a (1, 1) mesh
# reduces nothing); the MoE under each dispatch. Qwen2-VL and Jamba train
# at full width only on four cards: they run at the CPU tests' reduced
# widths (tests/test_torch_mesh_moe.py: reduced, head_dim 64, the flash
# kernels' smallest, B=4, S=32) against their own unsharded f32 kernel pass
MESH_FAMILY_DISPATCHES = ("global", "sharded", "shardmap")
MESH_FAMILY_REDUCED = {"jamba-v0.1-52b": {"head_dim": 64},
                       "qwen2-vl-7b": {"head_dim": 64,
                                       "mrope_sections": (8, 12, 12)}}
MESH_FAMILY_REDUCED_CELL = (4, 32)
# the decode step under the parallel plan ([families] and [mesh] decode
# sub-steps): the model's own parameters placed on a (data=1, model=1) mesh
# over one-process NCCL (its own tensors: nothing copied), its cache placed by
# cache_specs from a cache the unsharded steps filled (MESH_DECODE_PROMPT
# decode steps of seed tokens; Whisper: its prefill), then
# MESH_DECODE_STEPS greedy steps each sharded and unsharded: the logits and
# every cache leaf bitwise equal after every step (a (1, 1) mesh reduces
# nothing, as [train-families] (d) shows for training); B rows
MESH_DECODE_STEPS = 3
MESH_DECODE_PROMPT = 4
MESH_DECODE_B = 4
# the step counts [train-families] (a) ran before (d) came and the cut to
# TRAIN_FAMILY_CELLS' 6 (granite-moe and Whisper), for the saving it prints
TRAIN_FAMILY_STEPS_BEFORE = {"granite-moe-1b-a400m": 10,
                             "whisper-large-v3": 10}
# the profiled warm step at a shorter sequence: xLSTM's S=256 step is ~40k
# launches, whose trace costs ~18 s; 64 positions keep every kind of launch
TRAIN_FAMILY_PROFILE_S = {"xlstm-125m": 64}
# (d) the flash kernel at the shapes the families give it (B, S, H, hd,
# causal): Whisper's encoder (bidirectional, S=1500 frames, 20 heads padded
# to 32) and decoder, Qwen2-VL's and Jamba's attention (32 q heads of 128)
FLASH_FAMILY_SHAPES = {
    "whisper_encoder": (1, 1500, 32, 64, False),
    "whisper_decoder": (1, 1500, 32, 64, True),
    "hd128_h32": (1, 2048, 32, 128, True),
}
# [roofline]: a step's least time on the card over its measured time is at
# most 1 when the count is right (a little over on the host clock's noise);
# the dry run's peak memory within 2x of the measured one either way; the
# counting (on the meta device, nothing launched) within 30 s
ROOFLINE_SHARE_MAX = 1.05
ROOFLINE_PEAK_RATIO = 2.0
ROOFLINE_SECONDS = 30.0
# [examples]: the port's four examples (repro_torch.examples), each called
# through its main(argv) on the card, within EXAMPLES_SECONDS in all. The
# values they must show are the reference examples' own output on the CPU:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python examples/quickstart.py
#   JAX_PLATFORMS=cpu PYTHONPATH=src python examples/fleet_scheduler.py
#   JAX_PLATFORMS=cpu PYTHONPATH=src python examples/serve_batched.py
#   JAX_PLATFORMS=cpu PYTHONPATH=src python examples/train_carbon_aware.py \
#       --steps 80 --chunk 20 --batch 2 --seq 32 --inject-failure
# (the train example's plan, waits, restarts and clock do not depend on the
# model's size or the batch). The fleet reads no dry-run record (a checkout
# holds none): every job takes the 1-s fallback, as in those runs.
EXAMPLES_SECONDS = 120.0
EXAMPLES_TRACE = os.path.join(ROOT, "chiprun_out",
                              "examples_serve_trace.jsonl")
QUICKSTART_ASAP = 17966
QUICKSTART_COSTS = {
    "slack": 154, "slack-LS": 154, "slackR": 0, "slackR-LS": 0,
    "slackW": 1145, "slackW-LS": 689, "slackWR": 1145, "slackWR-LS": 689,
    "press": 308, "press-LS": 308, "pressR": 264, "pressR-LS": 264,
    "pressW": 308, "pressW-LS": 286, "pressWR": 44, "pressWR-LS": 44}
QUICKSTART_OPTIMUM = 1101
# fleet: (robust variant, its worst-member cost, ASAP's worst) per fleet
FLEET_ROBUST = {"train-heavy": ("press-LS", 11168470, 58483778),
                "mixed-serve": ("press-LS", 41010010, 70932450)}
FLEET_JOINT = {"fixed": 8103099, "searched": 5513727, "candidates": 15,
               "rounds": 2, "winner": "r1:swap"}
FLEET_WINDOWS = [("press-LS", 26099599), ("press-LS", 10541339),
                 ("pressR-LS", 31701720)]
# serve at its defaults (12 requests, 4 slots, 24 new tokens)
SERVE_ADMISSION = {"chunks": 3, "cost": 4286, "asap_cost": 8174,
                   "starts": [19, 24, 29], "coalesced": 4, "batches": 2,
                   "fallback_stage": "asap", "spans": 26}
# train: the example's real config at full width, 80 steps (a cut of 120)
TRAIN_EXAMPLE_ARGV = ["--model-size", "100m", "--steps", "80", "--chunk",
                      "20", "--inject-failure"]
TRAIN_EXAMPLE_PLAN = (34570, 75990)          # cost, ASAP cost
TRAIN_EXAMPLE_WAITS = [(0, 100.0)]           # (chunk, simulated seconds)
TRAIN_EXAMPLE_END = (80, 1, 180.0)           # steps, restarts, clock


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


def h100_rates() -> tuple[float, float, float]:
    """One H100 SXM5's published rates, from the port's roofline specs
    (``repro_torch.roofline.analysis``): HBM bytes/s, f32 FLOP/s outside
    the tensor cores, dense bf16 tensor-core FLOP/s."""
    from repro_torch.roofline.analysis import H100, H100_F32

    return H100.hbm_bw, H100_F32.peak_flops, H100.peak_flops


def flash_rate(dtype, f32_on="tensor_cores") -> float:
    """The FLOP/s an attention product of ``dtype`` is bounded by: bf16 at
    the tensor cores' bf16 peak; f32 as the f32 kernels run it, three TF32
    products on the tensor cores (a third of
    ``roofline.analysis.H100_TF32``'s rate: the least time of f32-accurate
    products on this card), or with ``f32_on="cuda_cores"`` at the f32 peak
    outside the tensor cores."""
    from repro_torch.roofline.analysis import H100_TF32

    _, f32, bf16 = h100_rates()
    if dtype == "bfloat16":
        return bf16
    return H100_TF32.peak_flops / 3 if f32_on == "tensor_cores" else f32


def step_peak(fn, dev, resident: int = 0):
    """``fn()``, the device memory its run peaked at, and the running peak
    before it: the most allocated while it ran, less what was allocated
    before it that is not the step's own (``resident`` bytes of that were
    its arguments: a forward's model). The running peak restarts at
    ``fn``: a later reading takes the larger of the two."""
    import gc

    import torch

    gc.collect()      # an earlier phase's garbage, freed before, not during
    prev = torch.cuda.max_memory_allocated(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    return out, torch.cuda.max_memory_allocated(dev) - base + resident, prev


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


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


def warm_trace(run, warmup: int = 1):
    """``torch.profiler`` over one call of ``run()``, taken the way every
    time in this script is: ``warmup`` warm-up steps of ``run()`` while the
    profiler starts, then the recorded step. A trace started cold loses
    launches, more the longer the process has run since its first trace
    (``chip_profiler_probe.py --drift``); one started a step earlier keeps
    them all, and where one step is not enough a longer warm-up is
    (:data:`TRACE_WARMUPS`). Returns the profiler and the host wall seconds
    of the recorded ``run()``, ending in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=1,
                                   repeat=1)) as prof:
        for _ in range(warmup + 1):
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
    ``fn``; None when the profiler records no device time for it."""
    return profiled_kernels_ms(fn, reps, (kernel,), out_path)[kernel]


# warm-up steps of the successive traces :func:`profiled_kernels_ms` takes:
# a trace that lost launches is taken again behind a longer warm-up
TRACE_WARMUPS = (1, 4, 16)


def profiled_kernels_ms(fn, reps: int, kernels, out_path: str) -> dict:
    """Mean device milliseconds of each CUDA kernel whose name contains one
    of ``kernels``, each launched once a call, from one :func:`warm_trace`
    of ``reps`` warm calls of ``fn``; None for a kernel the profiler
    records no device time for. A time comes only from a trace that holds
    all ``reps`` launches: a trace that holds fewer is taken again behind
    the next, longer warm-up of :data:`TRACE_WARMUPS`, and when the last
    one still holds fewer the run fails. The profilers' tables go to
    ``out_path``."""
    import torch

    fn()
    torch.cuda.synchronize()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    for warmup in TRACE_WARMUPS:
        prof, _ = warm_trace(lambda: [fn() for _ in range(reps)], warmup)
        avgs = prof.key_averages()
        with open(out_path, "a") as f:
            f.write(avgs.table(row_limit=20) + "\n")
        totals = {}
        for kernel in kernels:
            total_us, count = 0.0, 0
            for ev in avgs:
                if kernel in ev.key:
                    total_us += float(getattr(ev, "device_time_total", 0.0)
                                      or getattr(ev, "cuda_time_total", 0.0))
                    count += ev.count
            log(f"[profiler] {kernel}: the trace behind {warmup} warm-up "
                f"step(s) holds {count} of {reps} launches")
            totals[kernel] = (total_us, count)
        if all(count in (0, reps) for _, count in totals.values()):
            break
    out = {}
    for kernel, (total_us, count) in totals.items():
        if count == 0 or total_us <= 0.0:
            out[kernel] = None
            continue
        check(count == reps, f"the profiler's trace holds {count} launches "
              f"of {kernel}, expected {reps}, behind {warmup} warm-up steps")
        out[kernel] = total_us / count / 1e3
    return out


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
        if "flash_fwd_kernel" in name or "flash_bwd_" in name:
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
    hbm, f32, _ = h100_rates()
    t_bytes, t_ops = nbytes / hbm, ops / f32
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
    hbm, f32, _ = h100_rates()
    t_bytes = 4 * (3 * N + 2 * T) / hbm
    t_ops = (2 * N + 3 * T) / f32
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
    # no warm re-plan (a cut, PERF.md section 4): [sharded] (c) and
    # [service] (a) plan the matrix again on the card, held to this plan
    I, P, V = cold.costs.shape
    check((I, P, V) == (len(insts), len(SCENARIOS), 17),
          f"cost tensor shape {cold.costs.shape}")
    log(f"[plan] I x P x V = {I} x {P} x {V}, engine={cold.engine}; cold "
        f"{cold_s:.3f} s; gain_scan launches {launches}")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in
                       cold.phase_seconds.items())
    log(f"[plan] cold split (s): {phases}")
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
    return cold, launches, cold_s


def cpu_replan(i, threads):
    """Instance ``i`` of the matrix (built here from its seeds, quietly)
    planned on the CPU against its first ``CPU_PROFILES`` profiles with
    ``threads`` torch threads: (costs [P, V], starts per profile by
    variant, plan seconds). Runs in :func:`start_cpu`'s child process."""
    import io

    import torch

    from repro_torch.api import Planner, PlanRequest

    torch.set_num_threads(threads)
    with contextlib.redirect_stdout(io.StringIO()):
        plat, insts, grid = build_matrix()
    t0 = time.perf_counter()
    res = Planner(plat, engine="torch", device="cpu").plan(
        PlanRequest(instances=insts[i], profiles=grid[i][:CPU_PROFILES]))
    secs = time.perf_counter() - t0
    starts = [{n: r.start for n, r in cell.items()} for cell in res.results[0]]
    return res.costs[0], starts, secs


def start_cpu(i):
    """Start ``[cpu]``'s re-plan of instance ``i`` in a spawned child (a
    fresh process that never touches CUDA), to run while the kernels
    build; :func:`wait_cpu` joins it before any timed phase and
    :func:`phase_cpu` checks it after ``[plan]``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(cpu_replan, i, CPU_THREADS), time.perf_counter()


def wait_cpu(job):
    """The child's result, once it has ended, and how long it ran and how
    long this waited for it."""
    pool, fut, t_start = job
    t0 = time.perf_counter()
    try:
        out = fut.result()
    finally:
        pool.shutdown()
    t1 = time.perf_counter()
    return out, t1 - t_start, t1 - t0


def phase_cpu(cpu_run, grid, card, i):
    """Instance ``i`` re-planned on the CPU against its first
    ``CPU_PROFILES`` profiles (:func:`start_cpu`): each must equal the
    card's plan bitwise."""
    import numpy as np

    (costs, starts, secs), ran, waited = cpu_run
    n_prof = len(starts)
    check(np.array_equal(costs, card.costs[i][:n_prof]),
          "CPU costs differ from the card's")
    for p, cell in enumerate(starts):
        check(cell.keys() == card.results[i][p].keys(),
              f"CPU variants differ from the card's: profile {p}")
        for n, start in cell.items():
            check(np.array_equal(start, card.results[i][p][n].start),
                  f"CPU starts differ from the card's: {n}, profile {p}")
    log(f"[cpu] {KINDS[i]} re-planned on the CPU against {n_prof} of its "
        f"{len(grid[i])} profiles in {secs:.3f} s ({CPU_THREADS} torch "
        f"threads, in a child process that ran {ran:.3f} s beside the "
        f"kernels' build; the script waited {waited:.3f} s for it): "
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


def common_bucket_rows(plat, insts, grid, names, dev):
    """Every instance's greedy rows (all profiles, every non-asap combo of
    ``names``) padded to ONE shape bucket, the largest (Np, Tp) of the
    matrix: its own buckets hold one instance each, so only a common
    bucket gives the instance axis rows to split. Padding is
    output-invariant (padded tasks are zero-width and placed last, padded
    units never feasible). Returns (rows, combos)."""
    from repro_torch.api import Planner
    from repro_torch.core.greedy_torch import pad_dims
    from repro_torch.core.portfolio import (_needed_combos, bucket_row,
                                            overlay_profile)

    need = _needed_combos(names)
    rvals = tuple(sorted({r for (_, _, r) in need}))
    Np = max(pad_dims(x.num_tasks, 1)[0] for x in insts)
    Tp = max(pad_dims(1, ps[0].T)[1] for ps in grid)
    planner = Planner(plat, engine="torch", device=dev)
    rows = []
    for inst, ps in zip(insts, grid):
        g = planner.prepared(inst, ps[0].T)
        ovs = [overlay_profile(g, p, refined_values=rvals) for p in ps]
        rows.append(bucket_row(g, ovs, need, Tp, dev, Np=Np))
    return rows, need


def phase_sharded(plat, insts, grid, card, dev):
    """The multi-device grid (``devices=``) on the card: (a) the visible
    devices and the knob's validation; (b) the matrix's greedy rows in one
    common bucket through ``greedy_fanout_grid_torch`` split over
    ``SHARDED_SHARDS`` shards all placed on ``dev``, bitwise equal to the
    unsplit run and to the ``[plan]`` phase's greedy starts; (c) a
    ``Planner(devices=torch.cuda.device_count())`` plan of the first
    ``SHARDED_PLAN`` instances, bitwise equal to ``card``'s rows."""
    import numpy as np
    import torch

    from repro_torch.api import Planner, PlanRequest
    from repro_torch.core.cawosched import VARIANTS_BY_NAME
    from repro_torch.core.greedy_torch import greedy_fanout_grid_torch
    from repro_torch.kernels import gain_scan
    from repro_torch.sharding import ctx

    t_phase = time.perf_counter()
    k = torch.cuda.device_count()
    visible = ctx.visible_devices()
    mesh = ctx.grid_mesh()
    check(mesh.size == len(visible) == k,
          f"grid_mesh() spans {mesh.size} of {k} devices")
    try:
        Planner(plat, engine="torch", devices=k + 1)
    except ValueError as e:
        check("devices" in str(e), f"Planner(devices={k + 1}) raised "
              f"without naming devices: {e}")
        refusal = str(e)
    else:
        raise SmokeFailure(f"Planner(devices={k + 1}) did not raise with "
                           f"{k} visible")
    log(f"[sharded] (a) visible devices {[str(d) for d in visible]}; "
        f"grid_mesh() {mesh.shape}; Planner(devices={k + 1}) raises "
        f"ValueError: {refusal}")

    t0 = time.perf_counter()
    rows, need = common_bucket_rows(plat, insts, grid, card.variants, dev)
    rows_s = time.perf_counter() - t0
    split = ctx.make_mesh((SHARDED_SHARDS,), ("data",),
                          [dev] * SHARDED_SHARDS)
    whole, whole_s = timed(lambda: greedy_fanout_grid_torch(rows,
                                                            device=dev))
    parts, parts_s = timed(lambda: greedy_fanout_grid_torch(rows,
                                                            mesh=split))
    check(torch.equal(whole, parts), "split greedy starts != unsplit")
    whole = whole.cpu().numpy()
    n_cmp = 0
    for i, inst in enumerate(insts):
        for p in range(len(grid[i])):
            for name in card.variants:
                if name == "asap" or name.endswith("-LS"):
                    continue
                v = VARIANTS_BY_NAME[name]
                ci = need.index((v.score, v.weighted, v.refined))
                check(np.array_equal(whole[i, p, ci, :inst.num_tasks],
                                     card.results[i][p][name].start),
                      f"common-bucket greedy starts != [plan]'s: {name}, "
                      f"instance {i}, profile {p}")
                n_cmp += 1
    I, P, V, Np = whole.shape
    log(f"[sharded] (b) {I} x {P} x {V} greedy rows in one ({Np}, "
        f"{rows[0][3].shape[1]}) bucket (rows built in {rows_s:.3f} s): "
        f"unsplit {whole_s:.3f} s, {SHARDED_SHARDS} shards on {dev} "
        f"{parts_s:.3f} s; bitwise equal, and {n_cmp} greedy schedules "
        f"equal [plan]'s")

    planner = Planner(plat, engine="torch", devices=k)
    request = PlanRequest(instances=insts[:SHARDED_PLAN],
                          profiles=grid[:SHARDED_PLAN])
    gain_scan.LAUNCHES = 0
    res, plan_s = timed_plan(planner, request)
    launches = gain_scan.LAUNCHES
    check(launches > 0, "the devices= plan did not launch gain_scan")
    check(np.array_equal(res.costs, card.costs[:SHARDED_PLAN]),
          "devices= plan costs != [plan]'s")
    for i in range(SHARDED_PLAN):
        for p in range(len(grid[i])):
            for name in res.variants:
                check(np.array_equal(res.results[i][p][name].start,
                                     card.results[i][p][name].start),
                      f"devices= plan starts != [plan]'s: {name}, "
                      f"instance {i}, profile {p}")
    secs = time.perf_counter() - t_phase
    log(f"[sharded] (c) Planner(devices={k}) plan of {SHARDED_PLAN} x "
        f"{len(grid[0])} x {len(res.variants)}: {plan_s:.3f} s, costs and "
        f"starts equal [plan]'s bitwise; gain_scan launches {launches}; "
        f"greedy {res.phase_seconds.get('greedy', 0.0):.3f} s")
    log(f"[sharded] phase {secs:.3f} s")
    return {"gain_scan": launches, "unsplit_s": whole_s, "split_s": parts_s,
            "plan_s": plan_s, "seconds": secs}


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
    """A ``SESSION_WINDOWS``-window rolling-horizon session on the card
    against eager plans of the same windows."""
    import numpy as np

    from repro_torch.api import Planner, PlanRequest, window_profile
    from repro_torch.core import deadline_from_asap, generate_profile
    from repro_torch.kernels import carbon_cost, gain_scan

    W = deadline_from_asap(inst, FACTOR)
    cap = work_capacity(inst)
    n = SESSION_WINDOWS
    forecasts = [generate_profile(s, n * W, plat, J=n * J,
                                  seed=PROFILE_SEED, work_capacity=cap)
                 for s in SCENARIOS]
    windows = [[window_profile(f, k * W, W) for f in forecasts]
               for k in range(n)]
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
    with planner.session(inst, windows, n_windows=n) as sess:
        for k in range(n):
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
    log(f"[session] eager N_c={inst.num_tasks}, {n} windows of {W} units x "
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
    request = PlanRequest(instances=wf, profiles=forecasts, mapping="search",
                          deadline_scale=FACTOR,
                          mapping_options=opts.to_dict())
    # the seed round is profiled on the card (its idle share) while the
    # tracer times every span of the search. A profiler trace can lose
    # launches behind its warm-up step (PERF.md section 7): a trace short
    # of one is taken once more, by the same search on a fresh planner
    for attempt in range(2):
        planner = Planner(plat, engine="torch")
        tracer = round_profiler(0)
        prev = obs.set_tracer(tracer)
        gain_scan.LAUNCHES = carbon_cost.LAUNCHES = 0
        try:
            res, secs = timed_plan(planner, request)
        finally:
            obs.set_tracer(prev)
        busy_ms, kernels = tracer.busy()
        seen = sum(c for k, c in kernels.items() if "gain_scan_kernel" in k)
        if seen == tracer.launches:
            break
        log(f"[mapping] the seed round's trace holds {seen} of its "
            f"{tracer.launches} gain_scan launches: profiled again")
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
    """[service] (a): the first ``SERVICE_TICKETS`` matrix tickets admitted
    to a journaled service that is killed before it serves them; a second
    service on the same journal replays them as one coalesced batch,
    bitwise equal to the cold plan's rows, with nothing degraded."""
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.api import Planner, PlanRequest
    from repro_torch.serve import PlanService, TicketJournal

    n_tickets = SERVICE_TICKETS
    insts, grid = insts[:n_tickets], grid[:n_tickets]
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
    check(stats["batches"] == 1
          and stats["coalesced_requests"] == n_tickets,
          f"[service] replay ran {stats['batches']} batches of "
          f"{stats['coalesced_requests']} tickets, not one of {n_tickets}")
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
    log(f"[service] (a) {n_tickets} matrix tickets journaled, the service "
        f"killed, replayed by a second service (workers=2): {secs:.3f} s "
        f"from its start to the last delivery ([plan] cold {cold_s:.3f} "
        f"s); batches {stats['batches']}, coalesced requests "
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


def flash_bound_ms(B, S, H, hd, causal, dtype,
                   f32_on="tensor_cores") -> tuple[float, str]:
    """Least time for one attention pass: q, k, v read once and the output
    written once, against the flops of QK^T and PV over the keys each query
    sees (the lower triangle when causal), at :func:`flash_rate`."""
    esize = 2 if dtype == "bfloat16" else 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    hbm = h100_rates()[0]
    rate = flash_rate(dtype, f32_on)
    t_bytes = 4 * B * S * H * hd * esize / hbm
    t_ops = flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bwd_bound_ms(B, S, H, hd, causal, dtype,
                       f32_on="tensor_cores") -> tuple[float, str]:
    """Least time for one attention backward: q, k, v, o, dO read once,
    the row LSE read once, dq, dk, dv written once, against the flops of
    its five products (QK^T, dO V^T, P^T dO, dS^T Q, dS K) over the pairs
    each query sees, at :func:`flash_rate`."""
    esize = 2 if dtype == "bfloat16" else 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 5 * 2 * B * H * hd * pairs
    hbm = h100_rates()[0]
    rate = flash_rate(dtype, f32_on)
    t_bytes = (8 * B * S * H * hd * esize + 4 * B * H * S) / hbm
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


def flash_row(dev, B, S, H, hd, causal, dt) -> dict:
    """The forward kernel at one shape: checked against the plain version
    (allclose at the sweep's tolerance), then its device time (profiler,
    else a CUDA-graph replay) beside its eager CUDA-event time, the plain
    version's, PyTorch's ``scaled_dot_product_attention``'s and the
    bound."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(B, S, H, hd, dt, seed=B * S + H, dev=dev)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention(q, k, v, causal=causal, mode="plain")
    err = close_err(got, want, FLASH_TOL[dt])
    shape = (f"B={B} S={S} H={H} hd={hd} "
             f"{'causal' if causal else 'non-causal'} {dt}")
    check(bool(torch.isfinite(got).all()) and err <= FLASH_TOL[dt],
          f"flash kernel != plain ({shape}): {err} > {FLASH_TOL[dt]}")
    max_err = float((got.float() - want.float()).abs().max())

    def kernel():
        fa.flash_attention(q, k, v, causal=causal)

    reps = 50
    event_ms = cuda_ms(kernel, reps=reps)
    replay_ms = graph_ms(kernel, reps=reps)
    device_ms = profiled_ms(kernel, reps, FWD_KERNEL_NAMES[dt], PROFILE_OUT)
    plain_ms = cuda_ms(lambda: fa.flash_attention(
        q, k, v, causal=causal, mode="plain"), reps=5, warm=2)
    # yardstick, not used by the port: PyTorch's fused attention on the
    # [B, H, S, hd] layout it takes
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)

    sdpa_diff = float((sdpa().transpose(1, 2).float()
                       - got.float()).abs().max())
    sdpa_ms = cuda_ms(sdpa, reps=reps)
    bound, by = flash_bound_ms(B, S, H, hd, causal, dt)
    ms, ms_from = ((device_ms, "profiler") if device_ms is not None
                   else (replay_ms, "graph"))
    row = {"shape": shape, "kernel": FWD_KERNEL_NAMES[dt],
           "max_abs_err": max_err, "ms": ms, "ms_from": ms_from,
           "profiler_ms": device_ms, "graph_ms": replay_ms,
           "event_ms": event_ms, "plain_ms": plain_ms, "library_ms": sdpa_ms,
           "bound_ms": bound, "bound_by": by}
    cores = ""
    if dt == "float32":
        row["cuda_core_bound_ms"], _ = flash_bound_ms(
            B, S, H, hd, causal, dt, f32_on="cuda_cores")
        cores = (f"; on the CUDA cores {row['cuda_core_bound_ms']:.4f} ms, "
                 f"{100 * row['cuda_core_bound_ms'] / ms:.2f}%")
    log(f"[flash] {shape}: {FWD_KERNEL_NAMES[dt]} {ms:.4f} ms ({ms_from}; "
        f"profiler {device_ms}, graph replay {replay_ms:.4f}, eager events "
        f"{event_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {sdpa_ms:.4f} ms (max |sdpa - "
        f"kernel| {sdpa_diff:.3g}), bound {bound:.4f} ms ({by}), "
        f"{100 * bound / ms:.2f}% of bound{cores}, {ms / sdpa_ms:.2f}x the "
        f"PyTorch call")
    return row


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

    rows = {key: flash_row(dev, B, S, H, hd, True, dt)
            for key, (B, S, H, hd, dt) in FLASH_TIMED.items()}
    return rows, phase_flash_bwd(dev)


def check_bwd(label, q, k, v, causal, do=None):
    """The forward kernels' LSE against the plain version's, then the
    backward kernels against attention_bwd_plain on the kernel's (o, lse)
    and one output gradient, and against themselves: a second backward of
    the same inputs is bitwise equal. Returns (LSE max abs error, the
    gradients' max abs error)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    _, lse_p = fa.flash_attention(q, k, v, causal=causal, mode="plain",
                                  return_lse=True)
    if do is None:
        g = torch.Generator(device=q.device).manual_seed(q.shape[1] + 7)
        do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  mode="plain")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"two flash backwards of the same inputs differ ({label})")
    lse_err = float((lse - lse_p).abs().max())
    check(lse.shape == lse_p.shape and bool(torch.isfinite(lse).all())
          and lse_err <= LSE_TOL, f"flash LSE != plain ({label}): "
          f"{lse_err} > {LSE_TOL}")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == q.dtype and a.shape == q.shape
              and bool(torch.isfinite(a).all()),
              f"flash backward {name} {a.dtype} {tuple(a.shape)} ({label})")
        if dt == "float32":
            err = close_err(a, b, BWD_F32_TOL)
            check(err <= BWD_F32_TOL, f"flash backward {name} != plain "
                  f"({label}): |got - want| - tol |want| reaches {err} > "
                  f"{BWD_F32_TOL}")
        else:
            err = rel_err(a, b)
            check(err <= FLASH_TOL[dt], f"flash backward {name} != plain "
                  f"({label}): relative error {err} > {FLASH_TOL[dt]}")
    return lse_err, max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(got, want))


def phase_flash_bwd(dev):
    """[flash], backward: the LSE of both forward kernels and the three
    backward stages (bf16: ``flash_bwd_dot``, ``flash_bwd_dkdv_wgmma``,
    ``flash_bwd_dq_wgmma``; f32: ``flash_bwd_dot``, ``flash_bwd_dkdv_tf32``,
    ``flash_bwd_dq_tf32``) against the plain versions at the sweep's shapes,
    their bf16 twins, the timed shapes, strided inputs and output gradients
    (transposed: read in place; strided head dim or rows not 16-byte
    aligned: copied), and through the autograd Function; times at the
    shapes of ``FLASH_BWD_TIMED``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    cases = [(f"sweep {c}", c) for c in FLASH_SWEEP]
    cases += [(f"bf16 twin {c[:5]}", c) for c in FLASH_BF16_TWINS]
    cases += list(FLASH_BWD_TIMED.items())
    errs = {}
    for label, (B, S, H, hd, causal, dt) in cases:
        q, k, v = flash_inputs(B, S, H, hd, dt, seed=B * S + H + 3, dev=dev)
        errs[label] = check_bwd(label, q, k, v, causal)
    # strided: q, k, v as slices of one projection; dO as a transposed
    # [B, H, S, hd] tensor (read in place), with a strided head dim (copied
    # first) and with rows hd + 4 elements apart (in bf16 not a multiple of
    # 16 bytes: the bf16 passes' tensor maps need a copy)
    for dt in ("bfloat16", "float32"):
        B, S, H, hd = 2, 300, 4, 128
        g = torch.Generator(device=dev).manual_seed(SEED)
        qkv = torch.randn((B, S, 3, H, hd), generator=g, device=dev)
        q, k, v = qkv.to(getattr(torch, dt)).unbind(2)
        do_t = torch.randn((B, H, S, hd), generator=g, device=dev) \
            .to(getattr(torch, dt)).transpose(1, 2)
        do_s = torch.randn((B, S, H, 2 * hd), generator=g, device=dev) \
            .to(getattr(torch, dt))[..., ::2]
        do_u = torch.randn((B, S, H, hd + 4), generator=g, device=dev) \
            .to(getattr(torch, dt))[..., :hd]
        check(do_u.stride(-1) == 1 and (dt == "float32"
                                        or not fa._rows_aligned(do_u)),
              "the unaligned dO must have a contiguous head dim and, in "
              "bf16, rows that are not 16-byte aligned")
        for causal in (True, False):
            for what, do in (("transposed dO", do_t), ("strided dO", do_s),
                             ("unaligned dO", do_u)):
                label = f"strided {dt} views, {what}, causal={causal}"
                errs[label] = check_bwd(label, q, k, v, causal, do)
    # autograd through FlashAttentionFn against autograd through the plain
    # version, f32, on the strided views
    qkv = torch.randn((2, 300, 3, 4, 64), generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), device=dev, requires_grad=True)
    w = torch.randn((2, 300, 4, 64), device=dev)
    before = dict(fa.BWD_LAUNCHES)
    got = torch.autograd.grad(
        (fa.flash_attention(*qkv.unbind(2)) * w).sum(), qkv)[0]
    check(all(fa.BWD_LAUNCHES[n] == before[n] + 1 for n in fa.BWD_KERNELS),
          f"the autograd Function did not launch each backward kernel once: "
          f"{before} -> {fa.BWD_LAUNCHES}")
    want = torch.autograd.grad((fa.flash_attention(
        *qkv.unbind(2), mode="plain") * w).sum(), qkv)[0]
    err = close_err(got, want, BWD_F32_TOL)
    check(err <= BWD_F32_TOL, f"autograd through the kernels != through the "
          f"plain version: {err}")
    log("[flash] backward: LSE == plain within " + f"{LSE_TOL} and dq, dk, "
        f"dv == attention_bwd_plain (f32 allclose {BWD_F32_TOL}, bf16 "
        f"relative norm {FLASH_TOL['bfloat16']}) and bitwise equal from run "
        f"to run on the sweep, its bf16 twins, the timed shapes (the "
        f"training cell's too), strided views and dO, and through the "
        f"autograd Function (max |diff| {float((got - want).abs().max()):.3g}"
        f"); (max |LSE diff|, max |grad diff|): "
        + ", ".join(f"{k} ({a:.3g}, {b:.3g})" for k, (a, b) in errs.items()))

    rows = {}
    for key, (B, S, H, hd, causal, dt) in FLASH_BWD_TIMED.items():
        q, k, v = flash_inputs(B, S, H, hd, dt, seed=B * S + H + 3, dev=dev)
        do = flash_inputs(B, S, H, hd, dt, seed=B * S + H + 4, dev=dev)[0]
        names = fa.BWD_KERNEL_NAMES[getattr(torch, dt)]
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        reps = 20

        def bwd(mode=None):
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          mode=mode)

        event_ms = cuda_ms(bwd, reps=reps)
        per_kernel = profiled_kernels_ms(bwd, reps, names, PROFILE_OUT)
        plain_ms = cuda_ms(lambda: bwd("plain"), reps=3, warm=1)
        # yardstick, not used by the port: the backward of PyTorch's fused
        # attention on its [B, H, S, hd] layout, on a retained graph
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        sdpa_ms = cuda_ms(sdpa_bwd, reps=reps)
        # its kernels' device time: the events hold the host's gaps too,
        # where autograd's dispatch outlasts the kernels
        sdpa_busy = device_breakdown(sdpa_bwd, reps, PROFILE_OUT)["busy_ms"]
        del out, qt, kt, vt
        bound, by = flash_bwd_bound_ms(B, S, H, hd, causal, dt)
        cores = flash_bwd_bound_ms(B, S, H, hd, causal, dt,
                                   f32_on="cuda_cores")[0]
        if all(t is not None for t in per_kernel.values()):
            ms, ms_from = sum(per_kernel.values()), "profiler"
        else:
            ms, ms_from = event_ms, "events"
        shape = (f"B={B} S={S} H={H} hd={hd} "
                 f"{'causal' if causal else 'non-causal'} {dt}")
        rows[key] = {"shape": shape,
                     "max_abs_err": errs[key][1], "ms": ms,
                     "ms_from": ms_from, "kernel_ms": per_kernel,
                     "event_ms": event_ms, "plain_ms": plain_ms,
                     "library_ms": sdpa_ms, "library_busy_ms": sdpa_busy,
                     "bound_ms": bound, "bound_by": by}
        if dt == "float32":
            rows[key]["cuda_core_bound_ms"] = cores
        log(f"[flash] backward {shape}: kernels {ms:.4f} ms ({ms_from}: "
            + ", ".join(f"{n} {t}" for n, t in per_kernel.items())
            + f"; eager events {event_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention backward {sdpa_ms:.4f} ms "
            f"(its kernels' device time {sdpa_busy} ms), bound "
            f"{bound:.4f} ms ({by}), {100 * bound / ms:.2f}% of bound"
            + (f"; on the CUDA cores {cores:.4f} ms, "
               f"{100 * cores / ms:.2f}%" if dt == "float32" else "")
            + f", {ms / sdpa_ms:.2f}x the PyTorch call")
    return rows


@contextlib.contextmanager
def plain_attention():
    """Route the model's self-attention through its plain path on the card
    (the comparison passes): ``layers.attention_plain_model``, the
    reference model's arithmetic, which the port runs on the CPU."""
    from repro_torch.models import layers

    real = layers.self_attention
    layers.self_attention = functools.partial(real, mode="plain")
    try:
        yield
    finally:
        layers.self_attention = real


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
    t0 = t_phase = time.perf_counter()
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

    fa.reset_launches()
    loss_cold, cold_s = through_kernel(lambda: float(model.loss(batch)),
                                       "the cold loss")
    (loss_warm, warm_s), loss_peak, prev_peak = step_peak(
        lambda: through_kernel(lambda: float(model.loss(batch)),
                               "the warm loss"), dev, param_bytes(model))
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
    launches = fa.COUNTS["bfloat16"]["flash_fwd"]
    f32_launches = fa.COUNTS["float32"]["flash_fwd"]
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
    peak_gb = max(prev_peak, torch.cuda.max_memory_allocated(dev)) / 2 ** 30
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
        f"(plain bf16 {plain_to_f32:.4g}); flash launches bf16 {launches}, "
        f"the f32 gate {f32_launches} ({L} per forward); peak memory "
        f"{peak_gb:.2f} GiB (the warm loss {loss_peak / 2 ** 30:.3f} GiB)")
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[model] phase {secs:.3f} s")
    return {"launches": launches, "f32_launches": f32_launches,
            "seconds": secs,
            "loss": loss_warm, "cold_s": cold_s,
            "warm_s": warm_s, "loss_peak": loss_peak, "apply_s": apply_s, "plain_s": plain_s,
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
    t_phase = time.perf_counter()
    fa.reset_launches()
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
    fa.reset_launches()
    full = L.unembed(model.apply(batch), model.embed)          # [B,S,V]
    eq_launches = fa.COUNTS["float32"]["flash_fwd"]
    check(eq_launches == fa.LAUNCHES == cfg.num_layers, f"the f32 forward "
          f"launched the f32 flash kernel {eq_launches} times of "
          f"{fa.LAUNCHES}")
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
    secs = time.perf_counter() - t_phase
    log(f"[serve] the phase {secs:.3f} s")
    return {"steps": out["steps"], "seconds": out["seconds"],
            "launches": serve_launches, "eq_launches": eq_launches,
            "phase_seconds": secs,
            "decode_diff": diff}


def family_config(arch):
    """The full-width configuration of ``arch`` as ``[families]`` runs it:
    every width as published; the hybrid cut to one group of
    ``attn_every`` layers (all of Jamba's 32 layers are 194 GiB in f32)."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch]
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every)
    return cfg


def flash_per_forward(cfg) -> int:
    """Flash launches of one forward: one per self-attention layer."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.encoder_layers + cfg.num_layers
    return cfg.num_layers


@contextlib.contextmanager
def counting_plain_attention(counter: list):
    """Count the calls of the model's plain self-attention in
    ``counter[0]``: a family forward through the kernel must make none."""
    from repro_torch.models import layers

    real = layers.attention_plain_model

    def counted(*args, **kwargs):
        counter[0] += 1
        return real(*args, **kwargs)

    layers.attention_plain_model = counted
    try:
        yield
    finally:
        layers.attention_plain_model = real


@contextlib.contextmanager
def routing(log: list, replay: bool = False):
    """Record every MoE routing of a forward into ``log`` (the dict
    ``models.moe.route`` returns, layer by layer), or with ``replay`` hand
    a forward the routings of ``log`` in order instead of its own: the
    experts, tokens, keep mask and slots of each recorded routing, with the
    gates computed from the forward's own router logits (the softmax over
    each token's recorded experts), so they carry its values and its
    gradient to the router."""
    import torch

    from repro_torch.models import moe

    real = moe.route
    it = iter(list(log))

    def route(xt, gate, moe_cfg, cap):
        if not replay:
            out = real(xt, gate, moe_cfg, cap)
            log.append(out)
            return out
        rec = next(it)
        se, st, keep = rec["se"], rec["st"], rec["keep"]
        logits = torch.matmul(xt.float(), gate.float())
        # the pairs grouped by token (each token's k recorded experts)
        by_tok = torch.argsort(st, stable=True)
        k = moe_cfg.top_k
        g = torch.softmax(logits[st[by_tok], se[by_tok]].view(-1, k), dim=-1)
        sg = torch.empty_like(g.view(-1)).index_put((by_tok,), g.view(-1))
        return {**rec, "sg": torch.where(keep, sg, torch.zeros_like(sg))}

    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def routed_apart(a: list, b: list) -> int:
    """(token, MoE layer) pairs whose kept experts differ between two
    forwards' routings."""
    import torch

    n = 0
    for ra, rb in zip(a, b):
        nt = int(ra["st"].max()) + 1
        E = int(max(ra["se"].max(), rb["se"].max())) + 1
        kept = []
        for r in (ra, rb):
            m = torch.zeros((nt, E), dtype=torch.bool, device=r["st"].device)
            m[r["st"][r["keep"]], r["se"][r["keep"]]] = True
            kept.append(m)
        n += int((kept[0] != kept[1]).any(dim=1).sum())
    return n


def mesh_decode(dev, mesh, model, cache, tag) -> dict:
    """The decode sub-step: from ``cache`` (filled unsharded; not changed)
    ``MESH_DECODE_STEPS`` greedy decode steps of ``model`` unsharded and,
    in turns, the same steps through ``decode_step(params=)`` with the
    model's parameters placed on the (1, 1) ``mesh`` (``place_params``:
    on one device, its own tensors) and a copy of the cache placed
    by ``place_cache``: after every step the logits and every cache leaf
    bitwise equal, and the same greedy tokens (the first step's 3, 4, ...
    a row). Returns the ms a step of each (the median of the steps; every
    step synchronised)."""
    import numpy as np
    import torch

    from repro_torch.sharding import ctx, place

    def copy(c):
        return {k: v.clone() if torch.is_tensor(v) else v
                for k, v in c.items()}

    B = next(v for v in cache.values() if torch.is_tensor(v)).shape[1]
    tok = torch.arange(B, device=dev) + 3
    plain_cache = copy(cache)
    ctx.configure(mesh)
    try:
        params = place.place_params(model.param_tree(), mesh, device=dev)
        placed = place.place_cache(copy(cache), model.cfg, B, mesh,
                                   model.hkv % mesh.shape["model"] == 0,
                                   device=dev)
    finally:
        ctx.reset()
    ms = {"unsharded": [], "sharded": []}
    t_plain = t_mesh = tok
    for s in range(MESH_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, plain_cache = model.decode_step(plain_cache, t_plain)
        torch.cuda.synchronize()
        ms["unsharded"].append(1e3 * (time.perf_counter() - t0))
        ctx.configure(mesh)
        try:
            t0 = time.perf_counter()
            got, placed = model.decode_step(placed, t_mesh, params=params)
            torch.cuda.synchronize()
            ms["sharded"].append(1e3 * (time.perf_counter() - t0))
        finally:
            ctx.reset()
        got = got.full_tensor()
        check(got.shape == want.shape and torch.equal(got, want),
              f"{tag} decode step {s}: the sharded logits differ from the "
              f"unsharded ones (max |d| "
              f"{float((got - want).abs().max()):.4g})")
        for k, v in plain_cache.items():
            same = v == placed[k] if k == "len" else torch.equal(
                v, placed[k].to_local())
            check(same, f"{tag} decode step {s}: cache leaf {k} differs")
        t_plain, t_mesh = want.argmax(-1), got.argmax(-1)
        check(torch.equal(t_plain, t_mesh), f"{tag} decode step {s}: tokens")
    del params, placed, plain_cache
    out = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"[mesh-decode] {tag}: {MESH_DECODE_STEPS} decode steps (B={B}, "
        f"from len {cache['len']}) on a (1, 1) mesh bitwise equal to the "
        f"unsharded steps (logits, every cache leaf, tokens); ms a step "
        f"sharded {out['sharded']:.3f} vs unsharded {out['unsharded']:.3f} "
        f"(steps {[round(x, 3) for x in ms['sharded']]} vs "
        f"{[round(x, 3) for x in ms['unsharded']]}; DTensor dispatch, no "
        f"gate); {nvidia_smi_line()}")
    return out


def prefilled(model, dev, B=MESH_DECODE_B):
    """A decoder's cache after ``MESH_DECODE_PROMPT`` unsharded decode
    steps of seed tokens (the batcher's prompt feed), room for
    ``MESH_DECODE_STEPS`` more."""
    import numpy as np
    import torch

    cache = model.init_cache(B, MESH_DECODE_PROMPT + MESH_DECODE_STEPS)
    rng = np.random.default_rng(SEED)
    for t in range(MESH_DECODE_PROMPT):
        tok = torch.as_tensor(rng.integers(1, model.cfg.vocab, B),
                              device=dev)
        _, cache = model.decode_step(cache, tok)
    return cache


def family_mesh_decode(dev, mesh, model, cache, arch) -> dict:
    """:func:`mesh_decode` of a [families] configuration; the MoE family
    under each of its three dispatches (the model's config swapped for the
    sub-step, then restored; Jamba's MoE layers keep its own)."""
    import dataclasses

    cfg = model.cfg
    if cfg.family != "moe":
        return {arch: mesh_decode(dev, mesh, model, cache, f"[families] "
                                  f"{arch}")}
    out = {}
    try:
        for d in MESH_FAMILY_DISPATCHES:
            model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch=d))
            out[f"{arch} {d}"] = mesh_decode(dev, mesh, model, cache,
                                             f"[families] {arch} {d}")
    finally:
        model.cfg = cfg
    return out


def family_cell(dev, arch, plain_calls, mesh):
    """One configuration of ``[families]``: (a) the loss forward through
    the kernel, cold and warm, and its final hidden states against plain
    attention of the same parameters, by the rule of ``[model]`` (f32:
    elementwise within ``F32_MODEL_TOL``; bf16: no further from the f32
    plain forward than the plain bf16 forward is, within
    ``BF16_MODEL_SLACK``; the bf16 losses within ``BF16_MODEL_TOL``), with
    a profiled warm forward; (b) the serve entry point (Whisper: prefill,
    then greedy decode steps); (c) forward == decode in f32; (e) the peak
    device memory; and the decode sub-step on the (1, 1) ``mesh``
    (:func:`family_mesh_decode`, on the bf16 model: decoders from a cache of
    ``MESH_DECODE_PROMPT`` steps, Whisper from its prefill). An MoE's
    comparison forwards take the routing of the kernel's bf16 forward
    (:func:`routing`)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, param_count
    from repro_torch.models import layers as L

    cfg = family_config(arch)
    S, traffic = FAMILY_CELLS[arch]
    n_attn = flash_per_forward(cfg)
    moe = cfg.moe is not None
    t_cell = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)

    def through_kernel(fn, what, launches=n_attn):
        before, plain_before = fa.LAUNCHES, plain_calls[0]
        out, secs = timed(fn)
        check(fa.LAUNCHES - before == launches, f"[families] {arch}: {what} "
              f"launched the flash kernel {fa.LAUNCHES - before} times, not "
              f"{launches}")
        check(plain_calls[0] == plain_before, f"[families] {arch}: {what} "
              f"ran the plain attention")
        return out, secs

    def build(c):
        return build_model(c, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))

    # (a) the bf16 forward through the kernel and plain. A token whose
    # router logits round apart in two forwards can take another expert
    # (or be dropped at capacity), which moves its hidden state far more
    # than the attention's rounding does, so every comparison forward of an
    # MoE is handed the kernel forward's routing: they measure the
    # attention alone. How far apart the routings would be is reported.
    model, init_s = timed(lambda: build(cfg))
    n_params = param_count(model)
    batch = SyntheticTokens(cfg, ShapeConfig("families", "prefill", S, 1),
                            seed=SEED).batch(0)
    loss_cold, cold_s = through_kernel(lambda: float(model.loss(batch)),
                                       "the cold loss")
    (loss_warm, warm_s), loss_peak, prev_peak = step_peak(
        lambda: through_kernel(lambda: float(model.loss(batch)),
                               "the warm loss"), dev, param_bytes(model))
    routes, own = [], []
    with routing(routes):
        h16, apply_s = through_kernel(lambda: model.apply(batch),
                                      "the forward")
    with plain_attention(), routing(routes, replay=True):
        h16p, plain_s = timed(lambda: model.apply(batch))
    apart = None
    if moe:
        with plain_attention(), routing(own):
            rel_own = rel_err(h16, model.apply(batch))
        apart = routed_apart(routes, own)
    labels = torch.as_tensor(batch["labels"], device=dev)
    loss_p = float(L.softmax_xent(L.unembed(h16p, model.embed), labels))
    prof_s = FAMILY_PROFILE_S.get(arch, S)
    check(h16.shape == (1, S, cfg.d_model) and h16.dtype == torch.bfloat16
          and bool(torch.isfinite(h16).all()) and math.isfinite(loss_warm),
          f"[families] {arch}: hidden states {h16.dtype} "
          f"{tuple(h16.shape)} or loss {loss_warm} not finite bf16")
    rel16 = rel_err(h16, h16p)
    rel_loss = abs(loss_warm - loss_p) / abs(loss_p)
    check(rel_loss <= BF16_MODEL_TOL, f"[families] {arch}: bf16 loss "
          f"through the kernel {loss_warm} != plain {loss_p}")
    prof_batch = batch if prof_s == S else SyntheticTokens(
        cfg, ShapeConfig("families", "prefill", prof_s, 1),
        seed=SEED).batch(0)
    fwd = device_breakdown(lambda: model.loss(prof_batch), 1, PROFILE_OUT)
    del prof_batch

    # (b) serving; the decode sub-step under the parallel plan
    if traffic is None:            # Whisper: prefill, then greedy decode
        cache = model.init_cache(1, WHISPER_DECODE_STEPS + 1, enc_len=S)
        cache, prefill_s = through_kernel(
            lambda: model.prefill(cache, batch["enc_embeds"]),
            "the prefill", cfg.encoder_layers)
        tok = torch.as_tensor(batch["dec_tokens"][:, 0], device=dev)
        mesh_dec = family_mesh_decode(dev, mesh, model, cache, arch)
        plain_before = plain_calls[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WHISPER_DECODE_STEPS):
            logits, cache = model.decode_step(cache, tok)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        check(plain_calls[0] == plain_before and cache["len"] ==
              WHISPER_DECODE_STEPS, f"[families] {arch}: decode")
        serving = {"prefill_s": prefill_s, "steps": WHISPER_DECODE_STEPS,
                   "seconds": dec_s,
                   "ms_per_step": 1e3 * dec_s / WHISPER_DECODE_STEPS,
                   "tokens_per_s": WHISPER_DECODE_STEPS / dec_s}
        del cache
    else:
        mesh_dec = family_mesh_decode(dev, mesh, model,
                                      prefilled(model, dev), arch)
    del model
    torch.cuda.empty_cache()
    if traffic is not None:
        requests, slots, max_new, max_len = traffic
        plain_before = plain_calls[0]
        out = serve(cfg, requests, slots, max_new, max_len, device=dev)
        reqs = out["requests"]
        check(len(reqs) == requests and all(r.done and r.out for r in reqs)
              and out["steps"] < max_len and plain_calls[0] == plain_before,
              f"[families] {arch}: {sum(r.done for r in reqs)} of "
              f"{requests} requests finished in {out['steps']} steps")
        serving = {"steps": out["steps"], "seconds": out["seconds"],
                   "ms_per_step": 1e3 * out["seconds"] / out["steps"],
                   "tokens_per_s": out["tokens"] / out["seconds"]}
        del out, reqs
        torch.cuda.empty_cache()

    # (a), f32: the same parameters (the same seed) in f32, through the
    # kernel and plain, on the bf16 kernel forward's routing
    model = build(dataclasses.replace(cfg, dtype="float32"))
    with routing(routes, replay=True):
        h32, f32_s = through_kernel(lambda: model.apply(batch),
                                    "the f32 forward")
    with plain_attention(), routing(routes, replay=True):
        h32p = model.apply(batch)
    err32 = close_err(h32, h32p, F32_MODEL_TOL)
    max32 = float((h32 - h32p).abs().max())
    to_f32, plain_to_f32 = rel_err(h16, h32p), rel_err(h16p, h32p)
    del h32, h32p, h16, h16p
    check(err32 <= F32_MODEL_TOL, f"[families] {arch}: f32 kernel forward "
          f"!= plain forward: |h - h_plain| - tol |h_plain| reaches {err32} "
          f"> {F32_MODEL_TOL}")
    check(to_f32 <= BF16_MODEL_SLACK * plain_to_f32, f"[families] {arch}: "
          f"the bf16 kernel forward is {to_f32} from the f32 forward, the "
          f"plain bf16 forward {plain_to_f32}")

    # (c) forward == step-by-step decode at full width in f32, MoE at
    # capacity factor 8 (capacity drops differ between an S-token and a
    # 1-token call)
    if moe:
        model.cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    B, n = 2, 8
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab, (B, n)).astype(np.int32)
    if cfg.family == "audio":
        enc = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
        h, _ = through_kernel(lambda: model.apply(
            {"enc_embeds": enc, "dec_tokens": tok}), "the f32 forward")
        cache, _ = through_kernel(lambda: model.prefill(
            model.init_cache(B, n + 2, enc_len=S), enc), "the f32 prefill",
            cfg.encoder_layers)
    else:
        h, _ = through_kernel(lambda: model.apply({"tokens": tok}),
                              "the f32 forward")
        cache = model.init_cache(B, n + 2)
    full = L.unembed(h, model.embed)
    plain_before = plain_calls[0]
    dec = torch.stack([model.decode_step(cache, tok[:, t])[0]
                       for t in range(n)], dim=1)
    check(plain_calls[0] == plain_before, f"[families] {arch}: decode ran "
          f"the plain attention")
    err = close_err(dec, full, DECODE_TOL)
    diff = float((dec - full).abs().max())
    check(err <= DECODE_TOL, f"[families] {arch}: decode logits != forward "
          f"logits: {err}")
    del model, cache, h, full, dec
    peak_gb = max(prev_peak, torch.cuda.max_memory_allocated(dev)) / 2 ** 30
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_cell
    log(f"[families] {arch} ({cfg.family}, {cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}): {n_params / 1e6:.3f}M params (f32 "
        f"master, {cfg.dtype} activations), init {init_s:.3f} s; (a) loss "
        f"on B=1 S={S}: cold {cold_s:.3f} s, warm {warm_s:.3f} s, loss "
        f"{loss_warm:.6f} (plain {loss_p:.6f}, relative {rel_loss:.3g} <= "
        f"{BF16_MODEL_TOL}; ln V {math.log(cfg.vocab):.6f}); forward to "
        f"hidden states {apply_s:.3f} s through the kernel ({n_attn} "
        f"launches), {plain_s:.3f} s plain (f32 through the kernel: "
        f"{f32_s:.3f} s); kernel vs plain: f32 max "
        f"{max32:.4g} (allclose {F32_MODEL_TOL}), bf16 relative {rel16:.4g}, "
        f"bf16 to f32 {to_f32:.4g} (plain bf16 {plain_to_f32:.4g}, <= "
        f"{BF16_MODEL_SLACK}x)"
        + (f"; on the kernel forward's routing (the plain bf16 forward on "
           f"its own routing: {rel_own:.4g} relative, {apart} of "
           f"{len(routes) * S} (token, layer) routings apart)"
           if moe else ""))
    log(f"[families] {arch} (a) warm loss forward (S={prof_s}): "
        f"{breakdown_text(fwd)}")
    if traffic is None:
        log(f"[families] {arch} (b) prefill of {S} frames {prefill_s:.3f} s "
            f"({cfg.encoder_layers} flash launches, cross K/V of "
            f"{cfg.num_layers} layers cached), then {WHISPER_DECODE_STEPS} "
            f"greedy decode steps in {dec_s:.3f} s "
            f"({serving['ms_per_step']:.3f} ms per step)")
    else:
        log(f"[families] {arch} (b) serve: {requests} requests on {slots} "
            f"slots, max_new {max_new}, max_len {max_len}: all finished in "
            f"{serving['steps']} decode steps, {serving['seconds']:.3f} s "
            f"({serving['tokens_per_s']:.1f} slot tokens/s, "
            f"{serving['ms_per_step']:.3f} ms per step)")
    log(f"[families] {arch} (c) forward == decode in f32 (B={B}, {n} steps"
        + (", capacity factor 8" if moe else "")
        + f"): max |decode - forward| {diff:.4g} (tolerance {DECODE_TOL}); "
        f"(e) peak memory {peak_gb:.2f} GiB (the warm loss "
        f"{loss_peak / 2 ** 30:.3f} GiB); the cell {secs:.3f} s")
    return {"params": n_params, "cold_s": cold_s, "warm_s": warm_s,
            "apply_s": apply_s, "plain_s": plain_s, "f32_apply_s": f32_s,
            "bf16_rel_err": rel16,
            "f32_max_abs_diff": max32, "bf16_to_f32": to_f32,
            "plain_bf16_to_f32": plain_to_f32, "rel_loss": rel_loss,
            "routed_apart": apart, "forward": fwd, "serve": serving,
            "decode_diff": diff, "peak_gib": peak_gb, "loss_peak": loss_peak,
            "mesh_decode": mesh_dec, "seconds": secs}


def phase_families(dev):
    """[families]: the MoE, VLM, hybrid, xLSTM and Whisper configurations at
    full width on the card (:func:`family_cell`, one at a time, each freed
    before the next; each with its decode sub-step on a (1, 1) mesh over a
    one-process NCCL group), then (d) the flash kernel at the shapes they
    give it."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as launch_mesh

    t_phase = time.perf_counter()
    fa.reset_launches()
    plain_calls = [0]
    cells = {}
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_fam_mesh_")
    launch_mesh.init_process_group(dev, store=os.path.join(tmp_dir.name,
                                                           "store"))
    try:
        mesh = launch_mesh.init_mesh((1, 1), ("data", "model"), dev)
        with counting_plain_attention(plain_calls):
            for arch in FAMILY_CELLS:
                before = fa.LAUNCHES
                cells[arch] = family_cell(dev, arch, plain_calls, mesh)
                cells[arch]["launches"] = fa.LAUNCHES - before
    finally:
        dist.destroy_process_group()
        tmp_dir.cleanup()
    launches = fa.COUNTS["bfloat16"]["flash_fwd"]
    f32_launches = fa.COUNTS["float32"]["flash_fwd"]
    rows = {key: flash_row(dev, *shape, "bfloat16")
            for key, shape in FLASH_FAMILY_SHAPES.items()}
    secs = time.perf_counter() - t_phase
    log(f"[families] flash launches {launches}: "
        + ", ".join(f"{arch} {cell['launches']} ("
                    f"{flash_per_forward(family_config(arch))} a forward)"
                    for arch, cell in cells.items())
        + f"; bf16 {launches}, the f32 gates {f32_launches}; the phase "
        f"{secs:.3f} s in all")
    return {"launches": launches, "f32_launches": f32_launches, "cells": cells,
            "flash": rows, "seconds": secs}


def leaf_pairs(a, b, prefix=""):
    """(path, leaf of a, leaf of b) over two nested dicts of one
    structure."""
    for key, x in a.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(x, dict):
            yield from leaf_pairs(x, b[key], path)
        else:
            yield path, x, b[key]


def first_step(cfg, dev, B, S, tag):
    """The first step's loss and gradients (seed-0 parameters, the train
    CLI's batch 0 of B x S) through the flash kernels and through the
    model's plain attention, in bf16 and in an f32 copy of the config: one
    model, whose activation dtype is switched between the passes (the f32
    master parameters are the same). The bf16 kernel pass goes first; with
    an MoE it records its routings (forward, then the recompute's, layer
    by layer in reverse), which must agree bitwise, and the other three
    passes replay them, so the comparisons see the attention alone.

    The f32 kernel pass's loss and its gradients' bits
    (:func:`grad_bits`), and the routings, are kept in the result for
    ``[train-families]`` (d).

    Gates, by ``[train]`` (b)'s rule: the f32 gradients elementwise,
    ``|g - g_plain| <= F32_GRAD_TOL (|g_plain| + max |g_plain|)``; each
    bf16 leaf no further from the f32 plain gradient than the plain bf16
    leaf is, times ``BF16_MODEL_SLACK``; the bf16 losses within
    ``BF16_MODEL_TOL``. A key bias (``bk``) is left out of both and held
    by :data:`ZERO_GRAD_TOL` instead: the softmax does not move when every
    key shifts by one vector, so its exact gradient is zero and both paths
    give rounding noise there. A family without attention (xLSTM) runs
    the bf16 and f32 passes only: its kernel and plain paths are one code.
    Returns the numbers for the log."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.step import loss_and_grads

    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    params = model.param_tree()
    batch = SyntheticTokens(cfg, ShapeConfig("cli", "train", S, B),
                            seed=0).batch(0)
    n_attn = flash_per_forward(cfg)
    moe = cfg.moe is not None
    routes = []

    secs = {}
    f32_before = dict(fa.COUNTS["float32"])

    def f32_launched():
        """The f32 kernels' launches since the first step began: those of
        its f32 kernel pass."""
        return {k: n - f32_before[k] for k, n in fa.COUNTS["float32"].items()}

    def run(dtype, plain=False, record=False):
        model.cfg = dataclasses.replace(cfg, dtype=dtype)
        before = fa.BWD_LAUNCHES["flash_bwd_dq"]
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_attention())
            if moe:
                stack.enter_context(routing(routes, replay=not record))
            (loss, grads), secs[dtype, plain] = timed(
                lambda: loss_and_grads(model, params, batch))
        launched = fa.BWD_LAUNCHES["flash_bwd_dq"] - before
        check(launched == (0 if plain else n_attn), f"{tag} the {dtype} "
              f"{'plain' if plain else 'kernel'} pass launched the "
              f"backward {launched} times, not {0 if plain else n_attn}")
        loss = float(loss)
        check(math.isfinite(loss) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads)),
            f"{tag} the {dtype} pass gave a loss {loss} or gradients that "
            f"are not finite")
        return loss, grads

    out = {}
    loss16_k, g16_k = run("bfloat16", record=True)
    # (d) replays the routings: kept without their graphs
    out["routes"] = [{k: v.detach() for k, v in r.items()} for r in routes]
    if moe:
        L = len(routes) // 2
        check(len(routes) == 2 * L and L > 0, f"{tag} {len(routes)} "
              f"routings recorded, not two a MoE layer")
        same = all(torch.equal(a[key], b[key])
                   for a, b in zip(routes[:L], reversed(routes[L:]))
                   for key in a)
        check(same, f"{tag} the recompute routed differently from the "
              f"forward")
        out["recompute_routing_equal"] = same
    if n_attn == 0:
        loss32, g32 = run("float32")
        del model, params
        dist = {path: rel_err(a, b) for path, a, b in leaf_pairs(g16_k, g32)}
        out.update(loss16=loss16_k, loss32=loss32, bf16_to_f32=dist,
                   f32_launches=f32_launched(), f32_loss=loss32,
                   f32_bits=grad_bits(g32))
        return out
    loss32_k, g32_k = run("float32")
    out.update(f32_loss=loss32_k, f32_bits=grad_bits(g32_k))
    loss32_p, g32 = run("float32", plain=True)
    check(abs(loss32_k - loss32_p) <= F32_GRAD_TOL * abs(loss32_p),
          f"{tag} f32 first-step loss {loss32_k} != plain {loss32_p}")
    top = max(float(g.norm()) for g in tree_leaves(g32))
    ratio32, zero = {}, {}
    for path, a, b in leaf_pairs(g32_k, g32):
        if path.endswith("bk"):
            zero[path] = [float(a.norm()) / top]
            continue
        ratio32[path] = float(((a - b).abs() / (b.abs() + b.abs().max()))
                              .max())
    del g32_k
    worst32 = max(ratio32, key=ratio32.get)
    check(ratio32[worst32] <= F32_GRAD_TOL, f"{tag} f32 first-step gradient "
          f"{worst32} through the kernels != plain: |g - g_plain| / "
          f"(|g_plain| + max |g_plain|) reaches {ratio32[worst32]} > "
          f"{F32_GRAD_TOL}")
    loss16_p, g16_p = run("bfloat16", plain=True)
    del model, params
    check(abs(loss16_k - loss16_p) <= BF16_MODEL_TOL * abs(loss16_p),
          f"{tag} bf16 first-step loss {loss16_k} != plain {loss16_p}")
    to32 = {}
    for (path, a, b), g in zip(leaf_pairs(g16_k, g16_p),
                               (g for _, g, _ in leaf_pairs(g32, g32))):
        if path in zero:
            zero[path] += [float(a.norm()) / top, float(b.norm()) / top]
            check(max(zero[path]) <= ZERO_GRAD_TOL, f"{tag} key bias "
                  f"{path}: gradient norms {zero[path]} of the largest "
                  f"leaf's (f32 kernel, bf16 kernel, bf16 plain) exceed "
                  f"{ZERO_GRAD_TOL}")
            continue
        to32[path] = (rel_err(a, g), rel_err(b, g), rel_err(a, b))
        check(to32[path][0] <= BF16_MODEL_SLACK * to32[path][1],
              f"{tag} bf16 first-step gradient {path} through the kernels "
              f"is {to32[path][0]} from the f32 gradient, the plain bf16 "
              f"gradient {to32[path][1]}")
    worst = max(to32, key=lambda p: to32[p][0] / to32[p][1])
    out.update(loss32_k=loss32_k, loss32_p=loss32_p, loss16_k=loss16_k,
               loss16_p=loss16_p, ratio32=ratio32[worst32], worst32=worst32,
               to32=to32, worst=worst, zero=zero,
               f32_kernel_s=secs["float32", False],
               f32_plain_s=secs["float32", True],
               f32_launches=f32_launched())
    return out


def bits_fingerprint(t, chunk: int = 1 << 24) -> tuple[int, int]:
    """Two exact integer sums of a 32-bit tensor's words: their sum, and
    their sum weighted by (index mod 65521) + 1, over chunks of ``chunk``
    elements on the tensor's device. Equal bits give equal sums, and a
    tensor with other bits almost surely other sums; no copy of the tensor
    leaves the card."""
    import torch

    w = t.detach().contiguous().view(-1).view(torch.int32)
    s1 = s2 = 0
    for i in range(0, w.numel(), chunk):
        c = w[i:i + chunk].to(torch.int64)
        idx = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
        s1 += int(c.sum())
        s2 += int((c * idx).sum())
    return s1, s2


def grad_bits(grads) -> dict:
    """Each gradient leaf's :func:`bits_fingerprint` by its tree path (a
    DTensor's local shard)."""
    return {path: bits_fingerprint(g.to_local() if hasattr(g, "to_local")
                                   else g)
            for path, g, _ in leaf_pairs(grads, grads)}


def first_step_text(r: dict) -> str:
    """The log text of :func:`first_step`'s result."""
    if "to32" not in r:
        return (f"bf16 loss {r['loss16']:.6f}, f32 {r['loss32']:.6f}; no "
                f"attention, so no kernel-vs-plain pass; bf16 gradients to "
                f"f32 (relative norm) up to "
                f"{max(r['bf16_to_f32'].values()):.4f}")
    to32, worst = r["to32"], r["worst"]
    text = (f"f32 loss {r['loss32_k']:.7f} vs {r['loss32_p']:.7f}, worst "
            f"gradient |g - g_plain| / (|g_plain| + max |g_plain|) "
            f"{r['ratio32']:.3g} ({r['worst32']}; <= {F32_GRAD_TOL}); bf16 "
            f"loss {r['loss16_k']:.6f} vs {r['loss16_p']:.6f}; bf16 "
            f"gradients to the f32 ones, kernels / plain (relative norm, <= "
            f"{BF16_MODEL_SLACK}x): worst ratio "
            f"{to32[worst][0] / to32[worst][1]:.3f} ({worst}: "
            f"{to32[worst][0]:.4f}/{to32[worst][1]:.4f}), kernels from f32 "
            f"{min(v[0] for v in to32.values()):.4f}-"
            f"{max(v[0] for v in to32.values()):.4f}, plain "
            f"{min(v[1] for v in to32.values()):.4f}-"
            f"{max(v[1] for v in to32.values()):.4f}; kernels vs plain bf16 "
            f"up to {max(v[2] for v in to32.values()):.4f}; the f32 loss "
            f"and gradients {r['f32_kernel_s']:.3f} s through the kernels, "
            f"{r['f32_plain_s']:.3f} s plain; the f32 kernel pass launched "
            f"{r['f32_launches']}")
    if r["zero"]:
        text += (f"; key biases (f32 kernel, bf16 kernel, bf16 plain "
                 f"gradient norms of the largest leaf's, <= "
                 f"{ZERO_GRAD_TOL}): " + ", ".join(
                     f"{p} " + "/".join(f"{x:.2g}" for x in v)
                     for p, v in r["zero"].items()))
    if "recompute_routing_equal" in r:
        text += "; the recompute's routing == the forward's, bitwise"
    return text


def phase_train(dev):
    """[train]: (a) the train entry point at full width with the CLI's
    defaults and the CarbonGate, through the flash kernels forward and
    backward, and one profiled warm step; (b) its first step's loss and
    gradients through the kernels against the plain attention, in bf16 and
    in an f32 copy of the config; (c) a ``RESTART_STEPS``-step run under
    injected failures and restarts from checkpoints against an
    uninterrupted one; (d) --mp:
    bf16 live parameters, their checkpoint read back bit for bit."""
    import gc
    import math
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.checkpoint.ckpt import latest_checkpoint
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.runtime import FailureInjector, run_with_restarts
    from repro_torch.train.step import init_state, make_train_step

    cfg = ARCHS[TRAIN_ARCH]
    L = cfg.num_layers
    t_phase = time.perf_counter()
    gc.collect()      # an earlier phase's garbage, freed before, not during
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    tmp = tmp_dir.name

    # (a) the CLI path: --arch smollm-360m --batch 8 --seq 256 --steps 80
    # (a cut of 100) --carbon-gate, checkpoints every 50 steps
    fa.reset_launches()
    t0 = time.perf_counter()
    out = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                carbon_gate=True, ckpt_dir=os.path.join(tmp, "cli"),
                device=dev, log=lambda m: log(f"[train] {m}"))
    cli_s = time.perf_counter() - t0
    launches = dict(fa.COUNTS["bfloat16"])
    losses, secs = out["losses"], out["step_seconds"]
    n = len(losses)
    check(out["start"] == 0 and n == TRAIN_STEPS, f"the CLI ran {n} steps "
          f"from {out['start']}")
    check(all(math.isfinite(x) for x in losses + out["gnorms"]),
          "a loss or gradient norm is not finite")
    ln_v = math.log(cfg.vocab)
    check(abs(losses[0] - ln_v) < 0.5, f"first loss {losses[0]} is not "
          f"within 0.5 of ln V = {ln_v:.4f}")
    want = {"flash_fwd": 2 * L * n, **{k: L * n for k in fa.BWD_KERNELS}}
    check(launches == want, f"flash launches {launches}, predicted {want} "
          f"(per step: {2 * L} forward with remat, {L} of each backward)")
    gate = out["gate"]
    check(gate["cost"] <= gate["asap_cost"], f"gate plan {gate}")
    cold_s, warm_s = secs[0], float(np.median(secs[1:]))
    tok_s = out["tokens_per_step"] / warm_s
    # one profiled warm step: the CLI's step function on its final state
    batch = SyntheticTokens(cfg, ShapeConfig("cli", "train", TRAIN_S,
                                             TRAIN_B), seed=0).batch(n)
    state, step_fn = out["state"], out["step_fn"]
    step_prof = device_breakdown(lambda: step_fn(state, batch), 1,
                                 PROFILE_OUT)
    # (a)'s own peak: its state, its steps, the profiled step
    a_peak = torch.cuda.max_memory_allocated(dev) - base
    del out, state, step_fn
    log(f"[train] (a) {cfg.name} ({cfg.dtype} activations, f32 masters), "
        f"B={TRAIN_B} S={TRAIN_S}, {n} steps with the CarbonGate (plan cost "
        f"{gate['cost']} vs ASAP {gate['asap_cost']}, {gate['waited']:.0f} "
        f"simulated s held back) in {cli_s:.3f} s: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (ln V = {ln_v:.4f}); step s cold {cold_s:.4f}, "
        f"warm {warm_s:.4f} (median of {n - 1}; min {min(secs[1:]):.4f}, max "
        f"{max(secs[1:]):.4f}), {tok_s:.1f} tokens/s; flash launches "
        f"{launches} ({2 * L} forward and {L} of each backward per step)")
    log(f"[train] (a) profiled warm step: {breakdown_text(step_prof)}; "
        f"(a)'s peak memory {a_peak / 2 ** 30:.3f} GiB")

    # (b) the first step, kernels against the plain attention
    t0 = time.perf_counter()
    first = first_step(cfg, dev, TRAIN_B, TRAIN_S, "[train] (b)")
    log(f"[train] (b) first step, kernels vs plain attention: "
        f"{first_step_text(first)} in {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()

    # (c) restarts: tests/test_substrates.py's resume case at full width
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    step_fn = make_train_step(model)
    data = SyntheticTokens(cfg, ShapeConfig("restart", "train", TRAIN_S,
                                            TRAIN_B), seed=5)

    def fresh():
        return init_state(model, torch.Generator(device=dev).manual_seed(0))

    ref = fresh()
    for s in range(RESTART_STEPS):
        ref, _ = step_fn(ref, data.batch(s))
    restart_dir = os.path.join(tmp, "restart")
    restored = []                    # the steps restored from checkpoints

    class Manager(CheckpointManager):
        def restore_latest(self, like=None):
            state, step = super().restore_latest(like)
            if state is not None:
                restored.append(step)
            return state, step

    mgr = Manager(restart_dir, keep=RESTART_KEEP, every=RESTART_EVERY)
    inj = FailureInjector(prob_per_step=0.35, seed=3)

    def train_fn(state, start, stop):
        for s in range(start, stop):
            inj.maybe_fail(s)
            state, _ = step_fn(state, data.batch(s))
            mgr.maybe_save(state, s)
        return state

    got, done, restarts = run_with_restarts(train_fn, mgr, fresh,
                                            RESTART_STEPS, max_restarts=50)
    check(done == RESTART_STEPS and restarts > 0, f"the restarted run did "
          f"{done} steps with {restarts} restarts")
    saved = sorted(d for d in os.listdir(restart_dir)
                   if d.startswith("ckpt_"))
    n_saves = len(range(0, RESTART_STEPS, RESTART_EVERY))
    check(restored, "no restart restored a saved checkpoint")
    check(len(saved) == RESTART_KEEP < n_saves, f"{len(saved)} checkpoints "
          f"left of {n_saves} saves with keep={RESTART_KEEP}: {saved}")
    worst, bitwise = 0.0, True
    for path, a, b in leaf_pairs(ref["params"], got["params"]):
        a, b = a.float(), torch.as_tensor(b, device=dev).float()
        bitwise &= bool(torch.equal(a, b))
        worst = max(worst, float(((a - b).abs()
                                  - RESTART_RTOL * b.abs()).max()))
        check(bool(torch.allclose(a, b, rtol=RESTART_RTOL,
                                  atol=RESTART_ATOL)),
              f"the restarted run's {path} != the uninterrupted run's: "
              f"|a - b| - rtol |b| reaches {worst}")
    del ref, got, model
    log(f"[train] (c) {RESTART_STEPS} steps under injected failures: "
        f"{restarts} restarts, {len(restored)} of them from the checkpoints "
        f"of steps {restored} (one every {RESTART_EVERY} steps, "
        f"{len(saved)} of {n_saves} kept: {saved}), "
        f"final parameters == the uninterrupted run's (rtol {RESTART_RTOL}, "
        f"atol {RESTART_ATOL}; bitwise equal: {bitwise}) in "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()

    # (d) --mp: bf16 live parameters over f32 masters, checkpointed
    t0 = time.perf_counter()
    out = train(cfg, steps=MP_STEPS, batch=TRAIN_B, seq=TRAIN_S, mp=True,
                ckpt_dir=os.path.join(tmp, "mp"), ckpt_every=2, device=dev,
                log=lambda m: log(f"[train] {m}"))
    mp_losses = out["losses"]
    check(all(math.isfinite(x) for x in mp_losses), f"--mp losses "
          f"{mp_losses}")
    path = latest_checkpoint(os.path.join(tmp, "mp"))
    saved, step = load_checkpoint(path)
    check(step == MP_STEPS - 1, f"the last --mp checkpoint is of step {step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    state = out["state"]
    n_bf16 = 0
    for path_, a, b in leaf_pairs(state, saved):
        kind = manifest[path_]["dtype"]
        if path_.startswith("params/"):
            check(kind == "bfloat16" and a.dtype == torch.bfloat16
                  and b.dtype == torch.bfloat16, f"--mp leaf {path_}: live "
                  f"{a.dtype}, stored {kind}, read back {b.dtype}")
            check(torch.equal(a.cpu().view(torch.int16), b.view(torch.int16)),
                  f"--mp leaf {path_} read back with other bits")
            n_bf16 += 1
        else:
            check(np.array_equal(a.cpu().numpy(), np.asarray(b)),
                  f"--mp leaf {path_} read back different")
    del out, state, saved
    log(f"[train] (d) --mp, {MP_STEPS} steps: losses "
        f"{[round(x, 4) for x in mp_losses]}; the step-{step} checkpoint "
        f"holds {n_bf16} bf16 parameter "
        f"leaves, read back bit for bit beside the f32 master and moments, "
        f"in {time.perf_counter() - t0:.3f} s")
    tmp_dir.cleanup()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.empty_cache()
    secs_phase = time.perf_counter() - t_phase
    log(f"[train] phase {secs_phase:.3f} s, peak memory {peak_gb:.2f} GiB")
    return {"launches": launches, "f32_launches": first["f32_launches"],
            "cold_s": cold_s,
            "warm_s": warm_s, "tokens_per_s": tok_s, "step": step_prof,
            "a_peak": a_peak, "seconds": secs_phase}


def mesh_uneven_shards(dev) -> dict:
    """[mesh] (uneven): the flash kernels on the local shards a rank holds
    of a microbatch whose rows do not split evenly over the batch axes, at
    SmolLM-360M's attention shape (S = TRAIN_S, its heads, hd 64), bf16
    and f32: an empty shard [0, S, H, hd] (the forward and, through
    FlashAttentionFn, the backward: no launch, the plain version's empty
    outputs and gradients, of its shapes and dtypes) and a one-row shard
    (one launch of the forward and of each backward stage, held to the
    plain version at the flash sweep's tolerances). Returns the counts."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    cfg = ARCHS[TRAIN_ARCH]
    S, H, hd = TRAIN_S, cfg.num_heads, cfg.head_dim
    one = {"flash_fwd": 1, **dict.fromkeys(fa.BWD_KERNELS, 1)}
    out, errs = {}, {}
    for dt in ("bfloat16", "float32"):
        for B in (0, 1):
            label = f"[mesh] {dt} shard of {B} row{'s' * (B != 1)}"
            q, k, v = (x.requires_grad_() for x in flash_inputs(
                B, S, H, hd, dt, seed=B + 41, dev=dev))
            g = torch.Generator(device=dev).manual_seed(B + 43)
            do = torch.randn((B, S, H, hd), generator=g,
                             device=dev).to(q.dtype)
            fa.reset_launches()
            o = fa.flash_attention(q, k, v)
            grads = torch.autograd.grad(o, (q, k, v), do)
            torch.cuda.synchronize()
            counts = dict(fa.COUNTS[dt])
            want = one if B else dict.fromkeys(one, 0)
            check(counts == want, f"{label}: launches {counts}, "
                  f"expected {want}")
            qp, kp, vp = (x.detach().requires_grad_() for x in (q, k, v))
            o_p = fa.flash_attention(qp, kp, vp, mode="plain")
            plain = torch.autograd.grad(o_p, (qp, kp, vp), do)
            for name, a, b in zip(("o", "dq", "dk", "dv"),
                                  (o.detach(),) + grads,
                                  (o_p.detach(),) + plain):
                check(a.shape == b.shape == q.shape and a.dtype == q.dtype
                      and bool(torch.isfinite(a).all()),
                      f"{label}: {name} {a.dtype} {tuple(a.shape)}")
                if B == 0:
                    continue
                if dt == "float32":
                    tol = FLASH_TOL[dt] if name == "o" else BWD_F32_TOL
                    err = close_err(a, b, tol)
                else:
                    tol, err = FLASH_TOL[dt], rel_err(a, b)
                check(err <= tol, f"{label}: {name} != plain ({err} > "
                      f"{tol})")
                errs[f"{dt} {name}"] = float((a.float() - b.float()).abs()
                                             .max())
            out[f"{dt}_{B}"] = counts
    fa.reset_launches()
    secs = time.perf_counter() - t0
    log(f"[mesh] uneven shards at S={S}, H={H}, hd={hd}: the empty shard "
        f"launched {out['bfloat16_0']} (bf16) and {out['float32_0']} (f32) "
        f"and returned the plain version's empty outputs and zero "
        f"gradients; the one-row shard {out['bfloat16_1']} (bf16), "
        f"{out['float32_1']} (f32), max |kernel - plain| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; {secs:.3f} s; {nvidia_smi_line()}")
    return {"counts": out, "max_abs_err": errs, "seconds": secs}


def phase_mesh(dev, train_warm_s):
    """[mesh]: the dense family's train step under the reference's
    parallel plan, through the train driver's ``mesh=`` (DTensor over a
    ``DeviceMesh``, the attention's flash kernels on local shards), one
    process over NCCL on a (data=1, model=1) mesh, SmolLM-360M at full
    width: an f32 copy of the config, ``MESH_STEPS`` steps held to the
    unsharded step of the same model (TP 1, seed 0) per step, and the
    first step's gradients; then ``MESH_STEPS`` bf16 steps over f32
    masters at [train]'s TP of 16, their warm step against [train]'s (no
    profiled step: a depth cut). First, the flash kernels on the empty and
    one-row local shards of an uneven microbatch
    (:func:`mesh_uneven_shards`)."""
    import dataclasses
    import gc
    import math
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.sharding import ctx, place
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.step import (init_state, loss_and_grads,
                                        make_train_step)

    t_phase = time.perf_counter()
    cfg = ARCHS[TRAIN_ARCH]
    L = cfg.num_layers
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    warmup = min(50, MESH_STEPS // 5 + 1)       # the driver's, at 3 steps
    data = SyntheticTokens(cfg32, ShapeConfig("cli", "train", TRAIN_S,
                                              TRAIN_B), seed=0)
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    tmp = tmp_dir.name
    gc.collect()
    torch.cuda.empty_cache()

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def per_step(got, want, rtol, what):
        for s, (a, b) in enumerate(zip(got, want)):
            check(math.isfinite(a) and abs(a - b) <= rtol * abs(b),
                  f"[mesh] {what} step {s}: {a!r} vs {b!r} (rtol {rtol})")
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    uneven = mesh_uneven_shards(dev)
    launch_mesh.init_process_group(dev, store=os.path.join(tmp, "store"))
    try:
        mesh = launch_mesh.init_mesh((1, 1), ("data", "model"), dev)
        backend = dist.get_backend()
        check(backend == "nccl", f"[mesh] the one-process group is {backend}")

        # the unsharded step of the same model (TP 1, seed 0)
        t0 = time.perf_counter()
        model = build_model(cfg32, tp=1, device=dev)
        state = init_state(model, gen())
        _, g_plain = loss_and_grads(model, state["params"], data.batch(0))
        step = make_train_step(model, warmup=warmup, donate=True)
        plain_l, plain_n = [], []
        for s in range(MESH_STEPS):
            state, m = step(state, data.batch(s))
            plain_l.append(float(m["loss"]))
            plain_n.append(float(m["gnorm"]))
        del state, step
        plain_s = time.perf_counter() - t0

        # the first step's gradients, placed on the mesh
        ctx.configure(mesh)
        placed = place.place_state(init_state(model, gen()), mesh,
                                   device=dev)
        _, g_mesh = loss_and_grads(model, placed["params"], data.batch(0))
        worst, bitwise = 0.0, True
        placements = {path: p.placements for path, p, _ in
                      leaf_pairs(placed["params"], placed["params"])}
        for path, a, b in leaf_pairs(g_mesh, g_plain):
            check(a.placements == placements[path], f"[mesh] gradient "
                  f"{path} placed {a.placements}, its parameter "
                  f"{placements[path]}")
            a = a.to_local()
            atol = MESH_GRAD_ATOL * float(b.abs().max())
            err = float(((a - b).abs() - MESH_GRAD_RTOL * b.abs()).max())
            worst = max(worst, float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
            bitwise &= bool(torch.equal(a, b))
            check(err <= atol, f"[mesh] first-step gradient {path}: "
                  f"|g - g_plain| - rtol |g_plain| reaches {err} > {atol}")
        del placed, g_mesh, g_plain, model
        gc.collect()
        torch.cuda.empty_cache()

        # the driver on the mesh, f32: the path
        fa.reset_launches()
        t0 = time.perf_counter()
        out = train(cfg32, steps=MESH_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                    ckpt_dir=None, device=dev, mesh=mesh,
                    log=lambda m: log(f"[mesh] {m}"))
        mesh_s = time.perf_counter() - t0
        f32_launches = dict(fa.COUNTS["float32"])
        want = {"flash_fwd": 2 * L * MESH_STEPS,
                **{k: L * MESH_STEPS for k in fa.BWD_KERNELS}}
        check(f32_launches == want, f"[mesh] f32 flash launches "
              f"{f32_launches}, predicted {want}")
        loss_err = per_step(out["losses"], plain_l, MESH_LOSS_RTOL, "loss")
        norm_err = per_step(out["gnorms"], plain_n, MESH_LOSS_RTOL, "gnorm")
        check(all(x.to_local().shape == x.shape
                  for x in tree_leaves(out["state"]["params"])),
              "[mesh] a shard on a (1, 1) mesh is not its whole leaf")
        losses32, secs32 = out["losses"], out["step_seconds"]
        del out
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[mesh] {cfg.name} f32 ({L} layers, d={cfg.d_model}, vocab "
            f"{cfg.vocab}) on a (data=1, model=1) mesh over {backend}, "
            f"B={TRAIN_B} S={TRAIN_S}, {MESH_STEPS} steps in {mesh_s:.3f} s "
            f"(step s {[round(x, 4) for x in secs32]}): losses "
            f"{[round(x, 6) for x in losses32]} vs unsharded "
            f"{[round(x, 6) for x in plain_l]} (worst relative {loss_err:.3g}"
            f"; norms {norm_err:.3g}; <= {MESH_LOSS_RTOL}); first-step "
            f"gradients worst |g - g_plain| / max |g_plain| {worst:.3g} "
            f"(bitwise equal: {bitwise}); the unsharded run {plain_s:.3f} s; "
            f"f32 flash launches {f32_launches}")

        # bf16 over f32 masters at [train]'s TP, timed against [train]
        fa.reset_launches()
        out = train(cfg, steps=MESH_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                    ckpt_dir=None, device=dev, mesh=mesh, tp=16,
                    log=lambda m: log(f"[mesh] bf16 {m}"))
        bf16_launches = dict(fa.COUNTS["bfloat16"])
        check(bf16_launches == want, f"[mesh] bf16 flash launches "
              f"{bf16_launches}, predicted {want}")
        check(all(math.isfinite(x) for x in out["losses"] + out["gnorms"]),
              f"[mesh] bf16 losses {out['losses']}")
        secs16 = out["step_seconds"]
        warm16 = float(np.median(secs16[1:]))
        del out
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[mesh] bf16 over f32 masters (TP 16, as [train]): step s "
            f"{[round(x, 4) for x in secs16]}, warm {warm16:.4f} (median of "
            f"{len(secs16) - 1}) vs [train]'s warm {train_warm_s:.4f}: "
            f"{warm16 / train_warm_s:.3f}x, {warm16 - train_warm_s:+.4f} s a "
            f"step of DTensor dispatch; bf16 flash launches {bf16_launches}; "
            f"no profiled step (a depth cut)")

        # the decode step under the plan: the bf16 model at TP 16
        model = build_model(cfg, device=dev)
        model.init(gen())
        decode = mesh_decode(dev, mesh, model, prefilled(model, dev),
                             f"[mesh] {cfg.name}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ctx.reset()
        dist.destroy_process_group()

    tmp_dir.cleanup()
    secs = time.perf_counter() - t_phase
    log(f"[mesh] phase {secs:.3f} s")
    return {"launches": bf16_launches, "f32_launches": f32_launches,
            "warm_s": warm16, "decode": decode, "uneven": uneven,
            "seconds": secs}


def train_family_cell(dev, arch):
    """One configuration of ``[train-families]``: (a) ``launch.train.train``
    at full width (``TRAIN_FAMILY_CELLS``; random weights and synthetic
    batches from seed 0, no checkpoints): finite losses and gradient
    norms, the first loss within 0.5 of ln V, exactly 2 forward flash
    launches and 1 of each backward stage per self-attention layer a step,
    cold and warm step seconds, tokens/s; (b) one profiled warm step of
    the driver's own step function on its final state (xLSTM's at a
    shorter sequence, ``TRAIN_FAMILY_PROFILE_S``), and the peak device
    memory; (c) the first step's gradients through the kernels
    against the plain model attention (:func:`first_step`; an MoE's
    recompute routing bitwise equal to its forward's)."""
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train

    cfg = ARCHS[arch]
    B, S, steps = TRAIN_FAMILY_CELLS[arch]
    n_attn = flash_per_forward(cfg)
    tag = f"[train-families] {arch}"
    t_cell = time.perf_counter()
    # the previous cell's model lives on in reference cycles until a
    # collection: freed here, not in the middle of this cell's reading
    gc.collect()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    out = train(cfg, steps=steps, batch=B, seq=S, ckpt_dir=None, device=dev,
                log=lambda m: log(f"{tag} {m}"))
    launches = dict(fa.COUNTS["bfloat16"])
    losses, gnorms, secs = out["losses"], out["gnorms"], out["step_seconds"]
    check(out["start"] == 0 and len(losses) == steps, f"{tag} ran "
          f"{len(losses)} steps from {out['start']}")
    check(all(math.isfinite(x) for x in losses + gnorms), f"{tag} a loss "
          f"or gradient norm is not finite: {losses} {gnorms}")
    ln_v = math.log(cfg.vocab)
    check(abs(losses[0] - ln_v) < 0.5, f"{tag} first loss {losses[0]} is "
          f"not within 0.5 of ln V = {ln_v:.4f}")
    want = {"flash_fwd": 2 * n_attn * steps,
            **{k: n_attn * steps for k in fa.BWD_KERNELS}}
    check(launches == want, f"{tag} flash launches {launches}, predicted "
          f"{want} (per step: {2 * n_attn} forward with remat, {n_attn} of "
          f"each backward)")
    cold_s, warm_s = secs[0], float(np.median(secs[1:]))
    tok_s = out["tokens_per_step"] / warm_s
    prof_s = TRAIN_FAMILY_PROFILE_S.get(arch, S)
    batch = SyntheticTokens(cfg, ShapeConfig("cli", "train", prof_s, B),
                            seed=0).batch(steps)
    state, step_fn = out["state"], out["step_fn"]
    n_params = out["params"]
    del out
    prof = device_breakdown(lambda: step_fn(state, batch), 1, PROFILE_OUT)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_peak_b = torch.cuda.max_memory_allocated(dev) - base
    del state, step_fn, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    first = first_step(cfg, dev, B, S, tag)
    first_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    secs_cell = time.perf_counter() - t_cell
    log(f"{tag} ({cfg.family}, {n_params / 1e6:.3f}M params, f32 masters, "
        f"{cfg.dtype} activations) (a) B={B} S={S}, {steps} steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (ln V = {ln_v:.4f}); step s "
        f"cold {cold_s:.4f}, warm {warm_s:.4f} (median of {steps - 1}; min "
        f"{min(secs[1:]):.4f}, max {max(secs[1:]):.4f}), {tok_s:.1f} "
        f"tokens/s; flash launches {launches} ({2 * n_attn} forward and "
        f"{n_attn} of each backward per step); (b) profiled warm step "
        f"(S={prof_s}): {breakdown_text(prof)}; peak memory {peak_gb:.2f} "
        f"GiB ({step_peak_b / 2 ** 30:.3f} GiB beyond the "
        f"{base / 2 ** 30:.3f} GiB allocated before the cell)")
    log(f"{tag} (c) first step, kernels vs plain attention: "
        f"{first_step_text(first)} in {first_s:.3f} s; the cell "
        f"{secs_cell:.3f} s")
    return {"params": n_params, "launches": launches,
            "f32_launches": first["f32_launches"], "losses": losses,
            "cold_s": cold_s, "warm_s": warm_s, "tokens_per_s": tok_s,
            "step": prof, "profile_s": prof_s, "peak_gib": peak_gb,
            "step_peak": step_peak_b,
            "first_step_s": first_s, "first": first,
            "seconds": secs_cell}


def phase_train_families(dev):
    """[train-families]: the train entry point at full width for the
    families one card holds with AdamW in f32 (``TRAIN_FAMILY_CELLS``: the
    MoE backward, Whisper's non-causal and causal flash backward at
    S=1500, the xLSTM recurrences' backward), one at a time, each freed
    before the next (:func:`train_family_cell`)."""
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    cells = {arch: train_family_cell(dev, arch)
             for arch in TRAIN_FAMILY_CELLS}
    launches = {"flash_fwd": sum(c["launches"]["flash_fwd"]
                                 for c in cells.values()),
                **{k: sum(c["launches"][k] for c in cells.values())
                   for k in fa.BWD_KERNELS}}
    f32_launches = {k: sum(c["f32_launches"][k] for c in cells.values())
                    for k in launches}
    saved = sum((TRAIN_FAMILY_STEPS_BEFORE[a] - TRAIN_FAMILY_CELLS[a][2])
                * cells[a]["warm_s"] for a in TRAIN_FAMILY_STEPS_BEFORE)
    log(f"[train-families] flash launches {launches}; the first steps' f32 "
        f"kernel passes {f32_launches}; (a) at 6 steps, not 10, for "
        f"granite-moe and Whisper saves {saved:.3f} s (4 warm steps each "
        f"at this run's warm step s)")
    mesh = phase_mesh_families(dev, {a: c.pop("first")
                                     for a, c in cells.items()})
    secs = time.perf_counter() - t_phase
    log(f"[train-families] the phase {secs:.3f} s in all")
    return {"launches": launches, "f32_launches": f32_launches,
            "cells": cells, "mesh": mesh, "seconds": secs}


def unsharded_f32_first_step(dev, cfg, B, S) -> dict:
    """The f32 first step's loss and gradient bits of ``cfg`` (seed-0
    parameters at TP 16, the train CLI's batch 0) through the kernels,
    unsharded: what (c) keeps for a full-width cell."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.train.step import loss_and_grads

    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    batch = SyntheticTokens(cfg, ShapeConfig("cli", "train", S, B),
                            seed=0).batch(0)
    loss, g = loss_and_grads(model, model.param_tree(), batch)
    return {"f32_loss": float(loss), "f32_bits": grad_bits(g),
            "routes": []}


def mesh_family_cell(dev, mesh, tag, cfg, B, S, want) -> dict:
    """One configuration of (d) on the (1, 1) ``mesh``: the f32 first step
    through ``train(mesh=)`` (one step, the model at TP 16 as (c)'s) and
    ``loss_and_grads`` on the placed seed-0 parameters, an MoE replaying
    (c)'s recorded routings as (c)'s f32 pass did; the loss and every
    gradient leaf's bits against ``want``'s."""
    import contextlib
    import gc

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.sharding import place
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.step import loss_and_grads

    def replay():
        return routing(want["routes"], replay=True) if want["routes"] \
            else contextlib.nullcontext()

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with replay():
        out = train(cfg, steps=1, batch=B, seq=S, ckpt_dir=None, device=dev,
                    mesh=mesh, tp=16, log=lambda m: None)
    loss = out["losses"][0]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    check(loss == want["f32_loss"], f"[train-families] (d) {tag}: "
          f"train(mesh=)'s first loss {loss!r} != the unsharded f32 "
          f"kernel pass's {want['f32_loss']!r}")
    model = build_model(cfg, tp=16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    params = place.place_params(tree_map(torch.Tensor.detach,
                                         model.param_tree()), mesh,
                                device=dev)
    batch = SyntheticTokens(cfg, ShapeConfig("cli", "train", S, B),
                            seed=0).batch(0)
    with replay():
        g_loss, grads = loss_and_grads(model, params, batch)
    bits = grad_bits(grads)
    del model, params, grads
    g_loss = float(g_loss)
    check(g_loss == want["f32_loss"], f"[train-families] (d) {tag}: the "
          f"placed first step's loss {g_loss!r} != {want['f32_loss']!r}")
    check(sorted(bits) == sorted(want["f32_bits"]), f"[train-families] "
          f"(d) {tag}: gradient leaves {sorted(bits)}")
    apart = [p for p in bits if bits[p] != want["f32_bits"][p]]
    check(not apart, f"[train-families] (d) {tag}: the placed gradients' "
          f"bits differ from the unsharded f32 kernel pass's at {apart}")
    secs = time.perf_counter() - t0
    log(f"[train-families] (d) {tag} ({cfg.family}, B={B} S={S}, f32) on "
        f"a (1, 1) mesh: train(mesh=)'s first loss {loss!r} and the placed "
        f"gradients' {len(bits)} leaves bitwise equal to the unsharded f32 "
        f"kernel pass's; {secs:.3f} s")
    return {"loss": loss, "leaves": len(bits), "seconds": secs}


def phase_mesh_families(dev, firsts: dict) -> dict:
    """[train-families] (d): every family but the dense one under the
    reference's parallel plan (``train(mesh=)`` and ``loss_and_grads`` on
    the placed state, DTensor over a one-process NCCL ``DeviceMesh`` of
    shape (data=1, model=1)), f32, each first step bitwise equal to the
    unsharded f32 kernel pass of the same config, seed and batch: the
    full-width cells' (``firsts``, kept by (c)), granite-moe under each of
    its three dispatches; Jamba and Qwen2-VL at the CPU tests' reduced
    widths against their own unsharded pass, run first. The flash launches
    of the mesh runs are the path ``mesh_families``, counted from 0."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.sharding import ctx

    t_phase = time.perf_counter()
    cells = []
    for arch, first in firsts.items():
        cfg = dataclasses.replace(ARCHS[arch], dtype="float32")
        B, S, _ = TRAIN_FAMILY_CELLS[arch]
        for d in MESH_FAMILY_DISPATCHES if cfg.moe is not None else (None,):
            c = cfg if d is None else dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, dispatch=d))
            cells.append((arch + (f" {d}" if d else ""), c, B, S, first))
    B, S = MESH_FAMILY_REDUCED_CELL
    for arch, widths in MESH_FAMILY_REDUCED.items():
        cfg = dataclasses.replace(reduced(ARCHS[arch]), **widths)
        cells.append((f"{arch} (reduced)", cfg, B, S,
                      unsharded_f32_first_step(dev, cfg, B, S)))
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_families_")
    launch_mesh.init_process_group(dev, store=os.path.join(tmp_dir.name,
                                                           "store"))
    fa.reset_launches()
    try:
        mesh = launch_mesh.init_mesh((1, 1), ("data", "model"), dev)
        rows = {tag: mesh_family_cell(dev, mesh, tag, cfg, B, S, want)
                for tag, cfg, B, S, want in cells}
        launches = dict(fa.COUNTS["float32"])
    finally:
        ctx.reset()
        dist.destroy_process_group()
        tmp_dir.cleanup()
    # two passes a cell (train(mesh=)'s step and the placed gradients), each
    # a forward, its recompute and one backward of every attention layer
    n_attn = sum(flash_per_forward(cfg) for _, cfg, _, _, _ in cells)
    want = {"flash_fwd": 4 * n_attn,
            **{k: 2 * n_attn for k in fa.BWD_KERNELS}}
    check(launches == want, f"[train-families] (d) f32 flash launches "
          f"{launches}, predicted {want}")
    check(not any(fa.COUNTS["bfloat16"].values()), f"[train-families] (d) "
          f"bf16 flash launches {fa.COUNTS['bfloat16']}")
    secs = time.perf_counter() - t_phase
    log(f"[train-families] (d) {len(cells)} configurations on a (1, 1) "
        f"mesh, every first step bitwise equal to its unsharded f32 kernel "
        f"pass; f32 flash launches {launches}; (d) {secs:.3f} s")
    return {"launches": launches, "cells": rows, "seconds": secs}


def roofline_plan() -> list[dict]:
    """The steps the script times, in the order :func:`roofline_readings`
    reads them, with what the dry run needs to count each: its config,
    step, batch, sequence, and the sequence its busy time is profiled
    at."""
    from repro_torch.configs import ARCHS

    def row(label, cfg, step, B, S, busy_S):
        return {"label": label, "cfg": cfg, "step": step, "B": B, "S": S,
                "busy_S": busy_S}

    plan = [row(f"[model] {ARCH} loss forward", ARCHS[ARCH], "loss",
                MODEL_B, MODEL_S, MODEL_S),
            row(f"[model] {ARCH} decode step (cache 512)", ARCHS[ARCH],
                "decode", 4, 512, 512),
            row(f"[train] (a) {TRAIN_ARCH} step", ARCHS[TRAIN_ARCH], "train",
                TRAIN_B, TRAIN_S, TRAIN_S)]
    for arch, (S, _) in FAMILY_CELLS.items():
        plan.append(row(f"[families] {arch} loss forward",
                        family_config(arch), "loss", 1, S,
                        FAMILY_PROFILE_S.get(arch, S)))
    for arch, (B, S, _) in TRAIN_FAMILY_CELLS.items():
        plan.append(row(f"[train-families] {arch} step", ARCHS[arch],
                        "train", B, S, TRAIN_FAMILY_PROFILE_S.get(arch, S)))
    return plan


def roofline_count(plan: list[dict]) -> list[dict]:
    """Each step of ``plan`` counted by the dry run
    (``launch.dryrun.trace_step`` on the meta device, at the step's config,
    shape and dtype, self-attention as the flash kernels that run on the
    card; nothing is launched), and its roofline terms on one H100, at its
    sequence and at the one its busy time is profiled at. Needs no
    reading, so ``main`` counts while it waits for the ``[cpu]`` child."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import roofline_hw, trace_step
    from repro_torch.roofline.analysis import roofline_terms

    t0 = time.perf_counter()

    def count(st, S):
        kind = {"loss": "prefill"}.get(st["step"], st["step"])
        tr = trace_step(st["cfg"], ShapeConfig("roofline", kind, S, st["B"]),
                        step=st["step"], donate=True, attention="kernel")
        hw = roofline_hw(st["cfg"])
        return tr, hw, roofline_terms(tr.flops, tr.bytes, 0.0, 1, hw)

    out = []
    for st in plan:
        tr, hw, terms = count(st, st["S"])
        busy = terms if st["busy_S"] == st["S"] else count(
            st, st["busy_S"])[2]
        out.append({**st, "flops": tr.flops, "bytes": tr.bytes,
                    "argument_bytes": tr.argument_bytes,
                    "temp_bytes": tr.temp_bytes, "hw": hw.name,
                    "terms": terms, "busy_terms": busy})
    secs = time.perf_counter() - t0
    log(f"[roofline] {len(out)} steps counted in {secs:.3f} s (limit "
        f"{ROOFLINE_SECONDS} s)")
    check(secs <= ROOFLINE_SECONDS, f"[roofline] counting took {secs:.3f} s")
    return out


def roofline_readings(model_run, train_run, families_run,
                      train_families_run) -> list[dict]:
    """What the phases measured of each step, in :func:`roofline_plan`'s
    order: the warm wall seconds, the profiled busy ms, the step's peak
    device memory (bytes; None for decode)."""
    def row(wall_s, busy, peak):
        return {"wall_s": wall_s, "busy_ms": busy["busy_ms"], "peak": peak}

    dec = model_run["decode_step"]
    return ([row(model_run["warm_s"], model_run["forward"],
                 model_run["loss_peak"]),
             row(dec["wall_ms"] / 1e3, dec, None),
             row(train_run["warm_s"], train_run["step"], train_run["a_peak"])]
            + [row(families_run["cells"][arch]["warm_s"],
                   families_run["cells"][arch]["forward"],
                   families_run["cells"][arch]["loss_peak"])
               for arch in FAMILY_CELLS]
            + [row(train_families_run["cells"][arch]["warm_s"],
                   train_families_run["cells"][arch]["step"],
                   train_families_run["cells"][arch]["step_peak"])
               for arch in TRAIN_FAMILY_CELLS])


def phase_roofline(counts: list[dict], readings: list[dict]) -> list[dict]:
    """[roofline]: each step the script timed against its least time on
    one H100 (:func:`roofline_count`): the bound over the warm wall time
    and over the profiled device-busy time must each be at most
    ``ROOFLINE_SHARE_MAX``, a larger share meaning a wrong count; the
    predicted peak memory (the step's arguments plus its temporaries)
    within ``ROOFLINE_PEAK_RATIO`` of the measured one either way."""
    t_phase = time.perf_counter()
    check(len(counts) == len(readings), f"[roofline] {len(counts)} steps "
          f"counted, {len(readings)} read")
    rows = []
    for c, m in zip(counts, readings):
        terms, b_terms = c["terms"], c["busy_terms"]
        share = terms["bound_s"] / m["wall_s"]
        busy_share = (None if m["busy_ms"] is None
                      else 1e3 * b_terms["bound_s"] / m["busy_ms"])
        predicted = c["argument_bytes"] + c["temp_bytes"]
        ratio = None if m["peak"] is None else predicted / m["peak"]
        r = {k: c[k] for k in ("label", "B", "S", "busy_S", "flops", "bytes",
                               "argument_bytes", "temp_bytes", "hw")}
        r.update(bound_ms=1e3 * terms["bound_s"],
                 dominant=terms["dominant"],
                 busy_bound_ms=1e3 * b_terms["bound_s"], **m,
                 share_of_wall=share, share_of_busy=busy_share,
                 predicted_peak=predicted, measured_peak=m["peak"],
                 peak_ratio=ratio)
        rows.append(r)
        at = ("" if c["busy_S"] == c["S"]
              else f", counted again at S={c['busy_S']}: "
              f"{r['busy_bound_ms']:.4f} ms")
        busy_txt = ("busy not measured" if busy_share is None else
                    f"{busy_share:.4f} of the profiled busy "
                    f"{m['busy_ms']:.3f} ms{at}")
        peak_txt = ("" if ratio is None else
                    f"; predicted peak {predicted / 2 ** 30:.3f} GiB "
                    f"(arguments {c['argument_bytes'] / 2 ** 30:.3f} + temp "
                    f"{c['temp_bytes'] / 2 ** 30:.3f}) vs measured "
                    f"{m['peak'] / 2 ** 30:.3f} GiB ({ratio:.3f}x)")
        log(f"[roofline] {c['label']}, B={c['B']} S={c['S']}: "
            f"{c['flops']:.6g} FLOPs, {c['bytes']:.6g} bytes; bound "
            f"{r['bound_ms']:.4f} ms ({terms['dominant']}, {c['hw']}); "
            f"share {share:.4f} of the warm {m['wall_s']:.4f} s, "
            f"{busy_txt}{peak_txt}")
        for name, val in (("wall", share), ("busy", busy_share)):
            check(val is None or val <= ROOFLINE_SHARE_MAX,
                  f"[roofline] {c['label']}: the bound is {val:.4f} of "
                  f"the {name} time, over {ROOFLINE_SHARE_MAX}: the count "
                  f"is wrong")
        check(ratio is None or 1 / ROOFLINE_PEAK_RATIO <= ratio
              <= ROOFLINE_PEAK_RATIO, f"[roofline] {c['label']}: "
              f"predicted peak {predicted} bytes vs measured {m['peak']}")
    secs = time.perf_counter() - t_phase
    os.makedirs(os.path.dirname(ROOFLINE_OUT), exist_ok=True)
    with open(ROOFLINE_OUT, "w") as f:
        json.dump(rows, f, indent=1)
    log(f"[roofline] {len(rows)} steps held to their bounds in {secs:.3f} "
        f"s (limit {ROOFLINE_SECONDS} s); rows in {ROOFLINE_OUT}")
    check(secs <= ROOFLINE_SECONDS, f"[roofline] took {secs:.3f} s")
    return rows


def example_launches() -> dict:
    """Every kernel's launch count since the last
    :func:`reset_example_launches`: the scheduler kernels' and each flash
    stage's by input type (``flash_fwd_float32``, ...)."""
    from repro_torch.kernels import carbon_cost, gain_scan
    from repro_torch.kernels import flash_attention as fa

    return {"gain_scan": gain_scan.LAUNCHES,
            "carbon_cost": carbon_cost.LAUNCHES,
            **{f"{name}_{dt}": n for dt, c in fa.COUNTS.items()
               for name, n in c.items()}}


def reset_example_launches() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import carbon_cost, gain_scan
    from repro_torch.kernels import flash_attention as fa

    gain_scan.LAUNCHES = carbon_cost.LAUNCHES = 0
    fa.reset_launches()


def phase_examples() -> dict:
    """[examples]: the port's four examples, each through ``main(argv)``
    with no ``--device`` (the card), held to the reference examples'
    output (the ``QUICKSTART_*``, ``FLEET_*``, ``SERVE_*`` and
    ``TRAIN_EXAMPLE_*`` constants): (a) quickstart's 17-variant cost table,
    every -LS cost at or below its greedy cost, the exact audit's optimum;
    (b) the fleet's robust variants and worst-member costs on the 1-s
    fallback, the joint mapping search and the three rolling windows; (c)
    serve at its defaults, its admission plan, coalescing and degradation,
    a trace of parseable JSONL with every span, every request finished;
    (d) train on the 100M config at full width with injected failures:
    the plan, the waits, one restart, the simulated clock, finite losses,
    the last below the first. Each example's kernel launches are counted
    from 0; the fleet must launch the gain kernel and train the f32 flash
    forward and every backward stage. Returns each example's seconds and
    launches."""
    import math
    import tempfile

    import torch

    from repro_torch.examples import (fleet_scheduler, quickstart,
                                      serve_batched, train_carbon_aware)
    from repro_torch.kernels.flash_attention import BWD_KERNELS

    t_phase = time.perf_counter()
    os.makedirs(os.path.dirname(EXAMPLES_TRACE), exist_ok=True)
    if os.path.exists(EXAMPLES_TRACE):
        os.remove(EXAMPLES_TRACE)
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_examples_")
    runs = {}

    def drive(name, module, argv):
        reset_example_launches()
        t0 = time.perf_counter()
        out = module.main(argv)
        torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "launches": {k: n for k, n in example_launches().items()
                                   if n}}
        check(out["device"].startswith("cuda"), f"[examples] {name} ran on "
              f"{out['device']}")
        return out

    # (a) quickstart
    q = drive("quickstart", quickstart, [])
    check(q["asap"] == QUICKSTART_ASAP and q["costs"] == QUICKSTART_COSTS,
          f"[examples] (a) quickstart's costs: ASAP {q['asap']}, "
          f"{q['costs']}")
    check(all(c <= q["costs"][v.removesuffix("-LS")]
              for v, c in q["costs"].items() if v.endswith("-LS")),
          f"[examples] (a) an -LS cost above its greedy cost: {q['costs']}")
    check(q["optimum"] == QUICKSTART_OPTIMUM and q["gap"] >= 1.0,
          f"[examples] (a) exact audit: optimum {q['optimum']}, gap "
          f"{q['gap']}")

    # (b) fleet
    f = drive("fleet_scheduler", fleet_scheduler, [])
    check(set(f["step_sources"].values()) == {fleet_scheduler.FALLBACK},
          f"[examples] (b) the fleet read dry-run records: "
          f"{f['step_sources']}")
    got = {n: (r["robust"], r["worst"], r["asap_worst"])
           for n, r in f["fleets"].items()}
    check(got == FLEET_ROBUST, f"[examples] (b) robust picks {got}")
    check(f["joint"] == FLEET_JOINT, f"[examples] (b) joint {f['joint']}")
    check(f["windows"] == FLEET_WINDOWS,
          f"[examples] (b) windows {f['windows']}")
    check(runs["fleet_scheduler"]["launches"].get("gain_scan", 0) > 0,
          "[examples] (b) the fleet never launched the gain kernel")

    # (c) serve at its defaults
    s = drive("serve_batched", serve_batched, ["--trace-out", EXAMPLES_TRACE])
    a = s["admission"]
    check({k: a[k] for k in SERVE_ADMISSION} == SERVE_ADMISSION
          and not a["degraded"], f"[examples] (c) admission {a}")
    with open(EXAMPLES_TRACE) as fh:
        spans = [json.loads(line) for line in fh]
    check(len(spans) == SERVE_ADMISSION["spans"], f"[examples] (c) "
          f"{len(spans)} spans in {EXAMPLES_TRACE}")
    check(all(r.done for r in s["requests"]) and len(s["requests"]) == 12,
          "[examples] (c) a request did not finish")

    # (d) train, the 100M config
    t = drive("train_carbon_aware", train_carbon_aware,
              TRAIN_EXAMPLE_ARGV + ["--ckpt-dir",
                                    os.path.join(ckpt.name, "ckpt")])
    ckpt.cleanup()
    losses = [loss for loss, _ in t["logged"].values()]
    check((t["cost"], t["asap_cost"]) == TRAIN_EXAMPLE_PLAN,
          f"[examples] (d) plan {t['cost']} vs {t['asap_cost']}")
    check(t["waits"] == TRAIN_EXAMPLE_WAITS, f"[examples] (d) waits "
          f"{t['waits']}")
    check((t["steps"], t["restarts"], t["clock"]) == TRAIN_EXAMPLE_END,
          f"[examples] (d) {t['steps']} steps, {t['restarts']} restarts, "
          f"clock {t['clock']}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"[examples] (d) losses {losses}")
    tl = runs["train_carbon_aware"]["launches"]
    check(all(tl.get(f"{k}_float32", 0) > 0
              for k in ("flash_fwd",) + BWD_KERNELS),
          f"[examples] (d) an f32 flash stage was never launched: {tl}")

    secs = time.perf_counter() - t_phase
    for name, r in runs.items():
        log(f"[examples] {name}: {r['seconds']:.3f} s, launches "
            f"{r['launches']}")
    log(f"[examples] (a) quickstart ASAP {q['asap']}, best {q['best']}, "
        f"exact optimum {q['optimum']} (gap {q['gap']:.3f}); (b) fleet "
        f"robust {got}, joint {f['joint']}, windows {f['windows']}; (c) "
        f"serve {a['chunks']} chunks {a['cost']} vs {a['asap_cost']} starts "
        f"{a['starts']}, {a['coalesced']} coalesced into {a['batches']}, "
        f"degraded to {a['fallback_stage']}, {len(spans)} spans; (d) train "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"[examples] four examples in {secs:.3f} s (limit "
        f"{EXAMPLES_SECONDS} s)")
    check(secs <= EXAMPLES_SECONDS, f"[examples] took {secs:.3f} s")
    return runs


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

    eager = KINDS.index("eager")           # the smallest instance
    cpu_job = start_cpu(eager)
    build_kernels()
    t0 = time.perf_counter()
    plat, insts, grid = build_matrix()
    log(f"[matrix] built in {time.perf_counter() - t0:.3f} s")
    roofline_counts = roofline_count(roofline_plan())   # while [cpu] runs
    cpu_run = wait_cpu(cpu_job)
    gain_rows = phase_kernels(dev)
    deficit_rows = phase_deficit(dev)
    card, launches, cold_s = phase_plan(plat, insts, grid)
    cost_launches, oracle_ms = phase_cost_oracle(insts, grid, card, dev)
    phase_cpu(cpu_run, grid, card, eager)
    phase_blocked(plat, insts, grid, card, eager)
    sharded_run = phase_sharded(plat, insts, grid, card,
                                torch.device("cuda", 0))
    exact_launches = phase_exact()
    session_launches = phase_session(plat, insts[eager])
    mapping_run = phase_mapping(plat)
    service_run = phase_service(plat, insts, grid, card, cold_s)
    flash_rows, bwd_rows = phase_flash(dev)
    model_run = phase_model(dev)
    serve_run = phase_serve(dev)
    train_run = phase_train(dev)
    families_run = phase_families(dev)
    train_families_run = phase_train_families(dev)
    phase_roofline(roofline_counts, roofline_readings(
        model_run, train_run, families_run, train_families_run))
    examples_run = phase_examples()
    mesh_run = phase_mesh(dev, train_run["warm_s"])

    from repro_torch.kernels.flash_attention import (
        BWD_KERNEL_NAMES as bwd_names, BWD_KERNELS as bwd_kernels)

    def examples(key):
        """The examples' launches of one kernel (``example_launches``'s
        key), summed over the four."""
        return sum(r["launches"].get(key, 0) for r in examples_run.values())

    # the f32 kernels run in checks beside the main paths, each counted on
    # its own: [model]'s and [families]' f32 gates, [serve]'s forward ==
    # decode check, the first steps' f32 kernel passes ([train] (b),
    # [train-families] (c)); and on main paths of their own, the train
    # example's 100M config in f32 ([examples] (d)), [mesh]'s f32 run and
    # the families under the parallel plan ([train-families] (d))
    f32_fwd = {"model_f32_gate": model_run["f32_launches"],
               "serve_forward_vs_decode": serve_run["eq_launches"],
               "families_f32_gate": families_run["f32_launches"],
               "train_first_step": train_run["f32_launches"]["flash_fwd"],
               "train_families_first_step":
                   train_families_run["f32_launches"]["flash_fwd"],
               "examples": examples("flash_fwd_float32"),
               "mesh": mesh_run["f32_launches"]["flash_fwd"],
               "mesh_families":
                   train_families_run["mesh"]["launches"]["flash_fwd"]}
    f32_bwd = {"train_first_step": train_run["f32_launches"],
               "train_families_first_step":
                   train_families_run["f32_launches"],
               "examples": {k: examples(f"{k}_float32")
                            for k in bwd_kernels},
               "mesh": mesh_run["f32_launches"],
               "mesh_families": train_families_run["mesh"]["launches"]}
    # the examples' launches of the other kernels, where they ran
    ran = {k: examples(k) for k in ("gain_scan", "carbon_cost",
                                    "flash_fwd_bfloat16")}
    ran_bwd = sum(examples(f"{k}_bfloat16") for k in bwd_kernels)
    by_examples = {k: {"examples": n} if n else {} for k, n in ran.items()}
    check(all(n > 0 for n in f32_fwd.values()),
          f"an f32 check launched no f32 flash forward: {f32_fwd}")
    check(all(c[k] > 0 for c in f32_bwd.values() for k in bwd_kernels),
          f"an f32 first step launched an f32 flash backward stage no "
          f"time: {f32_bwd}")
    bwd_note = ("no TPU kernel: the reference differentiates its plain "
                "chunked attention through XLA "
                "(src/repro/models/layers.py:112); the port's attention "
                "runs through the forward kernel, whose gradient these "
                "kernels compute")
    bwd_library = ("torch.autograd.grad of "
                   "torch.nn.functional.scaled_dot_product_attention")

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
                             "service": service_run["gain_scan"],
                             "sharded": sharded_run["gain_scan"],
                             **by_examples["gain_scan"]},
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
        + service_run["carbon_cost"] + ran["carbon_cost"],
        "launches_by_path": {"cost": cost_launches,
                             "exact": exact_launches["carbon_cost"],
                             "session": session_launches["carbon_cost"],
                             "mapping": mapping_run["carbon_cost"],
                             "service": service_run["carbon_cost"],
                             **by_examples["carbon_cost"]},
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
        "kernel": FWD_KERNEL_NAMES["bfloat16"],
        "launches": model_run["launches"] + serve_run["launches"]
        + train_run["launches"]["flash_fwd"] + families_run["launches"]
        + train_families_run["launches"]["flash_fwd"]
        + ran["flash_fwd_bfloat16"] + mesh_run["launches"]["flash_fwd"],
        "launches_by_path": {
            "model": model_run["launches"],
            "serve": serve_run["launches"],
            "train": train_run["launches"]["flash_fwd"],
            "families": families_run["launches"],
            "train_families": train_families_run["launches"]["flash_fwd"],
            **by_examples["flash_fwd_bfloat16"],
            "mesh": mesh_run["launches"]["flash_fwd"]},
        **{k: flash_rows["bfloat16"][k] for k in (
            "max_abs_err", "ms", "ms_from", "event_ms", "graph_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "bfloat16_hd128": flash_rows["bfloat16_hd128"],
        "families_shapes": families_run["flash"],
    }, {
        "name": "flash_attention_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "kernel": FWD_KERNEL_NAMES["float32"],
        "launches": sum(f32_fwd.values()),
        "launches_by_path": f32_fwd,
        **{k: flash_rows["float32"][k] for k in (
            "max_abs_err", "ms", "ms_from", "event_ms", "graph_ms",
            "plain_ms", "bound_ms", "bound_by", "cuda_core_bound_ms",
            "library_ms", "shape")},
        "library_call": "torch.nn.functional.scaled_dot_product_attention",
        "float32_hd128": flash_rows["float32_hd128"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": None,
        "note": bwd_note,
        "kernels": list(bwd_names[torch.bfloat16]),
        "launches": sum(run["launches"][k] for k in bwd_kernels
                        for run in (train_run, train_families_run,
                                    mesh_run))
        + ran_bwd,
        "launches_by_kernel": {
            name: train_run["launches"][k]
            + train_families_run["launches"][k] + examples(f"{k}_bfloat16")
            + mesh_run["launches"][k]
            for k, name in zip(bwd_kernels, bwd_names[torch.bfloat16])},
        "launches_by_path": {
            "train": sum(train_run["launches"][k] for k in bwd_kernels),
            "train_families": sum(train_families_run["launches"][k]
                                  for k in bwd_kernels),
            **({"examples": ran_bwd} if ran_bwd else {}),
            "mesh": sum(mesh_run["launches"][k] for k in bwd_kernels)},
        **{k: bwd_rows["bfloat16"][k] for k in (
            "max_abs_err", "ms", "ms_from", "kernel_ms", "event_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_busy_ms", "shape")},
        "library_call": bwd_library,
        "bfloat16_hd128": bwd_rows["bfloat16_hd128"],
        "bfloat16_train": bwd_rows["bfloat16_train"],
        "whisper_encoder": bwd_rows["whisper_encoder"],
        "whisper_decoder": bwd_rows["whisper_decoder"],
    }, {
        "name": "flash_attention_bwd_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": None,
        "note": bwd_note,
        "kernels": list(bwd_names[torch.float32]),
        "launches": sum(c[k] for c in f32_bwd.values() for k in bwd_kernels),
        "launches_by_kernel": {
            name: sum(c[k] for c in f32_bwd.values())
            for k, name in zip(bwd_kernels, bwd_names[torch.float32])},
        "launches_by_path": {path: sum(c[k] for k in bwd_kernels)
                             for path, c in f32_bwd.items()},
        **{k: bwd_rows["float32"][k] for k in (
            "max_abs_err", "ms", "ms_from", "kernel_ms", "event_ms",
            "plain_ms", "bound_ms", "bound_by", "cuda_core_bound_ms",
            "library_ms", "library_busy_ms", "shape")},
        "library_call": bwd_library,
        "float32_hd128": bwd_rows["float32_hd128"],
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
