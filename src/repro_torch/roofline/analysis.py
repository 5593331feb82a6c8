"""Roofline analysis from dry-run counts (no hardware needed): a copy of
``repro.roofline.analysis`` (framework-free, copied rather than imported),
with the H100's rates beside the reference's TPU v5e.

Terms (per step, seconds):
  compute    = HLO_FLOPs / (chips * peak_FLOPs)
  memory     = HLO_bytes / (chips * HBM_bw)
  collective = collective_bytes_per_chip / link_bw

In the reference, HLO_FLOPs/bytes come from ``compiled.cost_analysis()``
(whole-program, all chips); in the port they are counted op by op over the
traced step (:mod:`repro_torch.launch.dryrun`). Collective bytes are
parsed from the post-SPMD HLO text (``compiled.as_text()``), whose shapes
are *per-device*, by summing operand sizes of every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 / chip
    hbm_bw: float = 819e9               # bytes/s / chip
    link_bw: float = 50e9               # bytes/s / link (ICI)
    hbm_bytes: float = 16e9


HW = HWSpec()

# One NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet, SXM5 column,
# dense rates without sparsity, at the 700 W power limit): bf16 tensor-core
# peak 989.4 TFLOP/s, HBM3 3.35 TB/s, NVLink 900 GB/s in both directions
# (450 GB/s each way), 80 GB. H100_F32 is the same card at the f32 rate
# outside the tensor cores (66.9 TFLOP/s): the rate of f32 matrix products
# with TF32 switched off. H100_TF32 is its dense TF32 tensor-core rate (494.7
# TFLOP/s, same datasheet); an f32-accurate product split into three TF32
# products (the f32 flash kernels) runs at a third of it.
H100 = HWSpec(name="h100-sxm5", peak_flops=989.4e12, hbm_bw=3.35e12,
              link_bw=450e9, hbm_bytes=80e9)
H100_F32 = dataclasses.replace(H100, name="h100-sxm5-f32",
                               peak_flops=66.9e12)
H100_TF32 = dataclasses.replace(H100, name="h100-sxm5-tf32",
                                peak_flops=494.7e12)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
# operand tokens look like "f32[8,128]{1,0} %name" / "bf16[4096] param.3"
_OPERAND_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\](?:\{[^}]*\})?\s+%?[a-z]")
_OP_RE = re.compile(
    r"=\s*.*?\b(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(-start|-done)?\(")


def _shape_bytes(dtype: str, dims: str) -> int:
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0
    if not dims:
        return b
    n = 1
    for d in dims.split(","):
        n *= int(d)
    return n * b


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes by collective kind, from post-SPMD HLO text."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        ls = line.lstrip()
        m = _OP_RE.search(ls)
        if not m:
            continue
        kind, phase = m.group(1), m.group(2)
        if phase == "-done":            # counted at -start
            continue
        # operand shapes inside the call parens ("type{layout} %name")
        paren = ls[m.end() - 1:]
        cut = paren.find("), ")
        if cut > 0:
            paren = paren[:cut + 1]
        shapes = _OPERAND_RE.findall(paren)
        if not shapes:                  # fall back to the result type
            shapes = _SHAPE_RE.findall(ls.split("=", 1)[1])[:1]
        nbytes = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        out[kind] += nbytes
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    return out


def _loop_trip_counts(hlo_text: str) -> float:
    """Best-effort: cost_analysis already multiplies through while loops;
    the HLO text does not, so collectives inside scans are undercounted.
    We extract `trip_count=N` backend hints when present (XLA CPU/TPU often
    annotate known trip counts); callers can also pass explicit factors."""
    return 1.0


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes_per_chip: float, chips: int,
                   hw: HWSpec = HW) -> dict:
    compute = flops / (chips * hw.peak_flops)
    memory = bytes_accessed / (chips * hw.hbm_bw)
    collective = coll_bytes_per_chip / hw.link_bw
    dominant = max(
        (("compute", compute), ("memory", memory),
         ("collective", collective)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": max(compute, memory, collective),
    }
