"""Attention-head plan for tensor parallelism (``repro.sharding.ctx``'s
``head_plan``, copied).

The port runs one card and needs no logical-axis constraints, so the
reference's ``configure``/``shard`` have no counterpart here; the head plan
stays because it decides the parameter shapes: a model's padded head counts
must equal the reference's for its weights to carry across.
"""
from __future__ import annotations


def head_plan(num_heads: int, kv_heads: int, tp: int = 16):
    """Baseline TP plan for attention heads.

    Returns (Hq_pad, Hkv_pad, shard_heads). Pads q heads to a multiple of
    ``tp`` and kv heads to a divisor of the padded q count, so the grouped
    (repeat-kv) einsum shards cleanly on the head axis. Tiny models
    (Hq < tp/2) replicate heads instead (their FFN still shards).
    """
    if num_heads < tp // 2:
        return num_heads, kv_heads, False
    hq = -(-num_heads // tp) * tp
    hkv = kv_heads
    while hq % hkv != 0:
        hkv += 1
    return hq, hkv, True
