"""Deterministic synthetic token batches (a copy of ``repro.data.synthetic``
's ``SyntheticTokens``, numpy only).

Batches are a pure function of (seed, step), so the port and the reference
draw the same tokens from the same seed.
"""
from __future__ import annotations

import numpy as np


class SyntheticTokens:
    """Markov-ish token stream: deterministic per (seed, step)."""

    def __init__(self, cfg, shape_cfg, seed: int = 0):
        self.cfg = cfg
        self.shape = shape_cfg
        self.seed = seed

    def batch(self, step: int) -> dict:
        cfg, sh = self.cfg, self.shape
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = sh.batch, sh.seq
        if cfg.family == "vlm":
            emb = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(S, dtype=np.int32),
                                  (3, B, S)).copy()
            lab = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
            return {"embeds": emb, "positions": pos, "labels": lab}
        if cfg.family == "audio":
            emb = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
            tok = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
            lab = np.roll(tok, -1, axis=1)
            return {"enc_embeds": emb, "dec_tokens": tok, "labels": lab}
        tok = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
        return {"tokens": tok[:, :-1].copy(), "labels": tok[:, 1:].copy()}
