"""Deterministic synthetic token batches (a copy of ``repro.data.synthetic``
's ``SyntheticTokens`` and ``make_batch_iter``, numpy only).

Batches are a pure function of (seed, step), so the port and the reference
draw the same tokens from the same seed, and restarts resume the exact data
stream from the checkpointed step. A background thread keeps a small
prefetch queue filled.
"""
from __future__ import annotations

import queue
import threading

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


def make_batch_iter(source: SyntheticTokens, start_step: int = 0,
                    prefetch: int = 2):
    """Prefetching iterator over (step, batch)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            q.put((step, source.batch(step)))
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass

    return _Iter()
