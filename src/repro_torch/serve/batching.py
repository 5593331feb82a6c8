"""Continuous batching over the single-token decode step (the counterpart
of ``repro.serve.batching``).

Fixed B decode slots; finished/empty slots are refilled from the request
queue each iteration (tokens of dead slots still step but are masked out).
Greedy sampling; per-request max_tokens/eos. The slot tokens live on the
model's device and the argmax runs there: each step copies the B argmax
tokens to the host, which decides every slot's next token (prompt
teacher-forcing, generation, eos and budgets as in the reference), and
sends the B next tokens back in one copy. The model is any decoder of
:func:`repro_torch.models.build_model` (its ``init_cache(batch_size,
max_len)`` and ``decode_step``); Whisper's cache also needs the encoder
length, so it is not served here, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_tokens: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, model, batch_size: int, max_len: int, eos: int = 1):
        self.model = model
        self.B = batch_size
        self.max_len = max_len
        self.eos = eos
        self.cache = model.init_cache(batch_size, max_len)
        self.slots: list[Request | None] = [None] * batch_size
        self.queue: list[Request] = []
        self.cur = torch.zeros(batch_size, dtype=torch.int64,
                               device=model.device)
        self._next = [0] * batch_size        # the host's copy of self.cur
        self.budget = np.zeros(batch_size, dtype=np.int32)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for i in range(self.B):
            if (self.slots[i] is None or self.slots[i].done) and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # simple prompt handling: feed prompt tokens step by step
                self._next[i] = req.prompt[0] if req.prompt else self.eos
                self.budget[i] = req.max_tokens + len(req.prompt)

    def step(self) -> None:
        self._fill_slots()
        self.cur.copy_(torch.tensor(self._next, dtype=torch.int64))
        logits, self.cache = self.model.decode_step(self.cache, self.cur)
        nxt = logits.argmax(-1).tolist()
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            consumed = len(req.out) + 1
            if consumed < len(req.prompt):          # still teacher-forcing
                self._next[i] = req.prompt[consumed]
                req.out.append(self._next[i])
                continue
            tok = nxt[i]
            req.out.append(tok)
            self._next[i] = tok
            self.budget[i] -= 1
            if tok == self.eos or self.budget[i] <= 0:
                req.done = True

    def run(self, max_steps: int = 1000) -> list[Request]:
        for _ in range(max_steps):
            if not self.queue and all(r is None or r.done for r in self.slots):
                break
            self.step()
        return [r for r in self.slots if r is not None] + self.queue
