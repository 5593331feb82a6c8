"""Port parity, serving: repro_torch's ContinuousBatcher against repro's on
the same parameters (carried across with ``interop.load_params``) and the
same requests, drawn as the serve CLI draws them. Greedy tokens must be
equal for every request. Argmax takes the first maximum in both frameworks,
and the seeds are such that no near-tie decides a token: the test asserts
that every generated token wins over the runner-up by more than twice the
decode logits' agreement of 1e-5 (tests/test_torch_model.py), so equal
tokens are not luck (the smallest such gap here is 7e-5). Also the serve
entry point: on the CPU when asked, and raising without a GPU otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro.configs import ARCHS, reduced
from repro.models import build_model as r_build
from repro.serve import ContinuousBatcher as RBatcher
from repro.serve import Request as RRequest
from repro_torch import interop
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model as t_build
from repro_torch.serve import ContinuousBatcher as TBatcher
from repro_torch.serve import Request as TRequest

# least top-1 over top-2 logit gap of a kept token: with logits that agree
# within 1e-5, a gap above twice that cannot flip the argmax
MARGIN = 2 * 1e-5


class _JittedDecode:
    """The reference model with its decode step under jax.jit (the batcher
    calls it once per step; eager it would trace the layer scan anew)."""

    def __init__(self, model):
        self.model = model
        self.decode_step = jax.jit(model.decode_step)

    def init_cache(self, *args):
        return self.model.init_cache(*args)


class _Margins:
    """The port model, recording each step's top-2 logit gap per row."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.gaps = []

    def init_cache(self, *args):
        return self.model.init_cache(*args)

    def decode_step(self, cache, tokens):
        logits, cache = self.model.decode_step(cache, tokens)
        top = torch.topk(logits, 2, dim=-1).values
        self.gaps.append((top[:, 0] - top[:, 1]).numpy())
        return logits, cache


def _requests(cls, vocab, n, max_new):
    rng = np.random.default_rng(0)          # launch/serve.py's draw
    return [cls(rid=rid,
                prompt=rng.integers(1, vocab, rng.integers(2, 8)).tolist(),
                max_tokens=max_new) for rid in range(n)]


def _drain(batcher, reqs):
    """Run ``batcher`` to the end; returns the steps and, per step, the
    slots whose request kept a generated (not a prompt) token."""
    for r in reqs:
        batcher.submit(r)
    generated = []
    while batcher.queue or any(r is not None and not r.done
                               for r in batcher.slots):
        batcher._fill_slots()
        before = [(r, len(r.out)) if r is not None and not r.done else None
                  for r in batcher.slots]
        batcher.step()
        generated.append([i for i, b in enumerate(before) if b is not None
                          and b[1] + 1 >= len(b[0].prompt)])
    return len(generated), generated


@pytest.mark.parametrize("arch,slots,n", [("qwen1.5-0.5b", 4, 16),
                                          ("smollm-360m", 3, 7)])
def test_batcher_matches_reference(arch, slots, n):
    rc = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    tc = dataclasses.replace(TC.reduced(TC.ARCHS[arch]), dtype="float32")
    rm = r_build(rc, tp=16)
    params = rm.init(jax.random.PRNGKey(0))
    tm = interop.load_params(t_build(tc, tp=16, device="cpu"),
                             jax.tree.map(np.asarray, params))
    ref = RBatcher(_JittedDecode(rm), params, batch_size=slots,
                   max_len=512, eos=0)
    probe = _Margins(tm)
    port = TBatcher(probe, batch_size=slots, max_len=512, eos=0)
    r_reqs = _requests(RRequest, rc.vocab, n, 32)
    t_reqs = _requests(TRequest, tc.vocab, n, 32)
    steps, generated = _drain(port, t_reqs)
    assert _drain(ref, r_reqs)[0] == steps
    for a, b in zip(r_reqs, t_reqs):
        assert a.done and b.done
        assert a.out == b.out, a.rid
    assert port.cache["len"] == int(ref.cache["len"])
    assert port.cur.device == tm.device
    # every argmax the requests kept was decided by a clear margin
    kept = [probe.gaps[t][i] for t in range(steps) for i in generated[t]]
    assert len(kept) == sum(len(r.out) - len(r.prompt) + 1 for r in t_reqs)
    assert min(kept) > MARGIN, min(kept)


def test_serve_runs_on_the_cpu_when_asked():
    cfg = dataclasses.replace(TC.reduced(TC.ARCHS["qwen1.5-0.5b"]),
                              dtype="float32")
    out = t_serve.serve(cfg, requests=5, slots=2, max_new=4, max_len=64,
                        device="cpu")
    assert len(out["requests"]) == 5
    assert all(r.done and r.out for r in out["requests"])
    assert out["tokens"] == 2 * out["steps"] and out["seconds"] > 0
    assert out["params"] == sum(p.numel() for p in t_build(
        cfg, device="meta").parameters())


def test_serve_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.reduced(TC.ARCHS["qwen1.5-0.5b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.serve(cfg, requests=2, slots=1, max_new=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--requests", "2"])


def test_cli_flags_mirror_the_reference(monkeypatch):
    """--reduced defaults to true (a store_true flag), as in the reference:
    the CLI always serves the reduced configuration."""
    seen = {}

    def fake_serve(cfg, requests, slots, max_new, max_len, device=None):
        seen.update(cfg=cfg, args=(requests, slots, max_new, max_len))
        return {"requests": [], "params": 0, "steps": 1, "tokens": 1,
                "seconds": 1.0}

    monkeypatch.setattr(t_serve, "serve", fake_serve)
    t_serve.main(["--arch", "smollm-360m", "--slots", "2"])
    assert seen["cfg"].name == "smollm-360m-reduced"
    assert seen["cfg"].dtype == "float32"
    assert seen["args"] == (16, 2, 32, 512)
