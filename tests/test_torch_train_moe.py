"""Port parity, training of the MoE families (granite-moe-1b-a400m: 32
experts top 8, reduced to 4 top 2; arctic-480b with its dense residual
branch): one train step of each package against the reference's
(``test_torch_train_families.family_step_parity``, at the tolerances
stated there), at 1 and 2 microbatches and, for granite-moe, with
``--mp`` and gradient compression; the MoE FFN's backward against
``jax.grad`` of the reference's, with and without capacity drops; the
routing of the recompute under remat; a reduced granite-moe run of the
train driver resumed from its checkpoint against an uninterrupted one.

The backward goes through the dispatch's scatter into the [E, cap + 1, d]
buffer (a dropped pair writes to the spare row ``cap``, which the experts
never read, so it takes no gradient), the experts' batched products, the
gather of each pair's output and the combine; the gates take their
gradient through the top-k softmax, and the sorts and ranks take none.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro.configs.base import MoEConfig
from repro.models import moe as RMOE
from repro_torch import interop
from repro_torch.launch import train as tl
from repro_torch.models import build_model as t_build
from repro_torch.models import moe as TMOE
from repro_torch.train.step import loss_and_grads
from test_torch_families import _batch
from test_torch_train_families import (B, S, _grads_close, _jax_grads,
                                       _torch_grads, family_step_parity)


@pytest.mark.parametrize("arch,mb,gc,mp", [
    ("granite-moe-1b-a400m", 1, False, False),
    ("granite-moe-1b-a400m", 2, False, False),
    ("granite-moe-1b-a400m", 2, True, True),
    ("arctic-480b", 1, False, False),
    ("arctic-480b", 2, False, False)])
def test_moe_train_step_matches_reference(arch, mb, gc, mp):
    family_step_parity(arch, mb, gc, mp)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_backward_matches_reference(cf):
    """The MoE FFN's gradients in x, the router and the experts, with
    capacity to spare and with pairs dropped (cf 0.25: a quarter of the
    pairs fit). Top-k, the sort and the ranks take no gradient; the gates
    take theirs through the top-k softmax; a token all of whose pairs
    drop gets no gradient through the experts."""
    E, d, ff, nt = 4, 16, 32, 48
    mcfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=ff,
                     capacity_factor=cf)
    p = jax.tree.map(lambda a: np.asarray(a[0]), RMOE.init_moe(
        jax.random.PRNGKey(5), d, mcfg, layers=1))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, nt // 2, d)).astype(np.float32)
    w = rng.standard_normal((2, nt // 2, d)).astype(np.float32)
    got, _ = _torch_grads(lambda p, x: TMOE.moe_ffn(p, x, mcfg), p, x, w)
    want = _jax_grads(lambda p, x: RMOE.moe_ffn(p, x, mcfg), p, x, w)
    _grads_close(got, want, f"moe cf={cf}")
    cap = TMOE.capacity(mcfg, nt)
    r = TMOE.route(torch.from_numpy(x.reshape(nt, d)),
                   torch.from_numpy(p["gate"].copy()), mcfg, cap)
    kept = torch.zeros(nt, dtype=torch.bool)
    kept[r["st"][r["keep"]]] = True
    if cf < 1:
        assert not bool(r["keep"].all()) and not bool(kept.all())
    # through the experts alone (no residual here): no kept pair, no
    # gradient
    gx = got["x"].reshape(nt, d)
    assert bool((gx[~kept] == 0).all())


def test_moe_recompute_routes_as_the_forward(monkeypatch):
    """Under remat each MoE layer's recompute (the backward runs it again)
    gets the forward's routing, bit for bit: the recompute runs the layers
    in reverse order, so the routing log read backwards is the forward's."""
    tc = TC.reduced(TC.ARCHS["granite-moe-1b-a400m"])
    tm = t_build(tc, device="cpu").init(torch.Generator().manual_seed(3))
    log = []
    real = TMOE.route

    def recorded(*args):
        out = real(*args)
        log.append({k: v.clone() for k, v in out.items()})
        return out

    monkeypatch.setattr(TMOE, "route", recorded)
    loss_and_grads(tm, tm.param_tree(), _batch(tc, seed=4, B=B, S=S))
    L = tc.num_layers
    assert len(log) == 2 * L
    for fwd, again in zip(log[:L], reversed(log[L:])):
        for key in fwd:
            assert torch.equal(fwd[key], again[key]), key


def _driver_cfg(arch):
    return dataclasses.replace(TC.reduced(TC.ARCHS[arch]), dtype="float32")


def test_granite_moe_resumes_from_its_checkpoint(tmp_path):
    """A reduced granite-moe run of the train driver stopped after step 5
    and resumed from its last checkpoint (step 4) ends with the
    uninterrupted 7-step run's losses and state, bit for bit."""
    cfg = _driver_cfg("granite-moe-1b-a400m")
    kw = dict(steps=7, batch=4, seq=16, ckpt_every=2, device="cpu")
    ref = tl.train(cfg, ckpt_dir=str(tmp_path / "ref"), log=lambda m: None,
                   **kw)

    class Stop(Exception):
        pass

    def crash(msg):
        if msg.startswith(f"step {5:5d}"):
            raise Stop

    with pytest.raises(Stop):
        tl.train(cfg, ckpt_dir=str(tmp_path / "cut"), log=crash,
                 log_every=1, **kw)
    for t in threading.enumerate():       # the step-4 save, still writing
        if "_save_and_gc" in t.name:
            t.join()
    again = tl.train(cfg, ckpt_dir=str(tmp_path / "cut"), log=lambda m: None,
                     **kw)
    assert again["start"] == 5
    assert again["losses"] == ref["losses"][5:]
    want = interop.flatten_params(ref["state"])
    got = interop.flatten_params(again["state"])
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
