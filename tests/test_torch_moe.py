"""Port parity, the MoE dispatch, parameter and FLOP counts, and serving of
the new decoder families.

* The routing of ``repro_torch.models.moe`` against the reference's
  (``repro/models/moe.py:48-66``, spelled in jax below as there): top-k
  indices, keep mask and slots bitwise, on random logits, on logits with
  exact ties, and where capacity drops pairs; the output of
  ``moe_ffn_global`` within 1e-5 (f32; the expert products sum in another
  order than XLA's). The port's one-device ``sharded`` and ``shardmap``
  forms equal its global form bitwise and the reference's forms within
  1e-5; the MoE equals a dense mixture at a generous capacity
  (tests/test_model_equivalence.py's check).
* ``active_param_count`` and ``model_flops`` of every full-width arch equal
  the reference's (``jax.eval_shape`` of its tree against the port's
  model on the ``meta`` device).
* ``launch.serve.serve(cfg, ..., device="cpu")`` of reduced MoE, VLM,
  hybrid and xLSTM configs gives the same greedy tokens as the reference's
  ``ContinuousBatcher`` on the same parameters (the port's seed-0
  parameters carried to the reference), each kept token decided by a
  top-1 over top-2 gap of more than twice the decode logits' 1e-5
  agreement (tests/test_torch_serve.py's guard).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro.configs import ARCHS, SHAPES, reduced
from repro.configs.base import MoEConfig
from repro.models import build_model as r_build
from repro.models import model_zoo as RZ
from repro.models import moe as RMOE
from repro.serve import ContinuousBatcher as RBatcher
from repro.serve import Request as RRequest
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model as t_build
from repro_torch.models import model_zoo as TZ
from repro_torch.models import moe as TMOE
from test_torch_serve import MARGIN, _drain, _requests

TOL = 1e-5


def _params(E, d=16, ff=32, seed=0):
    mcfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=ff)
    p = jax.tree.map(lambda a: np.asarray(a[0]), RMOE.init_moe(
        jax.random.PRNGKey(seed), d, mcfg, layers=1))
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _r_route(x, gate, mcfg):
    """The reference's routing (moe_ffn_global up to the dispatch)."""
    nt = x.shape[0]
    E, k = mcfg.num_experts, mcfg.top_k
    cap = max(int(mcfg.capacity_factor * nt * k / E), 1)
    cap = -(-cap // 8) * 8
    logits = jnp.einsum("td,de->te", x, gate)
    topv, topi = jax.lax.top_k(logits, k)
    e_flat = topi.reshape(-1)
    order = jnp.argsort(e_flat)
    se = e_flat[order]
    st = jnp.repeat(jnp.arange(nt), k)[order]
    counts = jnp.bincount(se, length=E)
    rank = jnp.arange(nt * k) - (jnp.cumsum(counts) - counts)[se]
    keep = rank < cap
    return {"se": se, "st": st, "keep": keep,
            "slot": jnp.where(keep, rank, 0)}, cap


@pytest.mark.parametrize("case", ["random", "ties", "drops"])
def test_routing_matches_bitwise(case):
    """Top-k, the stable sort, the keep mask and the slots of the port's
    ``route`` equal the reference's, bit for bit."""
    rng = np.random.default_rng(3)
    E, d, nt = 8, 16, 48
    x = rng.standard_normal((nt, d)).astype(np.float32)
    gate = rng.standard_normal((d, E)).astype(np.float32)
    cf = 1.25
    if case == "ties":
        # equal router columns and integer inputs: exact ties everywhere
        x = rng.integers(-2, 3, (nt, d)).astype(np.float32)
        gate = np.repeat(rng.integers(-1, 2, (d, 2)), E // 2,
                         axis=1).astype(np.float32)
    if case == "drops":
        cf = 0.3                 # 8 slots an expert for 96 pairs: drops
    mcfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=8,
                     capacity_factor=cf)
    want, cap = _r_route(jnp.asarray(x), jnp.asarray(gate), mcfg)
    assert TMOE.capacity(mcfg, nt) == cap
    got = TMOE.route(torch.from_numpy(x), torch.from_numpy(gate), mcfg, cap)
    for key in ("se", "st", "keep", "slot"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    if case == "drops":
        assert int(np.asarray(want["keep"]).sum()) < nt * 2


@pytest.mark.parametrize("cf", [1.25, 1e-9, 4.0])
def test_moe_output_matches(cf):
    """moe_ffn_global's output; capacity 1e-9 rounds to 8 slots an expert
    for 64 pairs, so tokens drop (tests/test_model_equivalence.py:79)."""
    E = 4
    p, tp = _params(E, d=8, ff=16, seed=3)
    mcfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=16,
                     capacity_factor=cf)
    x = np.array(jax.random.normal(jax.random.PRNGKey(4), (2, 16, 8)))
    want = np.asarray(RMOE.moe_ffn_global(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), mcfg))
    got = TMOE.moe_ffn_global(tp, torch.from_numpy(x), mcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if cf < 1:
        full = TMOE.moe_ffn_global(
            tp, torch.from_numpy(x),
            dataclasses.replace(mcfg, capacity_factor=8.0)).numpy()
        assert np.abs(got).sum() < np.abs(full).sum()


@pytest.mark.parametrize("dispatch", ["sharded", "shardmap"])
def test_one_device_dispatch_forms(dispatch):
    """The port's one-device forms equal its global form bitwise, and the
    reference's form within 1e-5 (tests/test_model_equivalence.py:130)."""
    E = 4
    p, tp = _params(E, seed=11)
    m_g = MoEConfig(num_experts=E, top_k=2, d_ff_expert=32,
                    capacity_factor=1.25)
    m_d = dataclasses.replace(m_g, dispatch=dispatch)
    x = np.array(jax.random.normal(jax.random.PRNGKey(12), (2, 8, 16)))
    tx = torch.from_numpy(x)
    got = TMOE.moe_ffn(tp, tx, m_d)
    assert torch.equal(got, TMOE.moe_ffn(tp, tx, m_g))
    want = RMOE.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), m_d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_moe_matches_dense_mixture():
    """With capacity >= tokens, the dispatch == an explicit mixture of the
    experts weighted by the softmax of the top-k logits."""
    E, k = 4, 2
    _, p = _params(E, seed=1)
    mcfg = MoEConfig(num_experts=E, top_k=k, d_ff_expert=32,
                     capacity_factor=float(E))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 6, 16)).astype(np.float32))
    got = TMOE.moe_ffn(p, x, mcfg)
    topv, topi = torch.topk(x @ p["gate"], k)
    gates = torch.softmax(topv, dim=-1)
    y = torch.zeros_like(x)
    for e in range(E):
        h = torch.nn.functional.silu(x @ p["w1"][e]) * (x @ p["w3"][e])
        y = y + ((topi == e) * gates).sum(-1)[..., None] * (h @ p["w2"][e])
    torch.testing.assert_close(got, y, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_params_and_flops_match(arch):
    cfg = ARCHS[arch]
    tcfg = TC.ARCHS[arch]
    if cfg.family == "hybrid":           # chip_smoke.py's depth cut
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every)
        tcfg = dataclasses.replace(tcfg, num_layers=tcfg.attn_every)
    tree = jax.eval_shape(
        lambda: r_build(cfg, tp=16).init(jax.random.PRNGKey(0)))
    model = t_build(tcfg, tp=16, device="meta")
    assert TZ.param_count(model) == RZ.param_count(tree)
    assert (TZ.active_param_count(tcfg, model)
            == RZ.active_param_count(cfg, tree))
    if cfg.moe is not None:
        assert TZ.active_param_count(tcfg, model) < TZ.param_count(model)
    for name, shape in SHAPES.items():
        assert (TZ.model_flops(tcfg, model, TC.SHAPES[name])
                == RZ.model_flops(cfg, tree, shape)), name


class _Ref:
    """The reference model with its decode step under jax.jit, recording
    each step's top-1 over top-2 logit gap per row."""

    def __init__(self, model):
        self.model = model
        self._step = jax.jit(model.decode_step)
        self.gaps = []

    def init_cache(self, *args):
        return self.model.init_cache(*args)

    def decode_step(self, params, cache, tokens):
        logits, cache = self._step(params, cache, tokens)
        top = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        self.gaps.append(top[:, 1] - top[:, 0])
        return logits, cache


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-vl-7b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_serve_matches_reference_batcher(arch):
    rc = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    tc = dataclasses.replace(TC.reduced(TC.ARCHS[arch]), dtype="float32")
    n, slots, max_new, max_len = 6, 3, 12, 64
    out = t_serve.serve(tc, requests=n, slots=slots, max_new=max_new,
                        max_len=max_len, device="cpu")
    # serve()'s model: seed-0 parameters, carried to the reference
    model = t_build(tc, device="cpu").init(torch.Generator().manual_seed(0))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          model.param_tree())
    probe = _Ref(r_build(rc, tp=16))
    ref = RBatcher(probe, params, batch_size=slots, max_len=max_len, eos=0)
    r_reqs = _requests(RRequest, rc.vocab, n, max_new)
    steps, generated = _drain(ref, r_reqs)
    assert steps == out["steps"]
    for a, b in zip(r_reqs, out["requests"]):
        assert a.done and b.done
        assert a.out == b.out, a.rid
    kept = [probe.gaps[t][i] for t in range(steps) for i in generated[t]]
    assert min(kept) > MARGIN, min(kept)


def test_serve_refuses_the_encoder_decoder():
    cfg = TC.reduced(TC.ARCHS["whisper-large-v3"])
    with pytest.raises(ValueError, match="encoder"):
        t_serve.serve(cfg, requests=1, slots=1, max_new=1, max_len=8,
                      device="cpu")
