"""Port parity, dense decoder: repro_torch's DecoderModel against repro's on
the same parameters, carried across with ``interop.load_params``.

Reduced f32 configurations of qwen1.5-0.5b (MHA + QKV bias), smollm-360m
(GQA) and qwen2.5-3b (GQA + QKV bias), with random biases and norm weights
so every leaf matters: the forward's final hidden states, the loss, and 8
decode steps of logits and KV cache. Tolerances (f32; the frameworks sum in
other orders through 4 layers, measured at a few 1e-6): hidden states and
cache 5e-5, loss and decode logits 1e-5. Beside them: the copied configs,
the head plan of all ten full-width configs, the full-width parameter
shapes of every arch without allocating (``jax.eval_shape`` against the
port's model on the ``meta`` device), the loader's checks, and the refusal
of ``launch.train.train`` for the families whose training is not ported
yet. The other families' parity is in tests/test_torch_families.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro.configs import ARCHS, SHAPES, reduced, shape_applicable
from repro.data.synthetic import SyntheticTokens as RSynthetic
from repro.models import build_model as r_build
from repro.models import layers as RL
from repro.sharding.ctx import head_plan as r_head_plan
from repro_torch import interop
from repro_torch.data import SyntheticTokens as TSynthetic
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models import param_count
from repro_torch.sharding import head_plan as t_head_plan

DENSE = ["qwen1.5-0.5b", "smollm-360m", "qwen2.5-3b"]
TOL_H = 5e-5
TOL_LOSS = 1e-5
TOL_LOGITS = 1e-5
TOL_CACHE = 5e-5


def _cfgs(arch):
    return (dataclasses.replace(reduced(ARCHS[arch]), dtype="float32"),
            dataclasses.replace(TC.reduced(TC.ARCHS[arch]), dtype="float32"))


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(reference model, its params as jnp, port model) on one tree."""
    rc, tc = _cfgs(request.param)
    rm = r_build(rc, tp=16)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for name in ("bq", "bk", "bv"):
        if name in tree["attn"]:
            tree["attn"][name] = rng.normal(
                0, 0.5, tree["attn"][name].shape).astype(np.float32)
    for name in ("ln1", "ln2", "final_norm"):
        tree[name] = rng.uniform(0.5, 1.5, tree[name].shape).astype(
            np.float32)
    tm = interop.load_params(t_build(tc, tp=16, device="cpu"), tree)
    return rm, jax.tree.map(jnp.asarray, tree), tm


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_forward_matches(pair):
    rm, params, tm = pair
    batch = _batch(rm.cfg)
    want = np.asarray(rm.apply(params, _jnp(batch), remat=False))
    got = tm.apply(batch)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_H, atol=TOL_H)


def test_loss_matches(pair):
    rm, params, tm = pair
    batch = _batch(rm.cfg, seed=3)
    want = float(rm.loss(params, _jnp(batch), remat=False))
    got = float(tm.loss(batch))
    assert abs(got - want) <= TOL_LOSS * max(1.0, abs(want))


def test_decode_matches(pair):
    rm, params, tm = pair
    B, steps, max_len = 2, 8, 12
    tok = _batch(rm.cfg, B=B, S=steps, seed=4)["tokens"]
    r_cache = rm.init_cache(B, max_len)
    t_cache = tm.init_cache(B, max_len)
    assert tuple(t_cache["k"].shape) == r_cache["k"].shape
    for t in range(steps):
        r_logits, r_cache = rm.decode_step(params, r_cache,
                                           jnp.asarray(tok[:, t]))
        t_logits, t_cache = tm.decode_step(t_cache, tok[:, t])
        assert t_logits.dtype == torch.float32
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                                   rtol=TOL_LOGITS, atol=TOL_LOGITS)
    assert t_cache["len"] == int(r_cache["len"]) == steps
    for key in ("k", "v"):
        np.testing.assert_allclose(t_cache[key].numpy(),
                                   np.asarray(r_cache[key]),
                                   rtol=TOL_CACHE, atol=TOL_CACHE)


def test_decode_matches_forward():
    """tests/test_model_equivalence.py's check on the port alone: the
    forward's logits equal step-by-step decode logits (within its 2e-2)."""
    _, tc = _cfgs("qwen1.5-0.5b")
    tm = t_build(tc, device="cpu").init(torch.Generator().manual_seed(0))
    tok = _batch(tc, B=2, S=8)["tokens"]
    full = TL.unembed(tm.apply({"tokens": tok}), tm.embed)
    cache = tm.init_cache(2, 10)
    dec = torch.stack([tm.decode_step(cache, tok[:, t])[0]
                       for t in range(8)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_rope_match(dtype):
    """RMSNorm (f32 weight applied before the cast back) and RoPE (float64
    frequencies used as f32) on the same inputs: exact up to one rounding
    of the output in the activation dtype."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(5) * 97, (2, 5)).astype(np.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(
        TL.rmsnorm(tx, torch.from_numpy(w)).float().numpy(),
        np.asarray(RL.rmsnorm(jx, jnp.asarray(w)), np.float32),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        TL.apply_rope(tx, torch.from_numpy(pos), 1e6).float().numpy(),
        np.asarray(RL.apply_rope(jx, jnp.asarray(pos), 1e6), np.float32),
        rtol=tol, atol=tol)


def test_configs_are_copies():
    assert sorted(TC.ARCHS) == sorted(ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(TC.ARCHS[name]) == dataclasses.asdict(cfg)
        assert (dataclasses.asdict(TC.reduced(TC.ARCHS[name]))
                == dataclasses.asdict(reduced(cfg)))
        for shape in SHAPES:
            assert (TC.shape_applicable(TC.ARCHS[name], TC.SHAPES[shape])
                    == shape_applicable(cfg, SHAPES[shape]))
    assert ({k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in SHAPES.items()})


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_head_plan_matches(arch):
    cfg = ARCHS[arch]
    for tp in (1, 4, 16):
        assert (t_head_plan(cfg.num_heads, cfg.kv_heads, tp)
                == r_head_plan(cfg.num_heads, cfg.kv_heads, tp))


# exact full-width parameter counts (head plan padding included); Jamba at
# one group of 8 layers, the depth chip_smoke.py runs
FULL_WIDTH_PARAMS = {
    "arctic-480b": 477_134_701_568, "granite-34b": 46_947_932_160,
    "granite-moe-1b-a400m": 1_334_628_352,
    "jamba-v0.1-52b": 13_026_799_616, "qwen1.5-0.5b": 463_987_712,
    "qwen2-vl-7b": 7_173_393_920, "qwen2.5-3b": 3_085_938_688,
    "smollm-360m": 377_549_760, "whisper-large-v3": 2_436_967_424,
    "xlstm-125m": 75_280_168,
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_width_param_shapes(arch):
    """The reference's full-width parameter tree (shapes only, from
    jax.eval_shape) fits the port's model on the meta device leaf for
    leaf; nothing is allocated."""
    cfg, tcfg = ARCHS[arch], TC.ARCHS[arch]
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every)
        tcfg = dataclasses.replace(tcfg, num_layers=tcfg.attn_every)
    tree = jax.eval_shape(
        lambda: r_build(cfg, tp=16).init(jax.random.PRNGKey(0)))
    model = t_build(tcfg, tp=16, device="meta")
    assert model.device.type == "meta"
    flat = interop.flatten_params(tree)
    interop.check_params(model, flat)
    assert param_count(model) == sum(int(np.prod(x.shape))
                                     for x in flat.values())
    assert param_count(model) == FULL_WIDTH_PARAMS[arch]
    assert (model.hq, model.hkv) == r_head_plan(cfg.num_heads,
                                                cfg.kv_heads, 16)[:2]


def test_load_params_checks_the_tree():
    rc, tc = _cfgs("qwen1.5-0.5b")
    tree = jax.tree.map(np.asarray,
                        r_build(rc, tp=16).init(jax.random.PRNGKey(0)))
    model = t_build(tc, device="cpu")
    interop.load_params(model, tree)
    assert torch.equal(model.attn["wq"],
                       torch.tensor(np.asarray(tree["attn"]["wq"])))
    missing = {**tree, "attn": {k: v for k, v in tree["attn"].items()
                                if k != "bq"}}
    with pytest.raises(ValueError, match=r"missing \['attn.bq'\]"):
        interop.load_params(model, missing)
    with pytest.raises(ValueError, match=r"extra \['lm_head'\]"):
        interop.load_params(model, {**tree, "lm_head": tree["embed"]})
    with pytest.raises(ValueError, match="ln1"):
        interop.load_params(model, {**tree, "ln1": tree["ln1"][:, :-1]})


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if ARCHS[a].family != "dense"))
def test_train_refuses_unported_families(arch, tmp_path):
    """``launch.train.train`` no longer refuses a non-dense family (it did
    until their training was ported): one reduced step of each trains,
    with a finite loss within 0.5 of ln V (their parity with the
    reference is in tests/test_torch_train_families.py)."""
    import math

    from repro_torch.launch.train import train

    cfg = TC.reduced(TC.ARCHS[arch])
    out = train(cfg, steps=1, batch=2, seq=16, ckpt_dir=str(tmp_path),
                device="cpu", log=lambda m: None)
    assert len(out["losses"]) == 1
    assert abs(out["losses"][0] - math.log(cfg.vocab)) < 0.5


def test_entry_points_need_the_card(monkeypatch):
    """``device=None`` means the card: without one, building raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build(TC.reduced(TC.ARCHS["qwen1.5-0.5b"]))


def test_init_is_seeded_with_the_reference_scales():
    _, tc = _cfgs("qwen1.5-0.5b")
    a = t_build(tc, device="cpu").init(torch.Generator().manual_seed(3))
    b = t_build(tc, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert (a.attn["bq"] == 0).all() and (a.ln1 == 1).all()
    d = tc.d_model
    assert abs(float(a.attn["wq"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(a.embed.std()) - 0.02) < 0.002


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-7b",
                                  "whisper-large-v3"])
def test_synthetic_tokens_match(arch):
    shape = dataclasses.replace(SHAPES["train_4k"], seq=16, batch=3)
    cfg = reduced(ARCHS[arch])
    for step in (0, 5):
        want = RSynthetic(cfg, shape, seed=2).batch(step)
        got = TSynthetic(TC.reduced(TC.ARCHS[arch]), shape,
                         seed=2).batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
