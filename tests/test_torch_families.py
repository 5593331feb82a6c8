"""Port parity, the model families beyond the dense decoder: repro_torch's
models against repro's on the same parameters, carried across with
``interop.load_params``.

Reduced f32 configurations of every non-dense arch: granite-moe-1b-a400m
(MoE), arctic-480b (MoE with the dense residual branch), qwen2-vl-7b
(M-RoPE over embeddings, QKV bias), jamba-v0.1-52b (attention + Mamba +
MoE groups), xlstm-125m (sLSTM + mLSTM) and whisper-large-v3
(encoder-decoder). Every constant leaf (norm weights, biases, the forget
bias, Mamba's D) is drawn at random so every leaf matters; the VLM's M-RoPE
streams differ from each other. Compared: the final hidden states (Whisper:
the encoder output and the decoder's hidden states), the loss, and 8
decode steps of logits and caches (Whisper after ``prefill``). Then
forward == step-by-step decode on the port alone, as
tests/test_model_equivalence.py checks the reference (MoE at capacity
factor 8, since capacity drops differ between an S-token and a 1-token
call).

Tolerances are the dense model's (tests/test_torch_model.py: hidden states
and caches 5e-5, loss and decode logits 1e-5) for every family. Where the
port sums in another order than the reference, the differences stay well
inside them: Mamba's chunk scan is a Hillis-Steele prefix scan where the
reference runs ``lax.associative_scan`` (the hybrid's hidden states within
5.1e-6, its conv and SSM states within 3.8e-6 and 5.1e-7, on |h| up to
4.1); the xLSTM recurrences are the reference's step for step (hidden
states within 1.7e-5 after 4 blocks); the MoE combine adds each token's
outputs in the reference's order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro.configs import ARCHS, reduced
from repro.models import build_model as r_build
from repro.models import layers as RL
from repro_torch import interop
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as TL

FAMILIES = ["granite-moe-1b-a400m", "arctic-480b", "qwen2-vl-7b",
            "jamba-v0.1-52b", "xlstm-125m", "whisper-large-v3"]
TOL_H = 5e-5
TOL_LOSS = 1e-5
TOL_LOGITS = 1e-5
TOL_CACHE = 5e-5
B, S = 2, 32             # S a multiple of the reduced Mamba chunk (16)


def _cfgs(arch, **moe):
    rc = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    tc = dataclasses.replace(TC.reduced(TC.ARCHS[arch]), dtype="float32")
    if moe and rc.moe is not None:
        rc = dataclasses.replace(rc, moe=dataclasses.replace(rc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return rc, tc


def _vary_constants(tree, rng):
    """Every leaf whose values are all equal gets random values around its
    constant (+- 0.5), so a mistake in how it is used shows."""
    def vary(x):
        if x.size and np.ptp(x) == 0:
            return (x + rng.uniform(-0.5, 0.5, x.shape)).astype(np.float32)
        return x
    return jax.tree.map(vary, tree)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(reference model, its params as jnp, port model) on one tree."""
    rc, tc = _cfgs(request.param)
    rm = r_build(rc, tp=16)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    tree = _vary_constants(tree, np.random.default_rng(1))
    tm = interop.load_params(t_build(tc, tp=16, device="cpu"), tree)
    return rm, jax.tree.map(jnp.asarray, tree), tm


def _batch(cfg, seed=0, B=B, S=S):
    """A batch of ``cfg``'s family from a numpy seed: VLM embeddings with
    three M-RoPE streams that differ, Whisper frames and decoder tokens,
    or tokens."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        pos = np.stack([np.broadcast_to(np.arange(S) * (i + 1) + i, (B, S))
                        for i in range(3)]).astype(np.int32)
        return {"embeds": rng.normal(0, 1, (B, S, cfg.d_model))
                .astype(np.float32), "positions": pos, "labels": labels}
    if cfg.family == "audio":
        return {"enc_embeds": rng.normal(0, 1, (B, S, cfg.d_model))
                .astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab, (B, S))
                .astype(np.int32), "labels": labels}
    return {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
            "labels": labels}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _r_whisper_hidden(rm, params, batch):
    """The reference decoder's final hidden states and its encoder output
    (its loss computes both inline)."""
    cfg = rm.cfg
    enc = rm.encode(params, batch["enc_embeds"], remat=False)
    xk, xv = rm._cross_kv(params, enc)
    tok = batch["dec_tokens"]
    x = params["embed"][tok] + params["dec_pos"][:tok.shape[1]]
    for l in range(cfg.num_layers):
        pl = jax.tree.map(lambda a: a[l], params["dec"])
        x = rm._dec_block(pl, x, xk[l], xv[l], cfg)
    return RL.rmsnorm(x, params["final_norm"], cfg.norm_eps), enc


def test_forward_matches(pair):
    rm, params, tm = pair
    batch = _batch(rm.cfg)
    if rm.cfg.family == "audio":
        want, want_enc = _r_whisper_hidden(rm, params, _jnp(batch))
        np.testing.assert_allclose(tm.encode(batch["enc_embeds"]).numpy(),
                                   np.asarray(want_enc), rtol=TOL_H,
                                   atol=TOL_H)
    else:
        want = rm.apply(params, _jnp(batch), remat=False)
    got = tm.apply(batch)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_H,
                               atol=TOL_H)


def test_loss_matches(pair):
    rm, params, tm = pair
    batch = _batch(rm.cfg, seed=3)
    want = float(rm.loss(params, _jnp(batch), remat=False))
    got = float(tm.loss(batch))
    assert abs(got - want) <= TOL_LOSS * max(1.0, abs(want))


def _caches(rm, params, tm, steps, max_len):
    """Both models' fresh caches (Whisper's filled by ``prefill``)."""
    if rm.cfg.family != "audio":
        return rm.init_cache(B, max_len), tm.init_cache(B, max_len)
    enc = _batch(rm.cfg, seed=5)["enc_embeds"]
    r = rm.prefill(params, rm.init_cache(B, max_len, enc_len=S),
                   jnp.asarray(enc))
    t = tm.prefill(tm.init_cache(B, max_len, enc_len=S), enc)
    return r, t


def test_decode_matches(pair):
    rm, params, tm = pair
    steps, max_len = 8, 12
    rng = np.random.default_rng(4)
    tok = rng.integers(1, rm.cfg.vocab, (B, steps)).astype(np.int32)
    r_cache, t_cache = _caches(rm, params, tm, steps, max_len)
    assert sorted(t_cache) == sorted(r_cache)
    for key in r_cache:
        if key != "len":
            assert tuple(t_cache[key].shape) == r_cache[key].shape, key
    for t in range(steps):
        r_logits, r_cache = rm.decode_step(params, r_cache,
                                           jnp.asarray(tok[:, t]))
        t_logits, t_cache = tm.decode_step(t_cache, tok[:, t])
        assert t_logits.dtype == torch.float32
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                                   rtol=TOL_LOGITS, atol=TOL_LOGITS)
    assert t_cache["len"] == int(r_cache["len"]) == steps
    for key in r_cache:
        if key != "len":
            np.testing.assert_allclose(t_cache[key].numpy(),
                                       np.asarray(r_cache[key]),
                                       rtol=TOL_CACHE, atol=TOL_CACHE,
                                       err_msg=key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """The forward's logits equal step-by-step decode logits (within
    tests/test_model_equivalence.py's 2e-2), on the port alone. Whisper:
    ``prefill`` then ``decode_step`` against the teacher-forced forward."""
    _, tc = _cfgs(arch, capacity_factor=8.0)
    tm = t_build(tc, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _batch(tc, seed=6)
    steps = 8
    if tc.family == "audio":
        tok = batch["dec_tokens"][:, :steps]
        full = TL.unembed(tm.apply({**batch, "dec_tokens": tok}), tm.embed)
        cache = tm.prefill(tm.init_cache(B, steps + 2, enc_len=S),
                           batch["enc_embeds"])
    else:
        tok = (batch["tokens"] if "tokens" in batch
               else np.random.default_rng(6).integers(
                   1, tc.vocab, (B, S)).astype(np.int32))[:, :steps]
        full = TL.unembed(tm.apply({"tokens": tok}), tm.embed)
        cache = tm.init_cache(B, steps + 2)
    dec = torch.stack([tm.decode_step(cache, tok[:, t])[0]
                       for t in range(steps)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches(dtype):
    """M-RoPE on [3,B,S] positions whose streams differ: exact up to one
    rounding of the output in the activation dtype."""
    from repro_torch.models.layers import apply_mrope

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 5)).astype(np.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(
        apply_mrope(tx, torch.from_numpy(pos), 1e6, (2, 3, 3)).float()
        .numpy(),
        np.asarray(RL.apply_mrope(jx, jnp.asarray(pos), 1e6, (2, 3, 3)),
                   np.float32), rtol=tol, atol=tol)


def test_vlm_token_batch_defaults_to_equal_streams():
    """A VLM token batch without positions gets the three M-RoPE streams
    equal to the token index: the same as passing them."""
    _, tc = _cfgs("qwen2-vl-7b")
    tm = t_build(tc, device="cpu").init(torch.Generator().manual_seed(1))
    tok = np.random.default_rng(8).integers(1, tc.vocab, (B, 8))
    pos = np.broadcast_to(np.arange(8), (3, B, 8))
    torch.testing.assert_close(tm.apply({"tokens": tok}),
                               tm.apply({"tokens": tok, "positions": pos}),
                               rtol=0, atol=0)
