"""Port parity in bf16: the model attention's rounding, and whole-model bf16
forwards of every family, against repro on the CPU.

The reference's model attention (``repro.models.layers._gqa_scores_out``)
rounds the scores to bf16 (its einsum's output dtype) before the f32
softmax and rounds the weights P to bf16 before PV. On the CPU the port's
``attention_train`` computes the same arithmetic
(``layers.attention_plain_model``); on the card it runs the flash kernel.
The attention of given bf16 projections (B=2, S=64, 8 heads of 64 over 4
kv heads) agrees within :data:`ATTN_RTOL` in relative Frobenius norm
(measured 2.0e-5 causal, 7.9e-5 not; the Pallas kernel's arithmetic, which
the port's CPU path ran before, scores and P kept in f32: 3.1e-3 and
4.0e-3). A whole attention layer (projections, RoPE, the output
projection) agrees within :data:`ATTN_LAYER_RTOL` (measured 2.3e-4 causal,
5.9e-4 not; 3.9e-3 and 4.6e-3 through the Pallas kernel's arithmetic):
the projections agree within 8e-6, and the rest is the softmax's f32
``exp``, whose last bits differ between XLA and torch and move a bf16
rounding of P now and then, more often over the flatter scores of
projected inputs.

Whole reduced models in bf16 (B=2, S=64, the same parameters carried
across with ``interop.load_params``, every constant leaf varied): the
final hidden states of the dense, VLM, hybrid and audio families in
relative Frobenius norm within :data:`HIDDEN_RTOL`, and the loss of every
family within :data:`LOSS_RTOL` (an MoE's within :data:`MOE_LOSS_RTOL`).
Measured: hidden states 1.21e-2 (smollm-360m), 1.19e-2 (qwen2-vl-7b),
1.41e-2 (jamba-v0.1-52b), 7.5e-3 (whisper-large-v3); losses 1.0e-5 to
5.9e-5, the MoEs 1.6e-4 (arctic-480b) and 3.5e-4 (granite-moe-1b-a400m).
They cannot be tighter: the port computes each bf16 operation as the
reference's program writes it, and XLA on the CPU does not. Block by block
in the dense model the attention agrees exactly and each SwiGLU MLP
differs by 3.1e-3 to 4.1e-3, from two things XLA does: it expands the
sigmoid of a bf16 input as 1 / (1 + exp(-x)) rounding each of the three
steps to bf16, and inside a fusion it keeps the bf16 residual sum
``x + attention(...)`` in f32 where the following RMSNorm reads it (its
excess precision). Emulating both on the port's side brings each dense
block within 1.3e-4 of the reference's and the whole dense model from
1.21e-2 to 2.9e-3. An MoE's router logits round apart now and then, and a
token then takes another expert: its hidden states are not compared (the
card's comparisons replay one routing), its loss is.
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
from test_torch_families import _batch, _r_whisper_hidden, _vary_constants

ATTN_RTOL = 1e-4
ATTN_LAYER_RTOL = 1e-3
HIDDEN_RTOL = 2e-2
LOSS_RTOL = 1e-4
MOE_LOSS_RTOL = 1e-3
B, S = 2, 64
FAMILIES = ["smollm-360m", "granite-moe-1b-a400m", "arctic-480b",
            "qwen2-vl-7b", "jamba-v0.1-52b", "xlstm-125m",
            "whisper-large-v3"]


def _rel(got, want) -> float:
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_rounds_as_the_reference(causal):
    """The attention of given bf16 projections q [B,S,8,64] over k, v
    [B,S,4,64]: the port's plain model path against the reference's
    ``_gqa_scores_out``."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((B, S, h, 64)).astype(np.float32)
               for h in (8, 4, 4))
    want = RL._gqa_scores_out(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), causal)
    got = TL.attention_plain_model(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) <= ATTN_RTOL


@pytest.mark.parametrize("causal", [True, False])
def test_attention_layer_rounds_as_the_reference(causal):
    """One bf16 attention layer (projections, RoPE, GQA over 4 kv heads,
    output projection) of both packages on the same parameters, within
    :data:`ATTN_LAYER_RTOL`."""
    cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), d_model=128,
                              num_heads=8, kv_heads=4, head_dim=64,
                              dtype="bfloat16")
    tcfg = dataclasses.replace(TC.reduced(TC.ARCHS["smollm-360m"]),
                               d_model=128, num_heads=8, kv_heads=4,
                               head_dim=64, dtype="bfloat16")
    p = jax.tree.map(lambda a: np.asarray(a[0]), RL.init_attn(
        jax.random.PRNGKey(3), cfg, 1, 8, 4))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = RL.attention_train({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x, jnp.bfloat16), cfg,
                              jnp.asarray(pos), causal=causal)
    got = TL.attention_train({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(torch.bfloat16), tcfg,
                             torch.from_numpy(pos.copy()), causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) <= ATTN_LAYER_RTOL


@pytest.fixture(scope="module", params=FAMILIES)
def bf16_pair(request):
    """(reference model, its params as jnp, port model) in bf16 on one
    tree, every constant leaf varied."""
    arch = request.param
    rc = dataclasses.replace(reduced(ARCHS[arch]), dtype="bfloat16")
    tc = dataclasses.replace(TC.reduced(TC.ARCHS[arch]), dtype="bfloat16")
    rm = r_build(rc, tp=16)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    tree = _vary_constants(tree, np.random.default_rng(1))
    tm = interop.load_params(t_build(tc, tp=16, device="cpu"), tree)
    return rm, jax.tree.map(jnp.asarray, tree), tm


def test_bf16_forward_matches(bf16_pair):
    rm, params, tm = bf16_pair
    batch = _batch(rm.cfg, seed=0, B=B, S=S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    got = tm.apply(batch)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    want_loss = float(rm.loss(params, jb, remat=False))
    tol = MOE_LOSS_RTOL if rm.cfg.moe is not None else LOSS_RTOL
    assert abs(float(tm.loss(batch)) - want_loss) <= tol * abs(want_loss)
    if rm.cfg.family in ("moe", "ssm"):
        return
    if rm.cfg.family == "audio":
        want, _ = _r_whisper_hidden(rm, params, jb)
    else:
        want = rm.apply(params, jb, remat=False)
    assert got.shape == want.shape
    assert _rel(got, want) <= HIDDEN_RTOL
