"""Decoder-only stack, dense family (the counterpart of
``repro.models.transformer.DecoderModel`` for ``family == "dense"``).

The model is an ``nn.Module`` that owns its parameters, laid out as the
reference's parameter tree (``embed`` [V, d], ``final_norm`` [d],
``ln1``/``ln2`` [L, d], ``attn.{wq,wk,wv}`` [L, d, H, hd], ``attn.wo``
[L, H, hd, d], ``attn.{bq,bk,bv}`` [L, H, hd], ``mlp.{w1,w3}`` [L, d, ff],
``mlp.w2`` [L, ff, d]; head counts padded by the TP head plan), so a
reference tree carries across leaf for leaf
(:func:`repro_torch.interop.load_params`). Master parameters are f32 and are
cast to the activation dtype at use; layers run as a Python loop over the
stacked layer axis.

Where the reference is functional (``apply(params, batch)``), the port's
serving methods read the module's own parameters, which take no gradients
and build no graph: ``apply(batch)``, ``loss(batch)``,
``decode_step(cache, tokens)``. The KV cache is updated in place. Training
passes a parameter tree of its own, ``loss(batch, params, remat=True)``
(the reference's ``loss(params, batch, remat=True)``): the loss is then
differentiable in those tensors, and with ``remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``, the counterpart of
the reference's ``jax.checkpoint`` per layer). The families ``moe``,
``vlm``, ``hybrid``, ``ssm`` and ``audio`` are not ported yet (ROADMAP
Queue 1) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding.ctx import head_plan

PORTED_FAMILIES = ("dense",)


def param_shapes(cfg, hq: int, hkv: int) -> dict:
    """The dense decoder's parameter tree as nested dicts of shapes."""
    d, hd, Ln = cfg.d_model, cfg.head_dim, cfg.num_layers
    attn = {"wq": (Ln, d, hq, hd), "wk": (Ln, d, hkv, hd),
            "wv": (Ln, d, hkv, hd), "wo": (Ln, hq, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(Ln, hq, hd), bk=(Ln, hkv, hd), bv=(Ln, hkv, hd))
    tree = {"embed": (cfg.vocab, d), "final_norm": (d,),
            "ln1": (Ln, d), "ln2": (Ln, d), "attn": attn}
    if cfg.d_ff:
        tree["mlp"] = {"w1": (Ln, d, cfg.d_ff), "w3": (Ln, d, cfg.d_ff),
                       "w2": (Ln, cfg.d_ff, d)}
    return tree


def _parameter(shape, device):
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class DecoderModel(nn.Module):
    """Dense decoder: init / apply / loss / init_cache / decode_step."""

    def __init__(self, cfg, tp: int = 16, device=None):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported to "
                f"repro_torch yet: the MoE, VLM, hybrid, xLSTM and Whisper "
                f"families come with a later slice (ROADMAP Queue 1); "
                f"ported: {PORTED_FAMILIES}")
        self.cfg = cfg
        self.hq, self.hkv, _ = head_plan(cfg.num_heads, cfg.kv_heads, tp)
        dev = resolve_device(device)       # "meta" allocates nothing
        shapes = param_shapes(cfg, self.hq, self.hkv)
        for name in ("embed", "final_norm", "ln1", "ln2"):
            setattr(self, name, _parameter(shapes[name], dev))
        self.attn = nn.ParameterDict(
            {k: _parameter(s, dev) for k, s in shapes["attn"].items()})
        self.mlp = nn.ParameterDict(
            {k: _parameter(s, dev) for k, s in shapes.get("mlp", {}).items()})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params ------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Random parameters from ``generator`` (on the model's device), with
        the reference's scales: embed N(0, 0.02^2); q/k/v and w1/w3 scaled
        by d^-0.5, wo by (H hd)^-0.5, w2 by ff^-0.5; norms 1, biases 0.
        Returns the model."""
        cfg = self.cfg
        d = cfg.d_model
        self.embed.normal_(0.0, 0.02, generator=generator)
        for name in ("final_norm", "ln1", "ln2"):
            getattr(self, name).fill_(1.0)
        scales = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
                  "wo": (self.hq * cfg.head_dim) ** -0.5,
                  "w1": d ** -0.5, "w3": d ** -0.5,
                  "w2": (cfg.d_ff or 1) ** -0.5}
        for group in (self.attn, self.mlp):
            for name, p in group.items():
                if name in ("bq", "bk", "bv"):
                    p.zero_()
                else:
                    p.normal_(0.0, scales[name], generator=generator)
        return self

    def param_tree(self) -> dict:
        """The module's parameters as the reference's nested dict (the
        tensors themselves, not copies)."""
        tree = {"embed": self.embed, "final_norm": self.final_norm,
                "ln1": self.ln1, "ln2": self.ln2, "attn": dict(self.attn)}
        if len(self.mlp):
            tree["mlp"] = dict(self.mlp)
        return tree

    def _layer(self, l: int):
        return ({k: v[l] for k, v in self.attn.items()},
                {k: v[l] for k, v in self.mlp.items()})

    # -- forward (prefill / scoring / training) ------------------------------

    def _embed_inputs(self, embed, batch):
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = embed[tokens].to(L.dtype_of(self.cfg))
        B, S = tokens.shape
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        return x, pos

    def _block(self, x, pos, ln1, ln2, attn, mlp):
        cfg = self.cfg
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        x = x + L.attention_train(attn, h, cfg, pos)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return x + L.mlp(mlp, h)

    def _hidden(self, params, batch, remat: bool):
        """Final hidden states [B,S,d] of ``params``. The stacked leaves are
        unbound once (their backward is one stack, not a full-size zero
        tensor a layer); with ``remat`` each layer is recomputed in the
        backward."""
        cfg = self.cfg
        x, pos = self._embed_inputs(params["embed"], batch)
        Ln = cfg.num_layers

        def layers(group):
            per = {k: v.unbind(0) for k, v in group.items()}
            return [{k: v[l] for k, v in per.items()} for l in range(Ln)]

        ln1, ln2 = params["ln1"].unbind(0), params["ln2"].unbind(0)
        attn, mlp = layers(params["attn"]), layers(params.get("mlp", {}))
        for l in range(Ln):
            args = (x, pos, ln1[l], ln2[l], attn[l], mlp[l])
            x = (checkpoint(self._block, *args, use_reentrant=False)
                 if remat else self._block(*args))
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)

    def apply(self, batch):
        """The reference's name for the forward (it shadows
        ``nn.Module.apply``, which this model does not use)."""
        return self(batch)

    @torch.no_grad()
    def forward(self, batch):
        """Full-sequence forward -> final hidden states [B,S,d]."""
        return self._hidden(self.param_tree(), batch, remat=False)

    def loss(self, batch, params=None, remat: bool = True):
        """Mean next-token cross-entropy (f32) over the batch's labels.

        ``params`` None: the module's own parameters, with no graph (the
        serving and scoring loss; ``remat`` does not apply). Otherwise a
        parameter tree of the module's layout, in any float dtype (bf16
        live parameters under mixed precision): the loss is
        differentiable in its tensors."""
        if params is None:
            with torch.no_grad():
                return self._loss(self.param_tree(), batch, remat=False)
        return self._loss(params, batch, remat)

    def _loss(self, params, batch, remat: bool):
        h = self._hidden(params, batch, remat)
        logits = L.unembed(h, params["embed"])
        labels = torch.as_tensor(batch["labels"], device=self.device)
        return L.softmax_xent(logits, labels)

    # -- serving -------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """Zeroed KV cache [L, B, max_len, Hkv, hd] in the activation dtype,
        and its shared length (a host int)."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch_size, max_len, self.hkv, cfg.head_dim)
        dt = L.dtype_of(cfg)
        return {"k": torch.zeros(kv, dtype=dt, device=self.device),
                "v": torch.zeros(kv, dtype=dt, device=self.device),
                "len": 0}

    @torch.no_grad()
    def decode_step(self, cache, tokens):
        """One decode step for all batch rows. tokens [B] -> (logits f32
        [B,V], cache); the cache is updated in place and returned."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = self.embed[tokens][:, None].to(L.dtype_of(cfg))     # [B,1,d]
        B = x.shape[0]
        pos = torch.full((B,), cache["len"], device=self.device)
        for l in range(cfg.num_layers):
            attn, mlp = self._layer(l)
            h = L.rmsnorm(x, self.ln1[l], cfg.norm_eps)
            a, _, _ = L.attention_decode(attn, h, cfg, pos, cache["k"][l],
                                         cache["v"][l], cache["len"])
            x = x + a
            h = L.rmsnorm(x, self.ln2[l], cfg.norm_eps)
            x = x + L.mlp(mlp, h)
        h = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        logits = L.unembed(h, self.embed)[:, 0]
        cache["len"] += 1
        return logits.float(), cache
