"""Decoder-only stacks: dense / vlm / moe / hybrid (Jamba) / ssm (xLSTM), the
counterpart of ``repro.models.transformer.DecoderModel``.

The model is an ``nn.Module`` that owns its parameters, laid out as the
reference's parameter tree: ``embed`` [V, d], ``final_norm`` [d], and per
family

* dense, vlm, moe: ``ln1``/``ln2`` [L, d], ``attn.{wq,wk,wv}`` [L, d, H,
  hd], ``attn.wo`` [L, H, hd, d], ``attn.{bq,bk,bv}`` [L, H, hd] (QKV
  bias), ``mlp.{w1,w3}`` [L, d, ff], ``mlp.w2`` [L, ff, d] (when d_ff),
  ``moe.gate`` [L, d, E], ``moe.{w1,w3}`` [L, E, d, ff_e], ``moe.w2``
  (when MoE; with both, Arctic's dense residual branch);
* hybrid: ``groups`` with ``ln1``/``ln2`` [G, per, d], ``attn`` [G, ...],
  ``mamba`` [G (per - 1), ...], ``mlp`` and ``moe`` [G per/2, ...] (one
  attention layer at j == 0 of each group of ``attn_every``, Mamba at the
  others; MoE at odd j, the MLP at even j);
* ssm: ``blocks.mlstm`` and ``blocks.slstm`` stacked over their layers;

head counts padded by the TP head plan. A reference tree carries across
leaf for leaf (:func:`repro_torch.interop.load_params`). Master parameters
are f32 and are cast to the activation dtype at use; layers run as a
Python loop over the stacked layer axis (the reference's ``scan``).

Where the reference is functional (``apply(params, batch)``), the port's
serving methods read the module's own parameters, which take no gradients
and build no graph: ``apply(batch)``, ``loss(batch)``,
``decode_step(cache, tokens)`` (or a placed tree of them,
``decode_step(cache, tokens, params)``: the reference's decode step as its
``lower_decode`` shards it). The cache is updated in place. Training
passes a parameter tree of its own, ``loss(batch, params, remat=True)``
(the reference's ``loss(params, batch, remat=True)``): the loss is then
differentiable in those tensors, and with ``remat`` each layer (each group
of the hybrid) is recomputed in the backward (``torch.utils.checkpoint``,
the counterpart of the reference's ``jax.checkpoint``). The VLM takes
``embeds`` [B, S, d] (its stubbed frontend) and M-RoPE ``positions``
[3, B, S]; a token batch without positions gets the three streams equal to
the token index (text only). Whisper is
:class:`repro_torch.models.whisper.EncDecModel`.

Under a mesh a training parameter tree and batch may be DTensors
(:mod:`repro_torch.sharding.place`): the residual stream is pinned to
("batch", -, -) after the embedding and after every block (each hybrid
layer), as in the reference, and after every mixer (attention, Mamba;
each xLSTM block), where XLA makes the partial sums whole before the
next norm: DTensor would carry them into the norm and the next products;
the positions are placed with the rows.
A block's parameters are gathered over the batch axes inside it
(:func:`repro_torch.sharding.ctx.gather_batch`, FSDP's all-gather), as
is the table for the unembedding: DTensor, left to choose, would rather
gather the activations and all-reduce the products.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import head_plan, shard

PORTED_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm")


def param_specs(cfg, hq: int, hkv: int) -> dict:
    """The decoder's parameter tree: nested dicts of (shape, init) leaves,
    ``init`` a normal draw's standard deviation, ``("fill", v)`` or
    ``("A_log",)`` (the reference's initial values)."""
    d, Ln = cfg.d_model, cfg.num_layers
    tree = {"embed": ((cfg.vocab, d), 0.02),
            "final_norm": ((d,), ("fill", 1.0))}
    if cfg.family == "ssm":
        n_s = len(cfg.slstm_layers)
        tree["blocks"] = {"mlstm": X.mlstm_shapes(cfg, Ln - n_s),
                          "slstm": X.slstm_shapes(cfg, n_s)}
        return tree
    if cfg.family == "hybrid":
        per = cfg.attn_every
        G = _groups(cfg)
        n_moe = per // 2
        tree["groups"] = {
            "ln1": ((G, per, d), ("fill", 1.0)),
            "ln2": ((G, per, d), ("fill", 1.0)),
            "attn": L.attn_shapes(cfg, G, hq, hkv),
            "mamba": M.mamba_shapes(d, cfg.mamba, G * (per - 1)),
            "mlp": L.mlp_shapes(d, cfg.d_ff, G * (per - n_moe)),
            "moe": MOE.moe_shapes(d, cfg.moe, G * n_moe),
        }
        return tree
    tree["ln1"] = ((Ln, d), ("fill", 1.0))
    tree["ln2"] = ((Ln, d), ("fill", 1.0))
    tree["attn"] = L.attn_shapes(cfg, Ln, hq, hkv)
    if cfg.d_ff:
        tree["mlp"] = L.mlp_shapes(d, cfg.d_ff, Ln)
    if cfg.moe is not None:
        tree["moe"] = MOE.moe_shapes(d, cfg.moe, Ln)
    return tree


def _groups(cfg) -> int:
    """Groups of a hybrid stack (one attention layer each)."""
    assert cfg.num_layers % cfg.attn_every == 0
    return cfg.num_layers // cfg.attn_every


class ParamTree(nn.Module):
    """Parameters laid out as a nested dict: a leaf is an f32
    ``nn.Parameter`` that takes no gradient, a dict a child ``ParamTree``;
    ``tree[name]`` reads either. The ``state_dict`` names are the tree's
    dotted paths."""

    def __init__(self, specs: dict, device):
        super().__init__()
        self._specs = specs
        for name, spec in specs.items():
            if isinstance(spec, dict):
                self.add_module(name, ParamTree(spec, device))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(spec[0], dtype=torch.float32, device=device),
                    requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)

    def items(self):
        return [(k, self[k]) for k in self._specs]

    def param_tree(self) -> dict:
        """The parameters as nested dicts (the tensors themselves, not
        copies)."""
        return {k: v.param_tree() if isinstance(v, ParamTree) else v
                for k, v in self.items()}

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Random parameters from ``generator`` (on the parameters'
        device), leaf by leaf in tree order, with the reference's scales
        and constants. Returns the module."""
        for name, spec in self._specs.items():
            p = self[name]
            if isinstance(spec, dict):
                p.init(generator)
            elif not isinstance(spec[1], tuple):
                p.normal_(0.0, spec[1], generator=generator)
            elif spec[1][0] == "fill":
                p.fill_(spec[1][1])
            else:                                    # A_log: log(1..d_state)
                ds = p.shape[-1]
                p.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                               device=p.device)))
        return self


def unbind_layers(group: dict, n: int) -> list[dict]:
    """A dict of stacked leaves as ``n`` per-layer dicts. Each leaf is
    unbound once (its backward is one stack, not a full-size zero tensor a
    layer)."""
    per = {k: v.unbind(0) for k, v in group.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _as_tensor(x, device):
    """A batch leaf (numpy, a list or a tensor) as a tensor on ``device``;
    a DTensor (a placed batch) as it is."""
    if ctx.is_dtensor(x):
        return x
    return torch.as_tensor(x if torch.is_tensor(x) else np.array(x),
                           device=device)


class DecoderModel(ParamTree):
    """Decoder stack: init / apply / loss / init_cache / decode_step."""

    def __init__(self, cfg, tp: int = 16, device=None):
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"family {cfg.family!r} ({cfg.name}) is not a "
                             f"decoder family; one of {PORTED_FAMILIES}")
        hq, hkv, _ = head_plan(cfg.num_heads, cfg.kv_heads, tp)
        super().__init__(param_specs(cfg, hq, hkv),
                         resolve_device(device))      # "meta": no memory
        self.cfg = cfg
        self.hq, self.hkv = hq, hkv

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- shared blocks -------------------------------------------------------

    def _ffn(self, mlp, moe, h):
        cfg = self.cfg
        if moe:
            y = MOE.moe_ffn(moe, h, cfg.moe)
            if mlp and cfg.moe.dense_residual and cfg.d_ff:
                y = y + L.mlp(mlp, h)
            return y
        return L.mlp(mlp, h)

    def _block(self, x, pos, ln1, ln2, attn, mlp, moe):
        cfg = self.cfg
        attn, mlp = ctx.gather_batch(attn), ctx.gather_batch(mlp)
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        x = shard(x + L.attention_train(attn, h, cfg, pos), "batch", None,
                  None)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return shard(x + self._ffn(mlp, moe, h), "batch", None, None)

    def _group(self, x, pos, ln1, ln2, attn, mambas, mlps, moes):
        """One hybrid group: attention at j == 0, Mamba after; MoE at odd
        j, the MLP at even j."""
        cfg = self.cfg
        attn, mambas, mlps = (ctx.gather_batch(attn),
                              [ctx.gather_batch(m) for m in mambas],
                              [ctx.gather_batch(m) for m in mlps])
        for j in range(cfg.attn_every):
            h = L.rmsnorm(x, ln1[j], cfg.norm_eps)
            if j == 0:
                x = x + L.attention_train(attn, h, cfg, pos)
            else:
                x = x + M.mamba_train(mambas[j - 1], h, cfg.mamba)
            x = shard(x, "batch", None, None)
            h = L.rmsnorm(x, ln2[j], cfg.norm_eps)
            if j % 2 == 1:
                x = x + self._ffn({}, moes[j // 2], h)
            else:
                x = x + L.mlp(mlps[j // 2], h)
            x = shard(x, "batch", None, None)
        return x

    # -- forward (prefill / scoring / training) ------------------------------

    def _embed_inputs(self, embed, batch):
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        if "embeds" in batch:                        # the VLM's stub frontend
            x = _as_tensor(batch["embeds"], self.device).to(dt)
        else:
            tokens = _as_tensor(batch["tokens"], self.device).long()
            x = L.embed_lookup(embed, tokens).to(dt)
        B, S = x.shape[:2]
        if cfg.rope == "mrope" and "positions" in batch:
            pos = _as_tensor(batch["positions"], self.device).long()
        else:
            pos = torch.arange(S, device=self.device)[None].expand(B, S)
            if cfg.rope == "mrope":
                pos = pos[None].expand(3, B, S)
            if ctx.is_dtensor(x):
                pos = ctx.distribute(pos.contiguous(), *(
                    (None, "batch", None) if pos.ndim == 3
                    else ("batch", None)))
        return shard(x, "batch", None, None), pos

    def _hidden(self, params, batch, remat: bool):
        """Final hidden states [B,S,d] of ``params``; with ``remat`` each
        layer (each hybrid group) is recomputed in the backward."""
        cfg = self.cfg
        x, pos = self._embed_inputs(params["embed"], batch)

        def run(fn, *args):
            return (checkpoint(fn, *args, use_reentrant=False) if remat
                    else fn(*args))

        if cfg.family == "ssm":
            x = self._xlstm(params["blocks"], x)
        elif cfg.family == "hybrid":
            g = params["groups"]
            G, per = _groups(cfg), cfg.attn_every
            n_moe = per // 2
            ln1, ln2 = g["ln1"].unbind(0), g["ln2"].unbind(0)
            attn = unbind_layers(g["attn"], G)
            mamba = unbind_layers(g["mamba"], G * (per - 1))
            mlp = unbind_layers(g["mlp"], G * (per - n_moe))
            moe = unbind_layers(g["moe"], G * n_moe)
            for gi in range(G):
                x = run(self._group, x, pos, ln1[gi], ln2[gi], attn[gi],
                        mamba[gi * (per - 1):(gi + 1) * (per - 1)],
                        mlp[gi * (per - n_moe):(gi + 1) * (per - n_moe)],
                        moe[gi * n_moe:(gi + 1) * n_moe])
        else:
            Ln = cfg.num_layers
            ln1, ln2 = params["ln1"].unbind(0), params["ln2"].unbind(0)
            attn = unbind_layers(params["attn"], Ln)
            mlp = unbind_layers(params.get("mlp", {}), Ln)
            moe = unbind_layers(params.get("moe", {}), Ln)
            for l in range(Ln):
                x = run(self._block, x, pos, ln1[l], ln2[l], attn[l], mlp[l],
                        moe[l])
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)

    def _xlstm(self, blocks, x):
        cfg = self.cfg
        n_s = len(cfg.slstm_layers)
        mlstm = unbind_layers(blocks["mlstm"], cfg.num_layers - n_s)
        slstm = unbind_layers(blocks["slstm"], n_s)
        i_m = i_s = 0
        for l in range(cfg.num_layers):
            if l in cfg.slstm_layers:
                x = X.slstm_train(ctx.gather_batch(slstm[i_s]), x, cfg)
                i_s += 1
            else:
                x = X.mlstm_train(ctx.gather_batch(mlstm[i_m]), x, cfg)
                i_m += 1
            x = shard(x, "batch", None, None)
        return x

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
        logits = L.unembed(h, ctx.gather_batch(params["embed"]))
        labels = _as_tensor(batch["labels"], self.device)
        return L.softmax_xent(logits, labels)

    # -- serving -------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The zeroed decode state and its shared length (a host int):
        dense/vlm/moe: KV [L, B, max_len, Hkv, hd] in the activation dtype;
        hybrid: KV of the G attention layers, the Mamba layers' ``conv``
        [n, B, d_conv - 1, d_inner] (activation dtype) and ``ssm`` [n, B,
        d_inner, d_state] (f32); ssm: the mLSTM memories ``C`` [n_m, B, H,
        hd, hd] and ``n`` [n_m, B, H, hd], the sLSTM states ``c_s``/``h_s``
        [n_s, B, H, hd], all f32."""
        cfg = self.cfg
        dt = L.dtype_of(cfg)

        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        kv_len = (batch_size, max_len, self.hkv, cfg.head_dim)
        if cfg.family == "ssm":
            n_s = len(cfg.slstm_layers)
            n_m = cfg.num_layers - n_s
            H, hd = cfg.num_heads, cfg.head_dim
            f32 = torch.float32
            return {"C": zeros((n_m, batch_size, H, hd, hd), f32),
                    "n": zeros((n_m, batch_size, H, hd), f32),
                    "c_s": zeros((n_s, batch_size, H, hd), f32),
                    "h_s": zeros((n_s, batch_size, H, hd), f32), "len": 0}
        if cfg.family == "hybrid":
            G = _groups(cfg)
            di = cfg.mamba.expand * cfg.d_model
            n_mamba = G * (cfg.attn_every - 1)
            return {"k": zeros((G,) + kv_len), "v": zeros((G,) + kv_len),
                    "conv": zeros((n_mamba, batch_size, cfg.mamba.d_conv - 1,
                                   di)),
                    "ssm": zeros((n_mamba, batch_size, di,
                                  cfg.mamba.d_state), torch.float32),
                    "len": 0}
        Ln = cfg.num_layers
        return {"k": zeros((Ln,) + kv_len), "v": zeros((Ln,) + kv_len),
                "len": 0}

    @torch.no_grad()
    def decode_step(self, cache, tokens, params=None):
        """One decode step for all batch rows. tokens [B] -> (logits f32
        [B,V], cache); the cache is updated in place and returned.

        ``params`` None: the module's own parameters. Otherwise a
        parameter tree of the module's layout, under a mesh placed by
        ``tree_param_specs`` (:func:`repro_torch.sharding.place.
        place_params`) with the cache placed by ``cache_specs``
        (``place.place_cache``): the reference's ``decode_step`` as its
        ``lower_decode`` shards it. The step then runs under
        :func:`repro_torch.sharding.ctx.decode_rules` (B rows below the
        batch axes' size: the cache's sequence split over "data", the rows
        whole), the tokens placed by ``place.place_tokens`` unless given
        placed, each layer's parameters gathered over the batch axes
        (FSDP), and the logits come back a DTensor with the vocabulary over
        "model" where the table splits there."""
        cfg = self.cfg
        params = self.param_tree() if params is None else params
        tokens = _as_tensor(tokens, self.device).long()
        with ctx.decode_rules(tokens.shape[0]):
            if ctx.is_dtensor(params["embed"]) and not ctx.is_dtensor(tokens):
                tokens = ctx.distribute(tokens, "batch")
            x = L.embed_lookup(params["embed"], tokens)[:, None].to(
                L.dtype_of(cfg))                               # [B,1,d]
            x = shard(x, "batch", None, None)
            if cfg.family == "ssm":
                x = self._decode_xlstm(params["blocks"], cache, x)
            elif cfg.family == "hybrid":
                x = self._decode_hybrid(params["groups"], cache, x)
            else:
                x = self._decode_stack(params, cache, x)
            h = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
            logits = L.unembed(h, ctx.gather_batch(params["embed"]))[:, 0]
        cache["len"] += 1
        return logits.float(), cache

    def _attn_decode(self, attn, x, ln, cache, i):
        h = L.rmsnorm(x, ln, self.cfg.norm_eps)
        a, _, _ = L.attention_decode(attn, h, self.cfg, cache["k"][i],
                                     cache["v"][i], cache["len"])
        return shard(x + a, "batch", None, None)

    def _decode_stack(self, params, cache, x):
        cfg = self.cfg
        Ln = cfg.num_layers
        ln1, ln2 = params["ln1"].unbind(0), params["ln2"].unbind(0)
        attn = unbind_layers(params["attn"], Ln)
        mlp = unbind_layers(params.get("mlp", {}), Ln)
        moe = unbind_layers(params.get("moe", {}), Ln)
        for l in range(Ln):
            x = self._attn_decode(ctx.gather_batch(attn[l]), x, ln1[l],
                                  cache, l)
            h = L.rmsnorm(x, ln2[l], cfg.norm_eps)
            x = shard(x + self._ffn(ctx.gather_batch(mlp[l]), moe[l], h),
                      "batch", None, None)
        return x

    def _decode_hybrid(self, g, cache, x):
        cfg = self.cfg
        G, per = _groups(cfg), cfg.attn_every
        n_moe = per // 2
        attn = unbind_layers(g["attn"], G)
        mamba = unbind_layers(g["mamba"], G * (per - 1))
        mlp = unbind_layers(g["mlp"], G * (per - n_moe))
        moe = unbind_layers(g["moe"], G * n_moe)
        i_mamba = i_mlp = i_moe = 0
        for gi in range(G):
            ln1, ln2 = g["ln1"][gi], g["ln2"][gi]
            for j in range(per):
                if j == 0:
                    x = self._attn_decode(ctx.gather_batch(attn[gi]), x,
                                          ln1[j], cache, gi)
                else:
                    h = L.rmsnorm(x, ln1[j], cfg.norm_eps)
                    a, st = M.mamba_decode(
                        ctx.gather_batch(mamba[i_mamba]), h, cfg.mamba,
                        {"conv": cache["conv"][i_mamba],
                         "ssm": cache["ssm"][i_mamba]})
                    cache["conv"][i_mamba] = st["conv"]
                    cache["ssm"][i_mamba] = st["ssm"]
                    x = shard(x + a, "batch", None, None)
                    i_mamba += 1
                h = L.rmsnorm(x, ln2[j], cfg.norm_eps)
                if j % 2 == 1:
                    x = x + self._ffn({}, moe[i_moe], h)
                    i_moe += 1
                else:
                    x = x + L.mlp(ctx.gather_batch(mlp[i_mlp]), h)
                    i_mlp += 1
                x = shard(x, "batch", None, None)
        return x

    def _decode_xlstm(self, blocks, cache, x):
        cfg = self.cfg
        n_s = len(cfg.slstm_layers)
        mlstm = unbind_layers(blocks["mlstm"], cfg.num_layers - n_s)
        slstm = unbind_layers(blocks["slstm"], n_s)
        i_m = i_s = 0
        for l in range(cfg.num_layers):
            if l in cfg.slstm_layers:
                x, st = X.slstm_decode(ctx.gather_batch(slstm[i_s]), x, cfg,
                                       {"c": cache["c_s"][i_s],
                                        "h": cache["h_s"][i_s]})
                cache["c_s"][i_s] = st["c"]
                cache["h_s"][i_s] = st["h"]
                i_s += 1
            else:
                x, st = X.mlstm_decode(ctx.gather_batch(mlstm[i_m]), x, cfg,
                                       {"C": cache["C"][i_m],
                                        "n": cache["n"][i_m]})
                cache["C"][i_m] = st["C"]
                cache["n"][i_m] = st["n"]
                i_m += 1
            x = shard(x, "batch", None, None)
        return x
