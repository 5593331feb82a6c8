"""Whisper-style encoder-decoder backbone, conv frontend stubbed (the
counterpart of ``repro.models.whisper``).

Encoder: bidirectional self-attention over precomputed frame embeddings
(``enc_embeds``) plus learned positions, through the flash kernel with
``causal=False``. Decoder: causal self-attention through the kernel, then
cross-attention to the encoder output, which is plain torch
(:func:`repro_torch.models.layers.gqa_scores_out`: its queries and keys
differ in length, and it is jnp in the reference); learned absolute
positions, no RoPE.

Serving: ``prefill`` encodes the audio and caches every decoder layer's
cross-attention K/V once; ``decode_step`` then updates only the
self-attention cache. Its ``init_cache(batch_size, max_len, enc_len)``
takes the encoder's length, which the continuous batcher's
``init_cache(batch_size, max_len)`` does not give: as in the reference,
Whisper is not served by the batcher or the serve CLI.

The module owns f32 master parameters in the reference's tree (``embed``,
``enc_pos``/``dec_pos`` [MAX_POS, d], ``final_norm``, ``enc_final_norm``,
``enc.{ln1,ln2,attn,mlp}``, ``dec.{ln1,ln2,ln3,attn,xattn,mlp}``), cast to
the activation dtype at use, as :class:`DecoderModel` does.

Under a mesh the residual streams are pinned to ("batch", -, -) after the
positions are added and after every block, as in the reference (and after
every attention, where XLA makes the partial sums whole), and the
cross-attention runs on local (rows, heads over "model") shards, as the
self-attention does (:func:`repro_torch.models.layers.cross_attention`);
each block gathers its parameters over the batch axes
(:func:`repro_torch.sharding.ctx.gather_batch`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import (ParamTree, _as_tensor,
                                            unbind_layers)
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import head_plan, shard

MAX_POS = 40960     # learned positions: covers the 32k shapes


def param_specs(cfg, hq: int, hkv: int) -> dict:
    """The encoder-decoder's parameter tree of (shape, init) leaves."""
    d, Le, Ld = cfg.d_model, cfg.encoder_layers, cfg.num_layers
    one = ("fill", 1.0)
    return {
        "embed": ((cfg.vocab, d), 0.02),
        "enc_pos": ((MAX_POS, d), 0.02),
        "dec_pos": ((MAX_POS, d), 0.02),
        "final_norm": ((d,), one),
        "enc_final_norm": ((d,), one),
        "enc": {"ln1": ((Le, d), one), "ln2": ((Le, d), one),
                "attn": L.attn_shapes(cfg, Le, hq, hkv),
                "mlp": L.mlp_shapes(d, cfg.d_ff, Le)},
        "dec": {"ln1": ((Ld, d), one), "ln2": ((Ld, d), one),
                "ln3": ((Ld, d), one),
                "attn": L.attn_shapes(cfg, Ld, hq, hkv),
                "xattn": L.attn_shapes(cfg, Ld, hq, hkv),
                "mlp": L.mlp_shapes(d, cfg.d_ff, Ld)},
    }


class EncDecModel(ParamTree):
    """Encoder-decoder: init / encode / apply / loss / init_cache / prefill
    / decode_step."""

    def __init__(self, cfg, tp: int = 16, device=None):
        hq, hkv, _ = head_plan(cfg.num_heads, cfg.kv_heads, tp)
        super().__init__(param_specs(cfg, hq, hkv), resolve_device(device))
        self.cfg = cfg
        self.hq, self.hkv = hq, hkv

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _run(self, fn, remat, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))

    # -- encoder -------------------------------------------------------------

    def _enc_block(self, x, ln1, ln2, attn, mlp):
        cfg = self.cfg
        attn, mlp = ctx.gather_batch(attn), ctx.gather_batch(mlp)
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        x = shard(x + L.attention_train(attn, h, cfg, pos=None,
                                        causal=False), "batch", None, None)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        return shard(x + L.mlp(mlp, h), "batch", None, None)

    def _encode(self, params, enc_embeds, remat: bool):
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        x = _as_tensor(enc_embeds, self.device).to(dt)
        x = shard(x + params["enc_pos"][:x.shape[1]].to(dt), "batch", None,
                  None)
        e, Le = params["enc"], cfg.encoder_layers
        ln1, ln2 = e["ln1"].unbind(0), e["ln2"].unbind(0)
        attn, mlp = unbind_layers(e["attn"], Le), unbind_layers(e["mlp"], Le)
        for l in range(Le):
            x = self._run(self._enc_block, remat, x, ln1[l], ln2[l], attn[l],
                          mlp[l])
        return L.rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)

    @torch.no_grad()
    def encode(self, enc_embeds):
        """Encoder output [B, Se, d] of the module's parameters."""
        return self._encode(self.param_tree(), enc_embeds, remat=False)

    def _cross_kv(self, params, enc_out):
        """Every decoder layer's cross-attention K/V from the encoder
        output: two [Ld, B, Se, H, hd] tensors."""
        cfg = self.cfg
        dt = enc_out.dtype
        xa = unbind_layers({k: v for k, v in params["dec"]["xattn"].items()
                            if k in ("wk", "wv", "bk", "bv")},
                           cfg.num_layers)
        ks, vs = [], []
        for p in map(ctx.gather_batch, xa):
            k = L._proj(enc_out, p["wk"].to(dt))
            v = L._proj(enc_out, p["wv"].to(dt))
            if cfg.qkv_bias:
                k = k + p["bk"].to(dt)
                v = v + p["bv"].to(dt)
            ks.append(k)
            vs.append(v)
        return torch.stack(ks), torch.stack(vs)

    # -- decoder -------------------------------------------------------------

    def _cross(self, xattn, h, xk, xv):
        """Cross-attention of decoder states h over the cached K/V."""
        return L.cross_attention(xattn, h, self.cfg, xk, xv)

    def _dec_block(self, x, xk, xv, ln1, ln2, ln3, attn, xattn, mlp):
        cfg = self.cfg
        attn, xattn, mlp = (ctx.gather_batch(attn), ctx.gather_batch(xattn),
                            ctx.gather_batch(mlp))
        h = L.rmsnorm(x, ln1, cfg.norm_eps)
        x = shard(x + L.attention_train(attn, h, cfg, pos=None, causal=True),
                  "batch", None, None)
        h = L.rmsnorm(x, ln2, cfg.norm_eps)
        x = shard(x + self._cross(xattn, h, xk, xv), "batch", None, None)
        h = L.rmsnorm(x, ln3, cfg.norm_eps)
        return shard(x + L.mlp(mlp, h), "batch", None, None)

    def _hidden(self, params, batch, remat: bool):
        """The decoder's final hidden states [B, S, d], teacher-forced on
        ``dec_tokens`` over the encoded ``enc_embeds``."""
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        enc_out = self._encode(params, batch["enc_embeds"], remat)
        xk, xv = self._cross_kv(params, enc_out)
        tok = _as_tensor(batch["dec_tokens"], self.device).long()
        x = shard(L.embed_lookup(params["embed"], tok).to(dt)
                  + params["dec_pos"][:tok.shape[1]].to(dt), "batch", None,
                  None)
        dec, Ld = params["dec"], cfg.num_layers
        norms = [dec[k].unbind(0) for k in ("ln1", "ln2", "ln3")]
        blocks = [unbind_layers(dec[k], Ld) for k in ("attn", "xattn", "mlp")]
        # per layer by unbind: the backward stacks the layers' gradients
        # once (indexing would sum a zero-padded full-size one a layer)
        xks, xvs = xk.unbind(0), xv.unbind(0)
        for l in range(Ld):
            x = self._run(self._dec_block, remat, x, xks[l], xvs[l],
                          *(n[l] for n in norms), *(b[l] for b in blocks))
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)

    def apply(self, batch):
        """The decoder's final hidden states (the teacher-forced forward
        under the reference's loss)."""
        return self(batch)

    @torch.no_grad()
    def forward(self, batch):
        return self._hidden(self.param_tree(), batch, remat=False)

    def loss(self, batch, params=None, remat: bool = True):
        """Mean next-token cross-entropy (f32) of the decoder; ``params``
        as in :meth:`DecoderModel.loss`."""
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

    def init_cache(self, batch_size: int, max_len: int, enc_len: int):
        """Zeroed self-attention KV [Ld, B, max_len, Hkv, hd] and
        cross-attention KV [Ld, B, enc_len, Hkv, hd] in the activation
        dtype, and the shared length (a host int)."""
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        Ld = cfg.num_layers
        kv = (Ld, batch_size, max_len, self.hkv, cfg.head_dim)
        xkv = (Ld, batch_size, enc_len, self.hkv, cfg.head_dim)

        def zeros(shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        return {"k": zeros(kv), "v": zeros(kv), "xk": zeros(xkv),
                "xv": zeros(xkv), "len": 0}

    @torch.no_grad()
    def prefill(self, cache, enc_embeds):
        """Encode the audio and fill the cross-attention caches."""
        xk, xv = self._cross_kv(self.param_tree(), self.encode(enc_embeds))
        cache["xk"], cache["xv"] = xk, xv
        return cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, params=None):
        """One decode step for all batch rows. tokens [B] -> (logits f32
        [B,V], cache); the self-attention cache is updated in place.
        ``params``: as :meth:`DecoderModel.decode_step` (placed, with the
        cache placed by ``cache_specs``: the cross-attention's ``xk``/``xv``
        by the self-attention cache's spec, so with fewer rows than the
        batch axes' size their frames split over "data" and the
        cross-attention combines across it too)."""
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        params = self.param_tree() if params is None else params
        tokens = _as_tensor(tokens, self.device).long()
        n = cache["len"]
        with ctx.decode_rules(tokens.shape[0]):
            if ctx.is_dtensor(params["embed"]) and not ctx.is_dtensor(tokens):
                tokens = ctx.distribute(tokens, "batch")
            x = shard(L.embed_lookup(params["embed"], tokens)[:, None].to(dt)
                      + params["dec_pos"][min(n, MAX_POS - 1)].to(dt),
                      "batch", None, None)
            dec, Ld = params["dec"], cfg.num_layers
            norms = [dec[k].unbind(0) for k in ("ln1", "ln2", "ln3")]
            attn = unbind_layers(dec["attn"], Ld)
            xattn = unbind_layers(dec["xattn"], Ld)
            mlp = unbind_layers(dec["mlp"], Ld)
            for l in range(Ld):
                h = L.rmsnorm(x, norms[0][l], cfg.norm_eps)
                a, _, _ = L.attention_decode(
                    ctx.gather_batch(attn[l]), h, cfg, cache["k"][l],
                    cache["v"][l], n)
                x = shard(x + a, "batch", None, None)
                h = L.rmsnorm(x, norms[1][l], cfg.norm_eps)
                x = shard(x + L.cross_attention_decode(
                    ctx.gather_batch(xattn[l]), h, cfg, cache["xk"][l],
                    cache["xv"][l]), "batch", None, None)
                h = L.rmsnorm(x, norms[2][l], cfg.norm_eps)
                x = shard(x + L.mlp(ctx.gather_batch(mlp[l]), h), "batch",
                          None, None)
            x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
            logits = L.unembed(x, ctx.gather_batch(params["embed"]))[:, 0]
        cache["len"] += 1
        return logits.float(), cache
