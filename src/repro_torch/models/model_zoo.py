"""Model registry: build models, count their parameters and FLOPs, make
dry-run inputs (the counterparts of ``repro.models.model_zoo``'s
``build_model``, ``param_count``, ``active_param_count``, ``model_flops``
and ``input_specs``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.transformer import DecoderModel
from repro_torch.models.whisper import EncDecModel


def build_model(cfg, tp: int = 16, device=None):
    """The model of ``cfg`` on ``device`` (None = the card, raising when
    there is none; ``"meta"`` allocates nothing): the encoder-decoder for
    ``family == "audio"``, the decoder stack for every other family."""
    if cfg.family == "audio":
        return EncDecModel(cfg, tp=tp, device=device)
    return DecoderModel(cfg, tp=tp, device=device)


def _tree(params):
    return params.param_tree() if isinstance(params, nn.Module) else params


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, k)
    else:
        yield prefix, tree


def param_count(params) -> int:
    """Number of parameters of a model or of a nested dict of tensors."""
    return sum(int(x.numel()) for _, x in _walk(_tree(params)))


def active_param_count(cfg, params) -> int:
    """Active parameters per token: of the expert tensors ``w1``/``w2``/
    ``w3`` ([..., E, d, ff]), the fraction top_k / num_experts."""
    total = param_count(params)
    if cfg.moe is None:
        return total
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    exp = 0
    for key, x in _walk(_tree(params)):
        if x.dim() >= 4 and x.shape[-3] == e and key in ("w1", "w2", "w3"):
            exp += int(x.numel())
    return total - exp + int(exp * k / e)


def model_flops(cfg, params, shape) -> float:
    """MODEL_FLOPS for the roofline ratio: 6 N D (train) / 2 N D
    (forward), with N the active parameters and D the tokens processed
    (one a sequence for decode)."""
    n_active = active_param_count(cfg, params)
    if shape.kind == "train":
        return 6.0 * n_active * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.batch * shape.seq
    return 2.0 * n_active * shape.batch


def input_specs(cfg, shape, model=None) -> dict:
    """Stand-ins for every model input on the meta device (no memory): the
    reference's ``ShapeDtypeStruct`` tree as meta tensors of the same
    shapes and dtypes. Train and prefill: the family's batch (VLM: bf16
    ``embeds`` [B,S,d] and int32 M-RoPE ``positions`` [3,B,S]; audio: bf16
    ``enc_embeds`` [B,S,d] and int32 ``dec_tokens``; the others int32
    ``tokens``; all int32 ``labels`` [B,S]). Decode: int32 ``tokens`` [B]
    and ``model.init_cache(B, S)`` (audio: ``enc_len=S``) of a ``model``
    built on the meta device; its ``len`` is the port's host int."""
    B, S = shape.batch, shape.seq

    def st(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            return {"embeds": st((B, S, cfg.d_model), bf16),
                    "positions": st((3, B, S), i32),
                    "labels": st((B, S), i32)}
        if cfg.family == "audio":
            return {"enc_embeds": st((B, S, cfg.d_model), bf16),
                    "dec_tokens": st((B, S), i32),
                    "labels": st((B, S), i32)}
        return {"tokens": st((B, S), i32), "labels": st((B, S), i32)}
    if model is None or model.device.type != "meta":
        raise ValueError("a decode shape's inputs need the model, built on "
                         "the meta device, for its cache")
    if cfg.family == "audio":
        cache = model.init_cache(B, S, enc_len=S)
    else:
        cache = model.init_cache(B, S)
    return {"tokens": st((B,), i32), "cache": cache}
