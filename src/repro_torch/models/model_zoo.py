"""Model registry: build models, count their parameters and FLOPs (the
counterparts of ``repro.models.model_zoo``'s ``build_model``,
``param_count``, ``active_param_count`` and ``model_flops``; its dry-run
``input_specs`` belongs to the multi-device slice)."""
from __future__ import annotations

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
