"""Model registry: build models and count their parameters (the
counterparts of ``repro.models.model_zoo.build_model`` and
``param_count``)."""
from __future__ import annotations

from torch import nn

from repro_torch.models.transformer import DecoderModel


def build_model(cfg, tp: int = 16, device=None):
    """The model of ``cfg`` on ``device`` (None = the card, raising when
    there is none; ``"meta"`` allocates nothing). Only the dense decoder is
    ported; every other family raises ``NotImplementedError``."""
    return DecoderModel(cfg, tp=tp, device=device)


def param_count(params) -> int:
    """Number of parameters of a model or of a nested dict of tensors."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(params.numel())
