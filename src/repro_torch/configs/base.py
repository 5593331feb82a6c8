"""Model / shape configuration system (a copy of ``repro.configs.base``:
framework-free data, copied rather than imported).

One ``ModelConfig`` per assigned architecture lives in
``src/repro_torch/configs/<arch>.py``; the registry in ``__init__`` resolves
``--arch <id>``. ``reduced()`` produces the CPU-smoke-test variant of any
config (same family/topology, tiny widths).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1              # MoE layer every `every` layers (else dense)
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    dispatch: str = "global"    # global | sharded (hierarchical, see moe.py)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | vlm | moe | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope: str = "std"           # std | mrope
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    # hybrid (jamba): layers per group and attention position within group
    attn_every: int = 0         # 0 = all layers attention; k = 1 attn per k
    # xlstm: indices of sLSTM blocks (others are mLSTM)
    slstm_layers: tuple[int, ...] = ()
    # whisper: encoder layers (decoder = num_layers)
    encoder_layers: int = 0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run the 500k-token long-context decode shape?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True             # no encoder-only archs in the assignment


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    L = min(cfg.num_layers, 4)
    slstm = tuple(i for i in cfg.slstm_layers if i < L) or (
        (0,) if cfg.slstm_layers else ())
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
                                  top_k=min(cfg.moe.top_k, 2), d_ff_expert=64)
    mamba = None
    if cfg.mamba is not None:
        mamba = dataclasses.replace(cfg.mamba, d_state=8, chunk=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=L,
        d_model=64,
        num_heads=4,
        kv_heads=min(cfg.kv_heads, 2) if cfg.kv_heads < cfg.num_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        head_dim=16,
        mrope_sections=(2, 3, 3),
        moe=moe,
        mamba=mamba,
        slstm_layers=slstm,
        encoder_layers=min(cfg.encoder_layers, 2),
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        dtype="float32",
    )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                   # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) — DESIGN.md §5 skip rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: 500k-token B=1 decode "
                       "requires sub-quadratic attention (skip per spec)")
    return True, ""
