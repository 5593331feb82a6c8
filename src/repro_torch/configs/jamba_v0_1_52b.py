"""Jamba-v0.1 52B [arXiv:2403.19887]. 32 layers = 4 groups of
(1 attention + 7 mamba), 16-expert top-2 MoE every other layer."""
from repro_torch.configs.base import ModelConfig, MambaConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128, rope_theta=1e4,
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
)
