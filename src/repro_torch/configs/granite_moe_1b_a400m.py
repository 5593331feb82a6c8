"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].
32-expert top-8 MoE every layer, no dense FFN."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, kv_heads=8,
    d_ff=0, vocab=49155, head_dim=64, rope_theta=1e4,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512, every=1),
)
