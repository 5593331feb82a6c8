"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].
Dense-MoE hybrid: 128-expert top-2 MoE + dense residual FFN every layer."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128, rope_theta=1e4,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  every=1, dense_residual=True),
)
