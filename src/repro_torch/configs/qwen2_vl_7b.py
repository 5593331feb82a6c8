"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf]. M-RoPE, dynamic resolution
(frontend stubbed: input_specs feeds precomputed patch/text embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    qkv_bias=True, rope="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)
