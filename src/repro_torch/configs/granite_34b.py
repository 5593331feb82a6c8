"""Granite-34B-Code [arXiv:2405.04324; hf]. Deep llama-arch, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128, rope_theta=1e4,
)
