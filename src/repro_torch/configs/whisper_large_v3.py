"""Whisper-large-v3 backbone [arXiv:2212.04356]. Enc-dec, 32+32 layers,
learned absolute positions (no RoPE); conv frontend stubbed (input_specs
provides precomputed frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, encoder_layers=32,
    d_model=1280, num_heads=20, kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64, rope="abs", qkv_bias=True,
)
