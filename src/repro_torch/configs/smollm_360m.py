"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]. Llama-arch small."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64, rope_theta=1e4,
)
