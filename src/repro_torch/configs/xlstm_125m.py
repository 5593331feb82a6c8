"""xLSTM-125M [arXiv:2405.04517]. 10 mLSTM + 2 sLSTM blocks (layers 0, 6);
no external FFN (internal up-projection, factor 2)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, kv_heads=4,
    d_ff=0, vocab=50304, head_dim=192,
    slstm_layers=(0, 6),
)
