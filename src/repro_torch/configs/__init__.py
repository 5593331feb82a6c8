"""Architecture registry: --arch <id> resolves here (copies of
``repro.configs``: the same ten architectures and shapes)."""
from repro_torch.configs import (
    arctic_480b,
    granite_34b,
    granite_moe_1b_a400m,
    jamba_v0_1_52b,
    qwen1_5_0_5b,
    qwen2_5_3b,
    qwen2_vl_7b,
    smollm_360m,
    whisper_large_v3,
    xlstm_125m,
)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    SHAPES,
    ShapeConfig,
    reduced,
    shape_applicable,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_vl_7b, smollm_360m, qwen1_5_0_5b, granite_34b, qwen2_5_3b,
        arctic_480b, granite_moe_1b_a400m, whisper_large_v3, xlstm_125m,
        jamba_v0_1_52b,
    )
}
