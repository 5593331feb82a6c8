from repro_torch.models.model_zoo import (  # noqa: F401
    active_param_count,
    build_model,
    input_specs,
    model_flops,
    param_count,
)
