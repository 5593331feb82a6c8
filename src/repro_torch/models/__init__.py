from repro_torch.models.model_zoo import build_model, param_count  # noqa: F401
