from repro_torch.sharding.ctx import head_plan  # noqa: F401
