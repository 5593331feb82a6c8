from repro_torch.serve.batching import ContinuousBatcher, Request  # noqa: F401
