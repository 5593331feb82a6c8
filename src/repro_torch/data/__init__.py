from repro_torch.data.synthetic import SyntheticTokens, make_batch_iter  # noqa: F401
