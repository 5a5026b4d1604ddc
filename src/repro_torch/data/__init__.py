"""repro_torch.data — the social stream."""
