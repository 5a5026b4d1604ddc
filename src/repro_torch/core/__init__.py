"""repro_torch.core — the round math of Algorithm 1 on torch tensors."""
