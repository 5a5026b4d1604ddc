"""repro_torch.core — the round math of Algorithm 1 on torch tensors, the
simulator (`algorithm1`) and the distributed strategy (`gossip`)."""
