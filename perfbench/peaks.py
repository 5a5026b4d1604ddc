"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity), at its full power limit of 700 W. A card set to a
lower limit runs slower under load: the harness reports the card's limit
beside every result."""

BF16_FLOPS = 989e12       # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12  # B/s
