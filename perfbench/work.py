"""The yardstick's counts of work: bytes and flops from shapes alone.

``kernel_work`` is a frozen copy of the port's per-kernel formulas
(``repro_torch/kernels/work.py`` as of the benchmark's first version):
each input read once, each output written once, at the flags the main
path uses. ``round_min_bytes`` is the least traffic one round of
Algorithm 1 needs however it is implemented, and ``lm_step_flops`` the
model flops of one training step of a dense decoder. The program may
change its own counts; these stay as they are.

>>> kernel_work("round_stats", 64, 10_000)
(5161024, 7680000)
>>> kernel_work("round_update", 64, 10_000, nnz=192)
(12802564, 8960000)
>>> round_min_bytes(64, 10_000)
10240000
"""
from __future__ import annotations

__all__ = ["kernel_work", "KERNEL_OF", "round_min_bytes", "lm_step_flops",
           "lm_matmul_params"]

# the hand-written round kernels' names in a device trace, and the count
# each one's launch is held to
KERNEL_OF = {
    "stats_kernel": "round_stats",
    "update_sparse_kernel": "round_update_sparse",
    "update_dense_kernel": "round_update",
    "dual_kernel": "dual_step",
}


def kernel_work(name: str, m: int, n: int, nnz: int | None = None,
                seeds: int = 1) -> tuple[int, int]:
    """(bytes, flops) of one launch. ``round_update`` mixes with a dense
    (m, m) A unless ``nnz`` is given (its CSR form: m + 1 + 2 nnz words, 2
    nnz n flops); ``seeds`` > 1 is a batched launch, every per-seed array
    S times and the mix once; ``pdomd_update`` takes (rows, 128) as (m, n),
    ``hinge_grad`` (B, n), ``dual_step`` its (m, n) rows."""
    mn, S = m * n, seeds
    if name == "round_stats":
        return S * 4 * (2 * mn + 4 * m + n), S * 12 * mn
    if name.startswith("round_update"):
        a_words, mix_flops = ((m * m, 2 * m * m * n) if nnz is None
                              else (m + 1 + 2 * nnz, 2 * nnz * n))
        return (4 * (a_words + m + S * (3 * mn + 2 * m + 2 * mn)),
                S * (mix_flops + 8 * mn))
    if name == "pdomd_update":
        return 4 * 6 * mn, 10 * mn
    if name == "hinge_grad":
        return 4 * (mn + 3 * m + 2 * n), 4 * mn
    if name == "dual_step":
        return 4 * (3 * mn + 2 * m + mn), 3 * mn
    raise ValueError(f"no work count for kernel {name!r}")


def round_min_bytes(m: int, n: int) -> int:
    """The least bytes one round of Algorithm 1 moves in float32: each
    node's sample read once, its dual read and written once, and its noisy
    broadcast counted once."""
    return 4 * m * n * 4


def lm_matmul_params(d_model: int, n_layers: int, n_heads: int,
                     n_kv_heads: int, head_dim: int, d_ff: int,
                     vocab: int, gated: bool = True) -> int:
    """Parameters that enter a matrix product in one token's forward pass
    of a dense decoder: q, k, v and o, the (gated) MLP, and the output
    head (the embedding lookup is no product)."""
    attn = d_model * head_dim * (2 * n_heads + 2 * n_kv_heads)
    mlp = (3 if gated else 2) * d_model * d_ff
    return n_layers * (attn + mlp) + vocab * d_model


def lm_step_flops(tokens: int, seq_len: int, d_model: int, n_layers: int,
                  n_heads: int, n_kv_heads: int, head_dim: int, d_ff: int,
                  vocab: int, gated: bool = True) -> float:
    """Model flops of one training step (forward and backward) over
    ``tokens`` tokens in sequences of ``seq_len``: 6 per matrix-product
    parameter per token, plus 12 L d T per token for attention's scores
    and values (full, not causal-halved)."""
    p = lm_matmul_params(d_model, n_layers, n_heads, n_kv_heads, head_dim,
                         d_ff, vocab, gated)
    attn = 12 * n_layers * n_heads * head_dim * seq_len
    return float(tokens) * (6 * p + attn)
